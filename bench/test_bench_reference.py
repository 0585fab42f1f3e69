"""The plain reference against the port's CPU path: the stop cycle and the
answer of the wafer allreduce (at ``manycore.SMOKE`` and a few more
layouts, on both engines) and of the systolic matmul (small grids, both
engines); and the per-epoch byte count, the same for both cells of a
configuration and equal to hand arithmetic at a small size.  The test
imports the port; the reference does not."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import systolic_ref, wafer_ref
from bench.systems import systolic, wafer
from repro_torch.configs.manycore import SMOKE
from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.manycore import CoreParams, ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.systolic import SystolicCell, SystolicParams, make_cell_params
from repro_torch.kernels import fused_checks

ROOT = Path(__file__).resolve().parents[1]
ENGINES = {"register": FusedEngine, "queue": GraphEngine}


def _port_wafer(R, C, ko, ki, cap, tiles, intra, v):
    g = ChannelGraph.torus(ManycoreCell(R, C), R, C,
                           params=make_core_params(np.ones((R, C), np.float32)), capacity=cap)
    eng = ENGINES[intra](g, tiered_grid_partition(R, C, tiles), None,
                         tiers=[(("pod",), ko), (("g",), ki)],
                         batch_axes={"pod": tiles[0][0] * tiles[0][1],
                                     "g": tiles[1][0] * tiles[1][1]},
                         overlap=False, device="cpu")
    sim = Simulation(eng).reset(0, group_params={0: CoreParams(value=v)})
    sim.run(until=lambda s: allreduce_done(s.block_states[0], s.tables.active[0]),
            max_epochs=400)
    return sim.cycle, eng.gather_group(sim.state, 0).total


@pytest.mark.parametrize("intra", ["register", "queue"])
@pytest.mark.parametrize("R, C, ko, ki, cap, tiles", [
    (SMOKE.grid_rows, SMOKE.grid_cols, SMOKE.k_outer, SMOKE.k_inner,
     SMOKE.queue_capacity, [(2, 1), (2, 2)]),
    (8, 8, 1, 1, 2, [(2, 1), (2, 2)]),
    (16, 8, 2, 2, 4, [(2, 1), (2, 2)]),
    (20, 12, 1, 3, 5, [(2, 2), (1, 2)]),  # registers and queues stop apart
])
def test_wafer_reference_matches_the_port(R, C, ko, ki, cap, tiles, intra):
    v = torch.randint(1, 9, (R * C,), generator=torch.Generator().manual_seed(R * C + cap)
                      ).to(torch.float32)
    cycle, tot = _port_wafer(R, C, ko, ki, cap, tiles, intra, v)
    assert cycle == wafer_ref.stop_cycle(R, C, tiles, (ko, ki), cap, intra, 400)
    assert np.array_equal(tot, np.full(R * C, float(wafer_ref.totals(v)), np.float32))


def test_wafer_reference_tells_registers_from_queues():
    stops = {i: wafer_ref.stop_cycle(20, 12, [(2, 2), (1, 2)], (1, 3), 5, i, 400)
             for i in ("register", "queue")}
    assert stops == {"register": 72, "queue": 69}


@pytest.mark.parametrize("M, R, C, K", [(5, 6, 7, 1), (8, 8, 8, 4), (33, 18, 24, 5)])
def test_systolic_reference_matches_both_engines(M, R, C, K):
    g = torch.Generator().manual_seed(M * R * C)
    A, B = torch.randn(M, R, generator=g), torch.randn(R, C, generator=g)
    want = systolic_ref.product(A, B).numpy()
    stop = systolic_ref.stop_cycle(M, R, C, K, 400)
    graph = ChannelGraph.grid(SystolicCell(M), R, C, params=make_cell_params(A.numpy(), B.numpy()))
    reg = RegisterGridEngine.from_graph(graph, K=K, device="cpu")
    sim = Simulation(reg).reset()
    sim.run(until=reg.y_done, max_epochs=400)
    assert sim.cycle == stop and np.array_equal(reg.result(sim.state), want)
    fe = FusedEngine.grid(SystolicCell(m_stream=M), R, C, K=K, device="cpu")
    p = make_cell_params(A.numpy(), B.numpy())
    p = SystolicParams(**{k: torch.as_tensor(getattr(p, k)).reshape(
        (R * C,) + getattr(p, k).shape[2:]) for k in ("b", "is_west", "is_north",
                                                     "is_south", "is_east", "a_buf")})
    sim = Simulation(fe).reset(0, group_params={0: p})
    sim.run(until=fused_checks.network_done(fe), max_epochs=400)
    assert sim.cycle == stop
    assert np.array_equal(fused_checks.grid_result(fe, sim.state, 0, R, C, M), want)


def test_control_products_differ():
    g = torch.Generator().manual_seed(1)
    A, B = torch.randn(16, 12, generator=g), torch.randn(12, 10, generator=g)
    assert not torch.equal(systolic_ref.product(A, B),
                           systolic_ref.product(A, B, torch.bfloat16).float())
    v = torch.randint(1, 9, (64 * 64,), generator=g).float()
    assert wafer_ref.totals_bf16(v.reshape(64, 64)) != wafer_ref.totals(v)


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["wafer-1M", "systolic-1M"])
def test_the_count_is_the_same_for_both_cells_of_a_configuration(config):
    """Both cells of a configuration stop at the same cycle (at a small
    size here; 4352 and 4154 at full size on the card) and the count takes
    nothing but the configuration and the stop cycle."""
    bench = harness.benchmark()
    cells = [w for w in bench["workloads"] if w["config"] == config]
    assert len(cells) == 2
    small = dict(wafer=dict(grid_rows=8, grid_cols=8, k_inner=4, k_outer=2, queue_capacity=8),
                 systolic=dict(grid_rows=6, grid_cols=5, m_stream=7, k=4))
    counts = set()
    for cell in cells:
        _, cfg, mix = harness.cell_files(bench, cell["name"])
        cfg = dict(cfg, **small[cfg["system"]])
        mod = harness.system_module(cfg)
        stop = mod.reference_stop(cfg, mix, "cpu")
        counts.add(mod.run_bytes(cfg, stop))
    assert len(counts) == 1


def test_the_count_by_hand_at_a_small_size():
    w = dict(_cfg("wafer-1M"), grid_rows=8, grid_cols=8)  # tiles 2 x 1, 2 x 2
    # 8 x 8 cores: 2 granule columns, 4 granule rows; 2 x 7 packets cross a
    # row, 4 x 7 a column; 64 cycles = 4 epochs of 16
    crossing = 8 * 2 * 7 + 8 * 4 * 7
    assert wafer.run_events(w) == {"exchanged_packet": crossing}
    assert wafer.run_bytes(w, 64) == 4 * 64 * (51 + 51) + crossing * 16
    s = dict(_cfg("systolic-1M"), grid_rows=4, grid_cols=3, m_stream=5)
    assert systolic.run_events(s) == {"stream_read": 20, "collect_write": 15}
    assert systolic.run_bytes(s, 124) == 2 * 12 * (38 + 30) + 20 * 4 + 15 * 4
