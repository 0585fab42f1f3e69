"""The procs engine with its workers on the card (``device="cuda"``): the
``procs-small`` cases of ``chip_smoke.py`` as tests.  Each fleet's
workers capture their cycle graphs at start and replay them every epoch.

This file imports no JAX, so it runs where JAX is absent
(``tests/test_torch_procs*.py`` hold the fleet against the JAX package on
the CPU).  The tests need a CUDA device and skip without one; run them
there with ``python -m pytest -q -m cuda tests/test_torch_procs_cuda.py``.
Tolerance: bit-exact (traffic, blocks, stop cycles).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.graph import PartitionTree, Tier
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.pipestage import make_chain
from repro_torch.hw.systolic import make_systolic_network
from repro_torch.runtime import ProcsEngine, WorkerDiedError

TIMEOUT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the workers' captured cycle graphs run "
                    "only there")
    return torch.device("cuda")


@pytest.fixture
def closing():
    engines = []
    yield engines.append
    for eng in engines:
        eng.close()


def procs(net, closing, **kw):
    sim = net.build(engine="procs", device="cuda", timeout=TIMEOUT, **kw)
    closing(sim.engine)
    return sim


def io_script(sim, n_steps=12):
    """Pseudo-random host sends and drains, one boundary at a time."""
    rng = np.random.RandomState(0)
    tx, rx = sim.tx("tx"), sim.rx("rx")
    trace = []
    for step in range(n_steps):
        k = int(rng.randint(0, 3))
        if k:
            tx.send_many([[100.0 * step + j, float(step)] for j in range(k)])
        sim.run(cycles=sim.period)
        trace.append(np.asarray(rx.drain()))
    sim.run(cycles=16 * sim.period)
    trace.append(np.asarray(rx.drain()))
    return trace


@pytest.mark.cuda
@pytest.mark.parametrize("n,part,nw", [(3, [0, 0, 1], 2),
                                       (4, {"s0": 3, "s1": 2, "s2": 2, "s3": 1}, 4)])
def test_io_script_on_the_card(cuda, closing, n, part, nw):
    """K = 1, capacity 2: the host script's traffic on a fleet on the card
    equals NetworkSim's on the card, ports homed on worker 0 or not."""
    want = io_script(make_chain(n, capacity=2).build(device="cuda").reset(0))
    sim = procs(make_chain(n, capacity=2), closing, n_workers=nw, partition=part, K=1)
    got = io_script(sim.reset(0))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")
    rows = sim.stats()["workers"]
    assert {r["device"] for r in rows} <= {f"cuda:{i}" for i in range(torch.cuda.device_count())}


@pytest.mark.cuda
def test_systolic_scenario_on_the_card(cuda, closing, tmp_path):
    """run(cycles=12), save, probe, run(until); load into a fresh fleet and
    resume: Y bit-identical to NetworkSim's on the card."""
    rng = np.random.RandomState(3)
    M, K, N = 6, 4, 4
    A, B = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(np.float32)
    done = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                      | (s.block_states[0].y_idx >= M)).all()

    def result_of(sim):
        return np.stack([sim.probe((K - 1) * N + c).y_buf.cpu().numpy()
                         for c in range(N)], axis=1)

    ref = make_systolic_network(A, B)[0].build(device="cuda").reset(0)
    ref.run(until=done, max_epochs=100_000)
    want = result_of(ref).view(np.uint32)
    part = (np.arange(K * N) % 4).tolist()
    sim = procs(make_systolic_network(A, B)[0], closing, n_workers=4, partition=part, K=4)
    sim.reset(0).run(cycles=12)
    sim.save(str(tmp_path / "sys"))
    assert int(sim.probe(0).a_idx) > 0
    sim.run(until=done, max_epochs=100_000)
    np.testing.assert_array_equal(result_of(sim).view(np.uint32), want)
    sim2 = procs(make_systolic_network(A, B)[0], closing, n_workers=4, partition=part, K=4)
    sim2.reset(0).load(str(tmp_path / "sys"))
    assert sim2.cycle == 12
    sim2.run(until=done, max_epochs=100_000)
    np.testing.assert_array_equal(result_of(sim2).view(np.uint32), want)


def _wafer(R=32, C=32):
    vals = ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C, params=make_core_params(vals),
                               capacity=4)
    ptree = PartitionTree(tiered_grid_partition(R, C, [(2, 1), (2, 1)]),
                          (Tier(axes=("pod",), K=2), Tier(axes=("g",), K=4)),
                          {"pod": 2, "g": 2})
    return graph, ptree


@pytest.mark.cuda
@pytest.mark.parametrize("batch,overlap", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_wafer_fleet_matches_graph_engine(cuda, closing, batch, overlap):
    """The 32x32 wafer on 4 workers on the card: stop cycle and every block
    bit-identical to GraphEngine's on the same PartitionTree on the card."""
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    graph, ptree = _wafer()
    ref = Simulation(GraphEngine(graph, ptree, batch_axes={"pod": 2, "g": 2},
                                 device="cuda")).reset(0)
    ref.run(until=done, max_epochs=1000)
    eng = ProcsEngine(graph, ptree, batch_signatures=batch, overlap=overlap,
                      timeout=TIMEOUT, device="cuda")
    closing(eng)
    sim = Simulation(eng).reset(0)
    sim.run(until=done, max_epochs=1000)
    assert sim.cycle == ref.cycle
    want, got = ref.engine.gather_group(ref.state, 0), eng.gather_group(sim.state, 0)
    for (p, a), (_, b) in zip(tree_paths(want), tree_paths(got)):
        assert np.array_equal(a, b), p
    assert all(b["capture_s"] > 0 for b in eng.launch_stats["build"].values())


@pytest.mark.cuda
def test_kill_one_worker_on_the_card(cuda, closing):
    """SIGKILL of worker 1: WorkerDiedError naming it, its log tail holding
    "granule 1", within the timeout, the fleet torn down."""
    sim = procs(make_chain(3, capacity=4), closing, n_workers=3, partition=[0, 1, 2], K=1)
    sim.reset(0).tx("tx").send([1.0, 0.0])
    sim.run(cycles=4)
    os.kill(sim.engine._procs[1].pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(WorkerDiedError) as exc:
        sim.run(cycles=200)
    assert time.monotonic() - t0 < TIMEOUT
    assert exc.value.worker == 1 and "granule 1" in str(exc.value)
    assert sim.engine._closed
