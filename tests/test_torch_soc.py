"""The §IV-A heterogeneous SoC at scale on the CPU (``repro_torch.hw.soc``):
N SoCs, whole SoCs a granule, on ``FusedEngine`` (the blocks' own steps,
the kernel's eager twins on the CPU) and on ``GraphEngine``, against the
benchmark's plain reference ``bench/reference/soc_ref.py``; the reference
against the single netlist; ``ChannelGraph.replicate`` against
``from_network``; the SoC groups' port tables (a type without in ports,
in and out counts that differ), the kernel's variant masks and the
counters a program's build publishes.  Tolerance: bit-exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).resolve().parents[1]))  # the benchmark's reference

from bench.reference import soc_ref  # noqa: E402
from repro_torch.core import ChannelGraph, Network, Simulation  # noqa: E402
from repro_torch.core.distributed import GraphEngine  # noqa: E402
from repro_torch.core.fused import FusedEngine  # noqa: E402
from repro_torch.hw.manycore import ManycoreCell  # noqa: E402
from repro_torch.hw.soc import (  # noqa: E402
    N_REQ, AnalogRamp, Cpu, DramModel, DramParams, build_soc, soc_done, soc_graph,
    soc_partition,
)
from repro_torch.kernels import granule_step  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.registry import REGISTRY  # noqa: E402

ENGINES = {"register": FusedEngine, "queue": GraphEngine}
REF = dict(n_req=N_REQ, latency=DramModel.LATENCY, period=AnalogRamp.PERIOD,
           divider=AnalogRamp.clock_divider, capacity=8, max_epochs=200)


def _contents(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1024, (n, N_REQ), generator=g, dtype=torch.int32).float()


def _port_run(intra: str, n: int, granules: int, K: int, mem: torch.Tensor) -> tuple:
    eng = ENGINES[intra](soc_graph(n), soc_partition(n, granules), None, K=K,
                         batch_axes={"g": granules}, overlap=False, device="cpu")
    sim = Simulation(eng).reset(0, group_params={1: DramParams(mem=mem)})
    sim.run(until=lambda s: soc_done(s.block_states[0], s.tables.active[0]),
            max_epochs=REF["max_epochs"])
    return eng.gather_group(sim.state, 0), sim.cycle


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("intra", ["register", "queue"])
def test_engines_match_the_reference(intra, K):
    """64 SoCs on 2 granules, seeded DRAM contents: FusedEngine (channels
    inside a granule are registers) and GraphEngine (queues) against the
    reference under the same channel semantics — every CPU's results and
    the stop cycle exact."""
    mem = _contents(64, seed=K + len(intra))
    cpu, stop = _port_run(intra, 64, 2, K, mem)
    want, want_stop = soc_ref.run(mem, k=K, intra=intra, **REF)
    assert stop == want_stop and stop % K == 0
    assert np.array_equal(cpu.results.view(np.uint32), want.numpy().view(np.uint32))
    assert (cpu.n_done == N_REQ).all() and (cpu.pc == N_REQ).all()


def test_reference_matches_the_single_netlist():
    """The reference with queues of the example's capacity against the
    port's single-netlist run of the example's SoC, its DRAM holding the
    source's ``10 * addr``: the same 8 results, 8 of 8 reads done."""
    net, cpu = build_soc()
    sim = net.build(device="cpu")
    sim.reset(0).run(cycles=120)
    got = sim.probe(cpu)
    assert int(got.n_done) == N_REQ
    mem = (torch.arange(N_REQ, dtype=torch.float32) * 10.0)[None]
    want, stop = soc_ref.run(mem, k=1, intra="queue", **REF)
    assert stop <= 120
    assert torch.equal(got.results, want[0])


def test_reference_registers_and_queues_agree():
    """One read is outstanding at a time and each sample is taken the
    cycle after it is offered, so no channel holds two packets: the two
    channel semantics give the same schedule (the stop a multiple of k)."""
    a = soc_ref.schedule(3, k=8, intra="register", **REF)
    b = soc_ref.schedule(3, k=8, intra="queue", **REF)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2] == 56
    assert torch.equal(a[0][0], torch.arange(N_REQ))


def _network_of(n: int) -> Network:
    net = Network(payload_words=2, capacity=8)
    blocks = Cpu(), DramModel(), AnalogRamp()
    for _ in range(n):
        cpu, dram, adc = (net.instantiate(b) for b in blocks)
        net.connect(cpu["dram_req"], dram["req"])
        net.connect(dram["resp"], cpu["dram_resp"])
        net.connect(adc["adc_out"], cpu["adc_in"])
    return net


def test_replicate_matches_from_network():
    """``soc_graph(4)`` (``ChannelGraph.replicate``) against
    ``from_network`` of a network that builds the 4 SoCs in turn: every
    table, member list and instance location equal."""
    want, got = ChannelGraph.from_network(_network_of(4)), soc_graph(4)
    assert got.n_channels == want.n_channels == 2 + 12
    for a, b in zip(want.rx_idx + want.tx_idx, got.rx_idx + got.tx_idx):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in ((want.chan_src, got.chan_src), (want.chan_dst, got.chan_dst),
                 (want.inst_loc, got.inst_loc)):
        assert np.array_equal(a, b)
    for ga, gb in zip(want.groups, got.groups):
        assert type(ga.block) is type(gb.block) and np.array_equal(ga.members, gb.members)
    net = Network(payload_words=2, capacity=8)
    net.external_in(net.instantiate(DramModel())["req"], "tx")
    with pytest.raises(ValueError, match="external ports"):
        ChannelGraph.replicate(net, 2)


def test_soc_groups_port_tables_and_masks():
    """The SoC's groups on the fused engine: rx tables of 2, 1 and 0
    columns and tx tables of 1 (a type without in ports, a type whose in
    and out counts differ); the consumer tables name each register's
    consumer across groups with in ports laid end to end; the program is
    the SoC's mask, and other mixes of its types raise naming the mix."""
    n, G = 8, 2
    eng = FusedEngine(soc_graph(n), soc_partition(n, G), None, K=8,
                      batch_axes={"g": G}, overlap=False, device="cpu")
    blocks = [g.block for g in eng.graph.groups]
    assert [type(b) for b in blocks] == [Cpu, DramModel, AnalogRamp]
    assert [t.shape[1:] for t in eng._rx_flat] == [(n, 2), (n, 1), (n, 0)]
    assert [t.shape[1:] for t in eng._tx_flat] == [(n, 1), (n, 1), (n, 1)]
    assert [granule_step._PORTS[granule_step.device_step_type(b)] for b in blocks] == [
        (2, 1), (1, 1), (0, 1)]
    cons = granule_step.consumer_table(eng._tx_flat, eng._inv_tx_flat,
                                       eng._inv_tx_mask_flat, eng._inv_rx_flat,
                                       eng._inv_rx_mask_flat, eng.B * eng.n_reg)
    slot = np.arange(n)[:, None]
    # the CPU's request -> the DRAM's in port (after the CPUs' 2 * n)
    assert np.array_equal(cons[0], 2 * n + slot)
    # the DRAM's reply -> the CPU's port 0, the ramp's sample -> its port 1
    assert np.array_equal(cons[1], 2 * slot)
    assert np.array_equal(cons[2], 2 * slot + 1)
    assert granule_step.program_mask(blocks) == granule_step.SOC_MASK == 56
    for mix in ([Cpu(), DramModel()], [ManycoreCell(2, 2), Cpu(), DramModel(), AnalogRamp()]):
        with pytest.raises(NotImplementedError, match="Cpu, DramModel"):
            granule_step.program_mask(mix)
    assert granule_step.program_mask([ManycoreCell(2, 2)]) == 1


def test_build_publishes_the_granule_program():
    """A fused engine's build publishes the slots a launch steps by block
    type and the variant mask, and the report prints them."""
    FusedEngine(soc_graph(12), soc_partition(12, 3), None, K=8,
                batch_axes={"g": 3}, overlap=False, device="cpu")
    snap = REGISTRY.snapshot()
    assert {snap[f"granule.slots.{t}"] for t in ("cpu", "drammodel", "analogramp")} == {12.0}
    assert snap["granule.mask"] == 56.0
    text = "\n".join(report.granule_lines(snap))
    assert "analogramp" in text and "56" in text
    assert report.granule_lines({}) == []
