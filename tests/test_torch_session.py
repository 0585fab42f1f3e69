"""The port's ``Simulation`` session: the wafer allreduce run to
convergence against the JAX session, and host I/O through the fused
engine against the single-netlist oracle."""
import ctypes

import jax
import numpy as np
import pytest
import torch

from repro.core import Simulation as JSimulation
from repro.hw.manycore import allreduce_done as j_done
from repro_torch.core import Network, Simulation
from repro_torch.hw.manycore import allreduce_done, expected_total
from repro_torch.hw.pipestage import PipeStage, make_chain
from repro_torch.kernels import granule_step

from test_torch_graph import wafer_pair
from test_torch_network import TIncrement, chain


def test_allreduce_until_matches_jax_cycle():
    """``Simulation.run(until=allreduce_done)`` stops at the same cycle as
    the JAX session, with every core holding the global sum."""
    R = 8
    je, te, vals = wafer_pair(R, R, [(("pod",), 2), (("g",), 4)], 8)
    jsim = JSimulation(je).reset(jax.random.key(0))
    jsim.run(until=lambda s: j_done(s.block_states[0], s.tables.active[0]),
             cache_key="done")
    sim = Simulation(te).reset(0)
    sim.run(until=lambda s: allreduce_done(s.block_states[0], s.tables.active[0]))
    assert sim.cycle == jsim.cycle == 48
    assert sim.epoch == jsim.epoch
    total = te.gather_group(sim.state, 0).total
    assert np.array_equal(total, np.full(R * R, expected_total(vals), np.float32))
    # a done state runs zero more epochs
    sim.run(until=lambda s: allreduce_done(s.block_states[0], s.tables.active[0]))
    assert sim.cycle == jsim.cycle
    assert sim.stats()["cycle"] == sim.cycle
    assert float(sim.probe(5).total) == expected_total(vals)


def _script(sim):
    """Send 40 packets in bursts, drain everything that comes out."""
    tx, rx = sim.tx("tx"), sim.rx("rx")
    got = []
    for k in range(8):
        tx.send_many(np.stack([np.arange(5) + 10 * k, np.full(5, k)], 1))
        sim.run(cycles=6)
        got.extend(rx.drain().tolist())
    for _ in range(30):  # the rx ring holds 3: keep draining it
        sim.run(cycles=6)
        got.extend(rx.drain().tolist())
    return got, tx, rx


def test_host_io_fused_matches_netlist():
    """Host traffic through the fused engine's external queues (homed on
    their granules, flushed at epoch boundaries) delivers exactly the
    netlist's packets, in order."""
    ref, _, _ = _script(chain(Network, TIncrement(), 4, 4).build(device="cpu").reset(0))
    sim = chain(Network, TIncrement(), 4, 4).build(
        engine="fused", device="cpu", partition=[0, 0, 1, 1],
        tiers=[(("g",), 2)], batch_axes={"g": 2},
    )
    sim.reset(0)
    got, tx, rx = _script(sim)
    assert got == ref and len(got) == 40 and tx.pending == 0
    assert [p[0] for p in got] == [v + 4.0 for k in range(8)
                                   for v in np.arange(5) + 10 * k]
    stats = sim.stats()
    assert stats["ports"]["tx"]["tx"]["sent"] == 40
    assert stats["ports"]["rx"]["rx"]["received"] == 40
    assert stats["metrics"]["fused.epochs"] > 0


def test_run_arguments_and_reset():
    sim = chain(Network, TIncrement(), 2, 4).build(device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        sim.run(cycles=1)
    sim.reset(0)
    with pytest.raises(TypeError, match="exactly one"):
        sim.run(cycles=1, epochs=1)
    with pytest.raises(KeyError, match="no external-in"):
        sim.tx("nope")
    sim.run(cycles=5)
    assert sim.cycle == 5 and sim.block_until_ready() is sim


def test_cuda_program_refuses_blocks_without_device_step():
    """The kernel carries the steps of ManycoreCell, SystolicCell and
    PipeStage only; any other block type raises before anything is
    launched (checked here on a CPU carry)."""
    eng = chain(Network, TIncrement(), 4, 4).build(
        engine="fused", session=False, device="cpu", partition=[0, 0, 1, 1],
        tiers=[(("g",), 2)], batch_axes={"g": 2},
    )
    local = eng._local_view(eng.init(0))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    before = granule_step.launches
    with pytest.raises(NotImplementedError, match="TIncrement"):
        granule_step.epoch_program_cuda(carry, eng._resident_program(0),
                                        eng._consts(local.tables))
    assert granule_step.launches == before
    assert isinstance(local.reg_val, torch.Tensor)


class _OwnPipeStep(PipeStage):
    """A PipeStage with a step of its own: it has no device step."""

    def step(self, state, rx, tx_ready):
        return super().step(state, rx, tx_ready)


def test_pipestage_device_step_and_layout():
    """PipeStage is the kernel's type 2: its ctypes leaves mirror
    ``PipeLeaves`` (the count pointer, then the f32 delta), the union and
    so ``ProgramArgs`` keep their size (752 B, which the kernel's
    ``granule_args_size`` is checked against on load), its tables hold one
    port column, and a subclass with its own step still raises before
    anything is launched (checked on a CPU carry)."""
    assert granule_step.device_step_type(PipeStage(2.0)) == 2
    assert granule_step.device_step_type(_OwnPipeStep()) is None
    L = granule_step._PipeLeaves
    assert [f for f, _ in L._fields_] == ["count", "delta"]
    assert (L.count.offset, L.delta.offset, ctypes.sizeof(L)) == (0, 8, 16)
    assert ctypes.sizeof(granule_step._Leaves) == ctypes.sizeof(granule_step._CoreLeaves)
    assert ctypes.sizeof(granule_step._ProgramArgs) == 752
    eng = make_chain(4, capacity=4).build(engine="fused", session=False,
                                          device="cpu", K=2)
    local = eng._local_view(eng.init(0))
    assert [tuple(t.shape) for t in local.tables.rx_idx] == [(4, 1)]
    assert granule_step.consumer_table(
        eng._tx_flat, eng._inv_tx_flat, eng._inv_tx_mask_flat, eng._inv_rx_flat,
        eng._inv_rx_mask_flat, eng.B * eng.n_reg)[0][:, 0].tolist() == [1, 2, 3, -1]

    net = Network(payload_words=2, capacity=4)
    insts = [net.instantiate(_OwnPipeStep(), name=f"s{i}") for i in range(4)]
    net.external_in(insts[0]["in"], "tx")
    for a, b in zip(insts, insts[1:]):
        net.connect(a["out"], b["in"])
    net.external_out(insts[-1]["out"], "rx")
    eng = net.build(engine="fused", session=False, device="cpu", K=2)
    local = eng._local_view(eng.init(0))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    before = granule_step.launches
    with pytest.raises(NotImplementedError, match="_OwnPipeStep"):
        granule_step.epoch_program_cuda(carry, eng._resident_program(0),
                                        eng._consts(local.tables))
    assert granule_step.launches == before
