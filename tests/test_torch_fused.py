"""The port's ``FusedEngine`` (CPU, plain version) against the JAX
``FusedEngine`` with ``batch_axes``, epoch by epoch, leaf for leaf.

The reference wafer is an 8x8 torus on 2 pods x 2x2 granules, all batched
on one device.  Tolerance is bit-exact throughout: the logic is integer
handshakes over exact f32 adds.  Each JAX engine is built and compiled once
per module (a fixture) and its trajectory is shared by the cases; overlap
is a schedule choice that is bit-identical by construction, so the port
runs both schedules against each reference trajectory.
"""
import jax
import numpy as np
import pytest
import torch

from repro.hw.manycore import allreduce_done as j_done
from repro_torch.convert import fused_state_from_numpy, fused_state_to_numpy
from repro_torch.core import ChannelGraph, NetworkSim
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.manycore import ManycoreCell, make_core_params

from test_torch_graph import assert_same_state, jax_state_dict, wafer_pair

R = C = 8
CAP = 8
TIERS = {
    "k11": [(("pod",), 1), (("g",), 1)],
    "k24": [(("pod",), 2), (("g",), 4)],
}


def _trajectory(tiers, overlap, n_epochs):
    je, _, vals = wafer_pair(R, C, tiers, CAP, overlap=overlap)
    st = je.place(je.init(jax.random.key(0)))
    states = [jax_state_dict(st)]
    done_at = None
    for ep in range(n_epochs):
        st = je.run_epochs(st, 1, donate=False)
        states.append(jax_state_dict(st))
        if done_at is None and bool(j_done(st.block_states[0])):
            done_at = ep + 1
    return {"states": states, "done_at": done_at, "vals": vals}


@pytest.fixture(scope="module")
def ref_k11():
    """JAX reference at K=(1,1), serial schedule: 60 one-cycle epochs."""
    return _trajectory(TIERS["k11"], False, 60)


@pytest.fixture(scope="module")
def ref_k24():
    """JAX reference at K=(2,4), overlapped schedule: 8 epochs of 8 cycles."""
    return _trajectory(TIERS["k24"], True, 8)


def _port(tiers, overlap):
    return wafer_pair(R, C, tiers, CAP, overlap=overlap)[1]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("which", ["k11", "k24"])
def test_fused_matches_jax_epoch_by_epoch(which, overlap, ref_k11, ref_k24):
    ref = {"k11": ref_k11, "k24": ref_k24}[which]
    te = _port(TIERS[which], overlap)
    st = te.init(0)
    assert_same_state(ref["states"][0], st, "init")
    for ep, want in enumerate(ref["states"][1:]):
        st = te.run_epochs(st, 1)
        assert_same_state(want, st, (which, overlap, ep))
    # the reference trajectory covers the whole allreduce
    assert ref["done_at"] is not None
    total = te.gather_group(st, 0).total
    assert (total == ref["vals"].sum()).all()


def test_midrun_state_carried_across(ref_k24):
    """A mid-run JAX state, mapped into the port with
    ``fused_state_from_numpy``, continues to the JAX end state."""
    te = _port(TIERS["k24"], False)
    st = fused_state_from_numpy(te, ref_k24["states"][3])
    assert_same_state(ref_k24["states"][3], st, "converted")
    assert fused_state_to_numpy(st).keys() == ref_k24["states"][3].keys()
    st = te.run_epochs(st, 4)
    assert_same_state(ref_k24["states"][7], st, "continued")
    with pytest.raises(KeyError, match="missing"):
        fused_state_from_numpy(te, {"reg_val": ref_k24["states"][3]["reg_val"]})


def test_k11_capacity2_tracks_netlist_cycle_by_cycle():
    """K=(1,1) at capacity 2: the depth-1 registers are cycle-identical to
    capacity-2 rings, so the fused engine tracks the port's single-netlist
    oracle cycle by cycle."""
    vals = np.random.RandomState(3).randint(1, 20, size=(4, 4)).astype(np.float32)

    def graph():
        return ChannelGraph.torus(ManycoreCell(4, 4), 4, 4,
                                  params=make_core_params(vals), capacity=2)

    sim = NetworkSim(graph(), device="cpu")
    eng = FusedEngine(graph(), np.arange(16) % 4, None, tiers=[(("g",), 1)],
                      batch_axes={"g": 4}, device="cpu")
    ss, fs = sim.init(0), eng.init(0)
    for t in range(40):
        ss, fs = sim.step(ss), eng.run_epochs(fs, 1)
        ref = ss.block_states[0]
        got = eng.gather_group(fs, 0)
        for name in ("acc", "sent", "rcvd", "phase", "fires"):
            assert np.array_equal(getattr(ref, name).numpy(), getattr(got, name)), (t, name)
    assert (eng.gather_group(fs, 0).total == vals.sum()).all()


def test_donate_false_keeps_input():
    te = _port(TIERS["k24"], False)
    st0 = te.init(0)
    before = fused_state_to_numpy(st0)
    te.run_epochs(st0, 2, donate=False)
    after = fused_state_to_numpy(st0)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert int(te.run_cycles(st0, 9).cycle.reshape(-1)[0]) == 16


def test_real_axis_larger_than_one_raises():
    """A real axis larger than 1 (which raised before the mesh was ported)
    runs as two shards, each its own state, and after every epoch their
    state in the global layout equals the one-shard run of the same
    granules stacked on the batch axis, leaf for leaf."""
    from repro_torch.core.mesh import ShardedState

    vals = (np.arange(16) % 5 + 1).astype(np.float32).reshape(4, 4)

    def graph():
        return ChannelGraph.torus(ManycoreCell(4, 4), 4, 4,
                                  params=make_core_params(vals), capacity=4)

    real = FusedEngine(graph(), np.arange(16) % 2, {"gx": 2}, K=2, device="cpu")
    one = FusedEngine(graph(), np.arange(16) % 2, {"gx": 2}, K=2,
                      batch_axes=("gx",), device="cpu")
    assert (real.G_real, real.B, one.G_real, one.B) == (2, 1, 1, 2)
    sr, so = real.init(0), one.init(0)
    assert isinstance(sr, ShardedState) and len(sr.shards) == 2
    for ep in range(12):
        sr, so = real.run_epochs(sr, 1), one.run_epochs(so, 1)
        want = fused_state_to_numpy(so)
        got = fused_state_to_numpy(sr)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (ep, k)
    assert (real.gather_group(sr, 0).total == vals.sum()).all()


def test_overlap_knob_resolution(monkeypatch):
    """``overlap`` resolves as in the JAX package: an explicit value wins,
    ``REPRO_OVERLAP`` overrides "auto", and the split program pairs every
    issue with a commit."""
    from repro_torch.kernels import granule_step

    monkeypatch.setenv("REPRO_OVERLAP", "1")
    assert _port(TIERS["k24"], "auto").overlap
    assert not _port(TIERS["k24"], False).overlap
    monkeypatch.delenv("REPRO_OVERLAP")
    assert not _port(TIERS["k24"], "auto").overlap
    prog = _port(TIERS["k24"], True)._resident_program(0)
    assert prog == (("C", 4), ("XI", 1), ("XC", 1), ("C", 4), ("XI", 1),
                    ("XI", 0), ("XC", 1), ("XC", 0))
    assert granule_step.validate_program(prog) == prog
    with pytest.raises(ValueError, match="uncommitted"):
        granule_step.validate_program((("C", 1), ("XI", 0)))
