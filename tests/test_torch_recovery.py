"""The port's self-healing procs fleet (``runtime/recovery.py``,
``runtime/faultinject.py``) on the CPU, case for case against
``tests/test_recovery.py``:

  * kill drills at three epochs under ``on_fault="recover"``: the host
    trace AND the final ``gather_state`` tree bit-identical to a
    fault-free fleet's, one restart, ``stats()["faults"]`` wired;
  * the same for a ``corrupt`` drill (a flipped byte on a checked slab
    ring -> ``RingCorruptionError`` -> heal) and a clean ``exit0``;
  * a clean exit detected fast, and ``RingCorruptionError`` raised under
    the default ``raise`` policy;
  * a stolen credit diagnosed as a credit wait-for cycle;
  * restart-budget exhaustion, snapshot cadence, and a fault inside the
    run-entry gather replayed through the host-I/O journal;
  * a recovery incident in the trace; ``close()`` leaves no worker alive
    (a stopped one is killed);
  * the fault-plan grammar, env precedence and plan validation;
  * one cross-package drill: ``kill:1@5`` on the JAX ``ProcsEngine`` and
    on the port's fleet gives the same Rx traffic, ``gather_state`` leaf
    for leaf and recovery counters.

Workers run on ``device="cpu"``.  Tolerance: bit-exact.  The checked-ring
units live in ``tests/test_torch_shmem.py``.
"""
import os
import signal
import time

import numpy as np
import pytest

from repro_torch.core.struct import tree_paths
from repro_torch.hw.pipestage import make_chain, make_ring
from repro_torch.obs import report as oreport
from repro_torch.obs import schema as oschema
from repro_torch.runtime import (
    FleetStallError, RingCorruptionError, RingTimeout, WorkerDiedError,
    parse_fault_plan, resolve_on_fault,
)
from repro_torch.runtime.faultinject import FaultAction, actions_for
from repro_torch.runtime.worker import credit_ring_name

from test_torch_procs_parity import _jax_leaves
from test_torch_session_surface import io_script

TIMEOUT = 60.0  # generous: the test workers timeshare the box's cores


@pytest.fixture
def closing():
    sims = []
    yield sims.append
    for sim in sims:
        sim.engine.close()


def fleet(closing, **kw):
    """The reference drill's fleet: a 3-stage chain on 2 workers, K = 1."""
    kw.setdefault("timeout", TIMEOUT)
    sim = make_chain(3, capacity=4).build(
        engine="procs", device="cpu", n_workers=2, partition=[0, 0, 1], K=1, **kw)
    closing(sim)
    return sim


def assert_trees_equal(ref, got):
    want, have = tree_paths(ref), tree_paths(got)
    assert [p for p, _ in want] == [p for p, _ in have]
    for (p, a), (_, b) in zip(want, have):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a, b), p


def reference_run(closing, seed):
    ref = fleet(closing)
    ref.reset(0)
    trace = io_script(ref, n_steps=8, seed=seed)
    tree = ref.engine.gather_state(ref.state)
    ref.engine.close()
    return trace, tree


def drill(closing, seed, fault_plan):
    """The io_script on a fault-free fleet and on a self-healing fleet
    with ``fault_plan`` injected: both must be bit-identical."""
    ref_trace, ref_tree = reference_run(closing, seed)
    sim = fleet(closing, on_fault="recover", snapshot_every=2, backoff_s=0.0,
                fault_plan=fault_plan)
    sim.reset(0)
    trace = io_script(sim, n_steps=8, seed=seed)
    tree = sim.engine.gather_state(sim.state)
    assert len(ref_trace) == len(trace)
    for step, (a, b) in enumerate(zip(ref_trace, trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, tree)
    return sim


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kill_recovery_bit_identical(closing, seed):
    """SIGKILL one worker at a seed-dependent epoch: the fleet respawns,
    restores the last coordinated snapshot, replays, and the host sees a
    timeline bit-identical to the fault-free run."""
    sim = drill(closing, seed, f"kill:1@{3 + 2 * seed}")
    faults = sim.stats()["faults"]  # session wiring: stats()["faults"]
    assert faults["policy"] == "recover"
    assert faults["restarts"] == 1
    assert faults["incarnation"] == 1
    assert faults["last_recovery"]["fault"] == "WorkerDiedError"
    assert sim.engine._incarnation == 1


def test_corruption_recovery_bit_identical(closing):
    """A flipped byte on a checked slab ring is detected by crc32, the
    fleet is rebuilt, and the healed timeline is bit-identical."""
    sim = drill(closing, 1, "corrupt:0@3")
    faults = sim.stats()["faults"]
    assert faults["restarts"] == 1
    assert faults["last_recovery"]["fault"] == "RingCorruptionError"


def test_clean_exit_recovery_bit_identical(closing):
    """A worker that exits with code 0 mid-run is a fault like a kill:
    healed to the fault-free timeline."""
    sim = drill(closing, 0, "exit0:1@3")
    faults = sim.engine.fault_stats()
    assert faults["restarts"] == 1
    assert faults["last_recovery"]["fault"] == "WorkerDiedError"


def test_clean_exit_detected_fast(closing):
    """exitcode 0 while replies are pending is a fault, detected by the
    liveness poll (not the slow heartbeat timeout)."""
    sim = fleet(closing, fault_plan="exit0:1@2")
    sim.reset(0)
    t0 = time.monotonic()
    with pytest.raises(WorkerDiedError, match="exited cleanly") as ei:
        sim.run(cycles=8 * sim.period)
    assert ei.value.worker == 1
    assert time.monotonic() - t0 < TIMEOUT / 2  # poll, not timeout
    assert sim.engine._closed


def test_corruption_raises_by_default(closing):
    """Under on_fault="raise" a checked-ring mismatch surfaces as a typed
    RingCorruptionError naming the channel — never a hang."""
    sim = fleet(closing, fault_plan="corrupt:0@2")
    sim.reset(0)
    with pytest.raises(RingCorruptionError, match="crc32 mismatch"):
        sim.run(cycles=8 * sim.period)
    assert sim.engine._closed


def test_fleet_stall_diagnosed(closing):
    """Two workers in a credit ring with one credit stolen deadlock; the
    monitor decodes the per-worker status words into a wait-for cycle and
    raises FleetStallError naming it (instead of blaming one worker)."""
    sim = make_ring(2, capacity=4).build(engine="procs", device="cpu", n_workers=2,
                                         partition=[0, 1], K=1, timeout=4.0)
    closing(sim)
    sim.reset(0)
    eng = sim.engine
    _, chans = sorted(eng.lowering.routes.items())[0]
    eng._rings[credit_ring_name(eng._ring_prefix, chans[0])].pop_bytes()
    t0 = time.monotonic()
    with pytest.raises(FleetStallError, match="credit wait-for cycle") as ei:
        eng.run_epochs(sim.state, 40)
    assert time.monotonic() - t0 < TIMEOUT
    assert set(ei.value.cycle) == {0, 1}
    assert any("credit-pop" in d or "slab-pop" in d for d in ei.value.details)
    assert eng._closed


def test_recovery_exhaustion(closing):
    """A replay-time re-kill (incarnation 1) with max_restarts=1 must
    exhaust the restart budget loudly, chaining the underlying fault."""
    sim = fleet(closing, on_fault="recover", snapshot_every=2, backoff_s=0.0,
                max_restarts=1, fault_plan="kill:1@3, kill:1@3:r1")
    sim.reset(0)
    with pytest.raises(RuntimeError, match="recovery exhausted") as ei:
        sim.run(cycles=8 * sim.period)
    assert isinstance(ei.value.__cause__, WorkerDiedError)
    assert sim.engine.fault_stats()["restarts"] == 2  # the exhausting attempt counts


def test_snapshot_cadence(closing):
    """Snapshots land on every multiple of snapshot_every plus one at
    each run entry (the run-entry snapshot makes the first chunk
    restorable)."""
    sim = fleet(closing, on_fault="recover", snapshot_every=4)
    sim.reset(0)
    eng = sim.engine
    state = eng.run_epochs(sim.state, 10)  # entry@0 + boundaries 4, 8
    faults = eng.fault_stats()
    assert faults["snapshots"] == 3
    assert faults["last_snapshot_epoch"] == 8
    eng.run_epochs(state, 6)               # entry@10 + boundaries 12, 16
    faults = eng.fault_stats()
    assert faults["snapshots"] == 6
    assert faults["last_snapshot_epoch"] == 16
    assert faults["restarts"] == 0


def test_entry_gather_fault_replays_host_io(closing):
    """A recoverable fault inside the RUN-ENTRY gather rewinds to a
    snapshot whose ext capture predates the host I/O performed at the
    current boundary.  The host-I/O journal makes that rewind exact:
    packets the host already popped are not re-delivered by the replay,
    and pushes the gather never captured re-enter their rings at the
    original boundary — the io_script trace stays bit-identical."""
    ref_trace, ref_tree = reference_run(closing, 1)
    sim = fleet(closing, on_fault="recover", snapshot_every=2, backoff_s=0.0)
    sim.reset(0)
    eng = sim.engine
    real_gather, calls = eng.gather_state, [0]

    # gathers land at run entries 0, 1, 3 and the boundary 2 — call #4 is
    # the step-3 ENTRY repair, after the host drained boundary 2 and
    # pushed the step-3 input, with the last snapshot back at epoch 2
    def racing_gather(state):
        calls[0] += 1
        if calls[0] == 4:
            raise RingTimeout("injected: gather raced a dying worker")
        return real_gather(state)

    eng.gather_state = racing_gather
    trace = io_script(sim, n_steps=8, seed=1)
    eng.gather_state = real_gather
    tree = eng.gather_state(sim.state)
    for step, (a, b) in enumerate(zip(ref_trace, trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, tree)
    faults = eng.fault_stats()
    assert faults["restarts"] == 1
    assert faults["last_recovery"]["fault"] == "RingTimeout"
    assert faults["last_recovery"]["restored_epoch"] == 2


def test_recovery_incident_lands_in_trace(closing, tmp_path):
    """Kill drill under the recorder: the healed fleet's timeline holds
    the recovery_incident instant tagged with the new incarnation, and
    snapshot spans."""
    path = str(tmp_path / "drill.json")
    sim = fleet(closing, on_fault="recover", snapshot_every=2, backoff_s=0.0,
                fault_plan="kill:1@3")
    sim.reset(0)
    with sim.trace(path):
        io_script(sim, n_steps=8, seed=1)
    st = oschema.validate_stats(sim.stats())
    assert st["faults"]["restarts"] == 1
    assert st["metrics"]["recovery.restarts"] >= 1.0

    doc = oschema.validate_trace_file(path)
    incidents = [e for e in doc["traceEvents"]
                 if e.get("ph") == "i" and e["name"] == "recovery_incident"]
    assert len(incidents) == 1
    assert incidents[0]["args"]["incarnation"] == 1
    assert incidents[0]["args"]["fault"] == "WorkerDiedError"
    assert any(e["name"] == "snapshot" for e in doc["traceEvents"]
               if e.get("ph") == "X")
    assert "recovery_incident" in oreport.summarize(doc)


def test_close_leaves_no_worker_alive(closing):
    """A stopped worker holds SIGTERM pending: close() must still end
    every process (a survivor would keep its device context beside the
    next incarnation's)."""
    sim = fleet(closing)
    sim.reset(0)
    procs = list(sim.engine._procs.values())
    os.kill(procs[1].pid, signal.SIGSTOP)
    try:
        sim.engine.close()
        assert not [p.pid for p in procs if p.is_alive()]
    finally:  # a survivor must not hang the interpreter's exit
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)


# ------------------------------------------------- plan grammar + env knobs
def test_fault_plan_grammar():
    plan = parse_fault_plan("kill:1@5, corrupt:0@2:c7 slow:1@2:0.05:r1")
    assert plan == (
        FaultAction("kill", 1, 5),
        FaultAction("corrupt", 0, 2, 7.0),
        FaultAction("slow", 1, 2, 0.05, restart=1),
    )
    assert actions_for(plan, 1, 0) == (FaultAction("kill", 1, 5),)
    assert actions_for(plan, 1, 1) == (FaultAction("slow", 1, 2, 0.05, restart=1),)
    assert actions_for(plan, 2, 0) == ()
    with pytest.raises(ValueError, match="bad fault-plan token"):
        parse_fault_plan("kill:1")
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_fault_plan("melt:1@5")


def test_on_fault_env_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_ON_FAULT", raising=False)
    assert resolve_on_fault() == "raise"
    monkeypatch.setenv("REPRO_ON_FAULT", "recover")
    assert resolve_on_fault() == "recover"
    assert resolve_on_fault("raise") == "raise"  # explicit arg wins
    with pytest.raises(ValueError, match="on_fault"):
        resolve_on_fault("retry")
    monkeypatch.setenv("REPRO_FAULT_PLAN", "kill:1@3")
    eng = make_chain(3).build(engine="procs", device="cpu", n_workers=2,
                              partition=[0, 0, 1], session=False)
    try:
        assert eng.on_fault == "recover"
        assert eng.fault_plan == (FaultAction("kill", 1, 3),)
    finally:
        eng.close()


def test_fault_plan_validates_workers():
    """A plan naming a worker outside the fleet, or a link fault on a
    single-host fleet, is a build-time error."""
    with pytest.raises(ValueError, match="fault plan targets worker"):
        make_chain(3).build(engine="procs", device="cpu", n_workers=2,
                            partition=[0, 0, 1], fault_plan="kill:7@3")
    with pytest.raises(ValueError, match="no bridged links"):
        make_chain(3).build(engine="procs", device="cpu", n_workers=2,
                            partition=[0, 0, 1], fault_plan="linkkill:0@3")


# ------------------------------------------------------ against the JAX fleet
def test_kill_drill_matches_jax_fleet(closing):
    """``kill:1@5`` on the JAX ``ProcsEngine`` and on the port's fleet, the
    same chain and host script: the same Rx traffic, ``gather_state``
    equal leaf for leaf in flatten order, and equal recovery counters."""
    from repro.hw.pipestage import make_chain as j_chain

    kw = dict(n_workers=2, partition=[0, 0, 1], K=1, timeout=TIMEOUT,
              on_fault="recover", snapshot_every=2, backoff_s=0.0,
              fault_plan="kill:1@5")
    jsim = j_chain(3, capacity=4).build(engine="procs", **kw)
    closing(jsim)
    tsim = fleet(closing, **{k: v for k, v in kw.items()
                             if k not in ("n_workers", "partition", "K")})
    traffic, faults = {}, {}
    for tag, sim in (("jax", jsim), ("port", tsim)):
        sim.reset(0)
        traffic[tag] = io_script(sim, n_steps=8, seed=2)
        faults[tag] = sim.engine.fault_stats()
    assert len(traffic["jax"]) == len(traffic["port"])
    for step, (a, b) in enumerate(zip(traffic["jax"], traffic["port"])):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    want = _jax_leaves(jsim.engine.gather_state(jsim.state))
    got = [(p, np.asarray(x)) for p, x in tree_paths(tsim.engine.gather_state(tsim.state))]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        assert np.array_equal(a, b), p
    for key in ("restarts", "snapshots", "last_snapshot_epoch", "recovered_epochs",
                "incarnation"):
        assert faults["jax"][key] == faults["port"][key], key
    assert faults["port"]["restarts"] == 1
