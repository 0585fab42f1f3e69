"""The port's worker telemetry and drift (``obs/telemetry.py``,
``obs/drift.py``, the worker's traced epoch, the launcher's drain) on the
CPU, case for case against the telemetry, traced and drift cases of
``tests/test_obs.py``:

  * the telemetry ring against the port's queue semantics under random
    emit/drain interleavings; the writer drops and counts when full;
    records folded into spans and histograms — and the same rows folded
    by the JAX package give the same events and registry snapshot;
  * a traced 4-worker fleet: per-worker tracks with the full phase
    taxonomy, host traffic bit-identical to an untraced run;
  * a kill drill under the recorder: the respawned incarnation's workers
    trace too, and the incident lands in the timeline;
  * a 2-host fleet: ``connect_s`` apart from the pump's ``wait_fraction``,
    bridge counters in the trace, the follower's workers on their own
    process track (shipped through ``obs_drain``), traffic bit-identical;
  * ``REPRO_TRACE`` arming worker telemetry and exporting at exit;
  * the drift arithmetic, and against ``repro.obs.drift`` on the same
    snapshot.

Workers run with ``device="cpu"``.  Tolerance: bit-exact for traffic,
the drift within 1e-12 relative.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import queue as qmod
from repro_torch.hw.pipestage import make_chain
from repro_torch.obs import drift, report as oreport, schema as oschema, telemetry
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime import ShmRing

from test_torch_bridge import procs
from test_torch_session_surface import io_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def closing():
    sims = []
    yield sims.append
    for sim in sims:
        sim.engine.close()


def _ring(cap, tag):
    return ShmRing.create(f"t_tobs_{os.getpid()}_{tag}", cap, telemetry.TELEM_RECORD_BYTES)


# ------------------------------------- telemetry ring vs queue semantics
@pytest.mark.parametrize("seed", range(6))
def test_telemetry_ring_matches_queue_semantics(seed):
    """Random emit/drain interleavings: the telemetry ring accepts and
    refuses 48-byte records exactly like the port's queue at the same
    capacity, and drained payloads come back FIFO."""
    cap = 4
    rng = np.random.RandomState(seed)
    ring = _ring(cap, f"prop{seed}")
    try:
        q = qmod.make_queues(1, 6, cap)
        expect = []  # FIFO model of what the ring holds
        for i in range(60):
            do_push, do_pop = bool(rng.randint(2)), bool(rng.randint(2))
            assert ring.size() == int(qmod.size(q)[0])
            assert ring.free() == int(qmod.free(q)[0])
            assert ring.empty() == bool(qmod.empty(q)[0])
            assert ring.full() == bool(qmod.full(q)[0])
            if do_pop:
                rec = ring.pop_record()
                _front, tail, valid = qmod.pop_single(q.buf[0], q.head[0], q.tail[0], cap)
                q.tail[0] = tail
                assert (rec is not None) == bool(valid)
                if rec is not None:
                    assert telemetry._PACK.unpack(rec) == expect.pop(0)
            if do_push:
                row = (telemetry.TEV_STEP, float(i), 0.5 * i, 0.001, 0.0, 0.0)
                ok_ring = ring.push_record(telemetry._PACK.pack(*row))
                buf, head, ok = qmod.push_single(q.buf[0], q.head[0], q.tail[0], cap,
                                                 torch.full((6,), float(i)))
                q.buf[0], q.head[0] = buf, head
                assert ok_ring == bool(ok)
                if ok_ring:
                    expect.append(row)
        np.testing.assert_array_equal(telemetry.drain(ring),
                                      np.asarray(expect, np.float64).reshape(-1, 6))
    finally:
        ring.close()


def test_telemetry_writer_drops_when_full():
    cap = 8  # SPSC ring holds cap-1 records
    ring = _ring(cap, "drop")
    try:
        w = telemetry.TelemetryWriter(ring)
        for i in range(cap + 3):
            w.emit(telemetry.TEV_EPOCH, float(i), 0.0, 0.0)
        assert w.emitted == cap - 1
        assert w.dropped == 4
        assert telemetry.drain(ring).shape == (cap - 1, 6)
        assert telemetry.drain(ring).shape == (0, 6)  # drained dry
    finally:
        ring.close()


ROWS = np.asarray([
    [telemetry.TEV_STEP, 32.0, 1.0, 0.010, 0.0, 0.0],
    [telemetry.TEV_ISSUE, 2.0, 1.011, 0.002, 0.0, 0.0],
    [telemetry.TEV_EPOCH, 5.0, 1.0, 0.015, 0.004, 0.0],
    [telemetry.TEV_OCC, 0.0, 1.016, 0.0, 3.0, 2.0],
], np.float64)


def test_records_to_events_folds_spans_and_histograms():
    rec = TraceRecorder()
    rec.enabled = True
    reg = MetricsRegistry()
    n = telemetry.records_to_events(ROWS, worker=3, pid=0, recorder=rec, registry=reg)
    assert n == 4
    assert [(e["name"], e["tid"]) for e in rec.events] == [
        ("step", 3), ("exchange_issue", 3), ("epoch", 3)]
    assert rec.events[0]["args"] == {"cycles": 32}
    assert rec.events[1]["args"] == {"tier": 2}
    assert rec.events[2]["args"] == {"epoch": 5, "wait_s": 0.004}
    snap = reg.snapshot()
    assert snap["procs.phase.step.s"]["count"] == 1
    assert snap["procs.worker.3.epoch.s"]["sum"] == pytest.approx(0.015)
    assert snap["procs.worker.3.wait.s"]["sum"] == pytest.approx(0.004)
    assert snap["procs.ring.occupancy"]["max"] == 3.0


def test_telemetry_matches_jax():
    """The record layout, codes and ring name are the JAX package's; a
    record packed by either unpacks in the other; the same rows folded by
    both give the same events and registry snapshot."""
    from repro.obs import telemetry as jtel
    from repro.obs.registry import MetricsRegistry as JRegistry
    from repro.obs.trace import TraceRecorder as JRecorder

    for name in ("TELEM_RECORD_F64", "TELEM_RECORD_BYTES", "TELEM_RING_RECORDS",
                 "TEV_INGEST", "TEV_STEP", "TEV_ISSUE", "TEV_COMMIT", "TEV_FLUSH",
                 "TEV_EPOCH", "TEV_OCC"):
        assert getattr(telemetry, name) == getattr(jtel, name), name
    assert telemetry.telemetry_ring_name("sbx", 7) == jtel.telemetry_ring_name("sbx", 7)
    row = tuple(ROWS[1])
    assert jtel._PACK.unpack(telemetry._PACK.pack(*row)) == row
    assert telemetry._PACK.unpack(jtel._PACK.pack(*row)) == row
    recs, regs = (TraceRecorder(), JRecorder()), (MetricsRegistry(), JRegistry())
    for r in recs:
        r.enabled = True
    telemetry.records_to_events(ROWS, worker=1, pid=2, recorder=recs[0], registry=regs[0])
    jtel.records_to_events(ROWS, worker=1, pid=2, recorder=recs[1], registry=regs[1])
    assert recs[0].events == recs[1].events
    assert regs[0].snapshot() == regs[1].snapshot()


# ---------------------------------------- tracing is observation-only
def test_procs_trace_per_worker_spans_bit_identical(closing, tmp_path):
    """4-worker fleet: sim.trace() yields a Perfetto-valid timeline with
    one track per worker carrying the full phase taxonomy, while the
    host-visible traffic stays bit-identical to an untraced run."""
    path = str(tmp_path / "procs.json")
    kw = dict(n_workers=4, partition=[0, 1, 2, 3], K=2)
    sim = procs(make_chain(4, capacity=2), closing, **kw)
    sim.reset(0)
    with sim.trace(path):
        got = io_script(sim, n_steps=12)
    st = oschema.validate_stats(sim.stats())
    assert st["metrics"]["procs.phase.epoch.s"]["count"] > 0
    assert sum(r["telem_dropped"] for r in st["workers"]) == 0
    assert not sim.engine._telem_on  # switched off at the window's end
    sim.engine.close()

    doc = oschema.validate_trace_file(path)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["tid"] for e in spans if e.get("cat") == "worker"} == {0, 1, 2, 3}
    names = {e["name"] for e in spans if e.get("cat") == "worker"}
    assert {"ingest", "step", "exchange_issue", "exchange_commit",
            "flush", "epoch"} <= names
    text = oreport.summarize(doc)
    assert "phase breakdown" in text and "straggler" in text

    sim2 = procs(make_chain(4, capacity=2), closing, **kw)
    sim2.reset(0)
    got2 = io_script(sim2, n_steps=12)
    assert len(got) == len(got2)
    for step, (a, b) in enumerate(zip(got, got2)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")


def test_recovery_incident_lands_in_trace(closing, tmp_path):
    """Kill drill under the recorder: the healed fleet's timeline holds
    the recovery_incident instant tagged with the new incarnation, and
    the respawned workers trace too (tracing re-applied by ``launch``)."""
    path = str(tmp_path / "drill.json")
    sim = procs(make_chain(3, capacity=4), closing, n_workers=2, partition=[0, 0, 1],
                K=1, on_fault="recover", snapshot_every=2, backoff_s=0.0,
                fault_plan="kill:1@3")
    sim.reset(0)
    with sim.trace(path):
        io_script(sim, n_steps=8, seed=1)
    assert sim.stats()["faults"]["restarts"] == 1
    doc = oschema.validate_trace_file(path)
    incidents = [e for e in doc["traceEvents"]
                 if e.get("ph") == "i" and e["name"] == "recovery_incident"]
    assert len(incidents) == 1
    assert incidents[0]["args"]["incarnation"] == 1
    assert incidents[0]["args"]["fault"] == "WorkerDiedError"
    t_incident = incidents[0]["ts"]
    after = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "worker" and e["ts"] > t_incident]
    assert {e["tid"] for e in after} == {0, 1}


def test_bridged_fleet_connect_vs_wait(closing, tmp_path):
    """2-host fleet: stats separate the one-time rendezvous cost
    (connect_s) from the steady-state pump wait_fraction, the trace holds
    the bridge counters and the follower's worker on the follower's own
    process track, and traced traffic stays bit-identical."""
    kw = dict(n_workers=2, partition=[0, 0, 1], K=1)
    ref = procs(make_chain(3, capacity=4), closing, **kw)
    ref.reset(0)
    want = io_script(ref, n_steps=8)
    ref.engine.close()

    path = str(tmp_path / "fleet.json")
    sim = procs(make_chain(3, capacity=4), closing, hosts=2, **kw)
    sim.reset(0)
    with sim.trace(path):
        got = io_script(sim, n_steps=8)
    st = oschema.validate_stats(sim.stats())
    assert st["bridges"], "2-host fleet must report bridge rows"
    for row in st["bridges"]:
        assert row["connect_s"] >= 0.0
        assert 0.0 <= row["wait_fraction"] <= 1.0
    assert st["metrics"]["bridge.l0.accept.bytes_tx"] > 0
    doc = oschema.validate_trace_file(path)
    assert any(e["name"] == "bridge_counters" for e in doc["traceEvents"])
    tracks = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "worker"}
    # the leader's worker 0 on its track, h1's worker 1 on the follower's
    # process track (the recorder is process-wide: earlier fleets' tracks
    # stay in it)
    assert (0, 0) in tracks and {t for p, t in tracks if p == 1} == {1}
    for step, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")


def test_repro_trace_env_arms_worker_telemetry(tmp_path):
    """``REPRO_TRACE=<path>``: the session switches the fleet's telemetry
    on, and the export at interpreter exit flushes the workers' rings."""
    path = tmp_path / "env.json"
    script = (
        "from repro_torch.hw.pipestage import make_chain\n"
        "if __name__ == '__main__':\n"
        "    sim = make_chain(3, capacity=4).build(engine='procs', device='cpu',\n"
        "        n_workers=2, partition=[0, 0, 1], K=1, timeout=60.0)\n"
        "    sim.reset(0)\n"
        "    sim.tx('tx').send([1.0, 0.0])\n"
        "    sim.run(epochs=6)\n"
        "    assert sim.engine._telem_on\n"
    )
    env = dict(os.environ, REPRO_TRACE=str(path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(path.read_text())
    epochs = [e for e in doc["traceEvents"] if e.get("name") == "epoch"
              and e.get("cat") == "worker"]
    assert {e["tid"] for e in epochs} == {0, 1}
    assert len(epochs) == 12  # 6 epochs on each worker


# -------------------------------------------------------- perfmodel drift
def _phase_snapshot(step, issue_sum, commit_sum, ingest, flush, epoch,
                    n_epochs=4, n_tiers=2, registry=MetricsRegistry):
    reg = registry()
    for _ in range(n_epochs):
        reg.observe("procs.phase.step.s", step)
        reg.observe("procs.phase.ingest.s", ingest)
        reg.observe("procs.phase.flush.s", flush)
        reg.observe("procs.phase.epoch.s", epoch)
        for _ in range(n_tiers):
            reg.observe("procs.phase.exchange_issue.s", issue_sum / (n_epochs * n_tiers))
            reg.observe("procs.phase.exchange_commit.s", commit_sum / (n_epochs * n_tiers))
    return reg.snapshot()


def test_compute_drift_serial_arithmetic():
    snap = _phase_snapshot(step=0.010, issue_sum=0.008, commit_sum=0.004,
                           ingest=0.001, flush=0.0005, epoch=0.016)
    reg = MetricsRegistry()
    out = drift.compute_drift(snap, overlap=False, registry=reg)
    assert out["t_step"] == pytest.approx(0.010)
    # comm phases divide their sample SUM by epochs (one sample per
    # tier*epoch), so 8 issue + 8 commit samples fold to per-epoch cost
    assert out["t_comm"] == pytest.approx((0.008 + 0.004) / 4)
    assert out["t_residual"] == pytest.approx(0.0015)
    assert out["predicted_s"] == pytest.approx(0.010 + 0.003 + 0.0015)
    assert out["model_drift"] == pytest.approx(abs(0.016 - 0.0145) / 0.016)
    assert reg.snapshot()["perfmodel.model_drift"] == pytest.approx(out["model_drift"])


def test_compute_drift_overlap_and_empty():
    assert drift.compute_drift({}) == {}
    snap = _phase_snapshot(step=0.010, issue_sum=0.008, commit_sum=0.004,
                           ingest=0.0, flush=0.0, epoch=0.012)
    out = drift.compute_drift(snap, overlap=True)
    assert out["predicted_s"] == pytest.approx(max(0.010, 0.003))


@pytest.mark.parametrize("overlap", [False, True])
def test_drift_matches_jax(overlap):
    """``phase_means`` and ``compute_drift`` give the JAX package's numbers
    on the same snapshot, and publish the same gauges."""
    from repro.obs import drift as jdrift
    from repro.obs.registry import MetricsRegistry as JRegistry

    snap = _phase_snapshot(step=0.0123, issue_sum=0.0071, commit_sum=0.0049,
                           ingest=0.0007, flush=0.0003, epoch=0.0191, n_epochs=5,
                           n_tiers=3)
    assert drift.phase_means(snap) == pytest.approx(jdrift.phase_means(snap), rel=1e-12)
    regs = MetricsRegistry(), JRegistry()
    got = drift.compute_drift(snap, overlap=overlap, registry=regs[0])
    want = jdrift.compute_drift(snap, overlap=overlap, registry=regs[1])
    assert got == pytest.approx(want, rel=1e-12)
    assert regs[0].snapshot() == pytest.approx(regs[1].snapshot(), rel=1e-12)
