"""The session's spans (``repro_torch.obs.trace``) on the CPU: one run's
``session.reset`` (``init.state``, ``init.tables``) -> ``session.until``
-> ``session.read`` nest on the session's track and share their ``run``;
the recorder maps its clock onto ``torch.profiler``'s; no span waits for
the device; the until-loop names the cause of a capture; the idle time of
a device trace is put down to the spans (``obs.report.idle_split``).
This file imports no JAX."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ChannelGraph, Simulation, device_loop
from repro_torch.core import tiered_grid_partition as tgp
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.systolic import SystolicCell, make_cell_params
from repro_torch.kernels import fused_checks as fc
from repro_torch.obs import report
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.registry import REGISTRY

M, R, C = 6, 4, 4
CHAINS = ("wafer-fused", "wafer-graph", "grid-fused", "register")


def _chain(config):
    """(session, predicate, result read) of a small engine on the CPU."""
    rng = np.random.RandomState(3)
    if config.startswith("wafer"):
        graph = ChannelGraph.torus(ManycoreCell(8, 8), 8, 8,
                                   params=make_core_params(fc.torus_values(8, 8)),
                                   capacity=8)
        cls = FusedEngine if config == "wafer-fused" else GraphEngine
        eng = cls(graph, tgp(8, 8, [(2, 1), (2, 2)]), None,
                  tiers=[(("pod",), 2), (("g",), 4)],
                  batch_axes={"pod": 2, "g": 4}, device="cpu")
        return (Simulation(eng), lambda s: allreduce_done(s.block_states[0]),
                lambda sim: eng.gather_group(sim.state, 0))
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    if config == "grid-fused":
        eng = FusedEngine.grid(SystolicCell(m_stream=M), R, C, K=2,
                               params=make_cell_params(A, B), device="cpu")
        return (Simulation(eng), fc.network_done(eng),
                lambda sim: fc.grid_result(eng, sim.state, 0, R, C, M))
    graph = ChannelGraph.grid(SystolicCell(m_stream=M), R, C, params=make_cell_params(A, B))
    eng = RegisterGridEngine.from_graph(graph, K=2, device="cpu")
    return Simulation(eng), eng.y_done, lambda sim: eng.result(sim.state)


@pytest.fixture
def rec():
    r = obs_trace.recorder()
    was = r.enabled
    r.clear()
    r.enable()
    yield r
    r.disable()
    r.clear()
    if was:
        r.enable()


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("config", CHAINS)
def test_session_spans_nest_and_share_run(config, rec):
    """reset -> run(until=...) -> the result read: the spans of each run
    are on the session's track, carry that run's number, and nest as
    ``obs.trace`` lists them; ``session.until`` counts the loop's epochs."""
    sim, done, read = _chain(config)
    runs, epochs = [], {}
    for _ in range(2):
        sim.reset(0)
        runs.append(rec.run)
        sim.run(until=done, max_epochs=200)
        epochs[rec.run] = sim.epoch
        read(sim)
    evs = [e for e in rec.events if e["ph"] == "X"]
    assert all(e["tid"] == obs_trace.TID_SESSION and e["cat"] == "session" for e in evs)
    assert runs[1] == runs[0] + 1
    init = () if config == "register" else ("init.state", "init.tables")
    for run in runs:
        mine = {e["name"]: e for e in evs if e["args"]["run"] == run}
        assert sorted(mine) == sorted(("session.reset", "session.until",
                                       "session.read") + init)
        for name in init:
            assert _inside(mine[name], mine["session.reset"]), name
        reset, until, read_ = (mine[k] for k in ("session.reset", "session.until",
                                                 "session.read"))
        assert reset["ts"] + reset["dur"] <= until["ts"]
        assert until["ts"] + until["dur"] <= read_["ts"]
        assert until["args"]["epochs"] == epochs[run] > 0
        want = {"wafer-fused": "gather_group", "wafer-graph": "gather_group",
                "grid-fused": "grid_result", "register": "result"}[config]
        assert read_["args"]["api"] == want
    if config == "wafer-fused":
        assert mine["init.state"]["ts"] + mine["init.state"]["dur"] <= mine["init.tables"]["ts"]


def test_recorder_off_records_nothing_and_counts_runs():
    r = obs_trace.recorder()
    assert not r.enabled
    sim, done, read = _chain("wafer-fused")
    n0, run0 = len(r.events), r.run
    sim.reset(0)
    sim.run(until=done, max_epochs=200)
    read(sim)
    assert len(r.events) == n0 and r.run == run0 + 1


def test_spans_do_not_wait_for_the_device(monkeypatch, rec, tmp_path):
    """No span synchronizes: a traced run, ``epoch_window`` spans included,
    never calls ``torch.cuda.synchronize`` or ``block_until_ready``."""
    def refuse(*a, **k):
        raise AssertionError("a span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(Simulation, "block_until_ready", refuse)
    sim, done, read = _chain("wafer-fused")
    with sim.trace(str(tmp_path / "t.json")):
        sim.reset(0)
        sim.run(epochs=2)
        sim.add_monitor(lambda s: None, every=1)
        sim.run(until=done, max_epochs=200)
        read(sim)
    names = {e["name"] for e in rec.events}
    assert {"epoch_window", "session.reset", "session.until", "session.read"} <= names
    snap = REGISTRY.snapshot()
    assert "session.epochs" not in snap and "session.cycles" not in snap


def test_report_counts_nested_spans_once(tmp_path):
    """``obs.report.summarize`` on a trace of reset -> run(until=...) with a
    monitor (its ``epoch_window`` spans over ``session.until``) -> read:
    the session track's busy time is its spans' self time, no more than
    the track's wall, and the phase breakdown adds up to it."""
    sim, done, read = _chain("wafer-fused")
    path = str(tmp_path / "t.json")
    with sim.trace(path):
        sim.add_monitor(lambda s: None, every=4)
        for _ in range(2):
            sim.reset(0)
            sim.run(until=done, max_epochs=200)
            read(sim)
    doc = report.load(path)
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["tid"] == obs_trace.TID_SESSION]
    names = {e["name"] for e in spans}
    assert {"epoch_window", "session.reset", "init.state", "session.until"} <= names
    self_s = report._self_seconds(spans)
    wall_s = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans)) / 1e6
    assert min(self_s) >= -1e-9
    assert sum(self_s) <= wall_s + 1e-9
    outer = [e for e in spans if not any(
        o is not e and _inside(e, o) and (o["ts"], -o["dur"]) < (e["ts"], -e["dur"])
        for o in spans)]
    assert sum(self_s) == pytest.approx(sum(e["dur"] for e in outer) / 1e6)
    text = report.summarize(doc)
    rows = text.split("straggler ranking")[1].split("top stalls")[0].splitlines()[1:]
    busy = [float(r.split()[-1].rstrip("s")) for r in rows if r.strip()]
    assert len(busy) == 1 and busy[0] <= wall_s + 1e-4
    phases = text.split("phase breakdown")[1].split("straggler")[0].splitlines()[1:]
    total = sum(float(r.split()[1].rstrip("s")) for r in phases if r.strip())
    assert total == pytest.approx(sum(self_s), abs=1e-3)


def test_span_on_the_profiler_clock(rec):
    """A recorder span taken around a ``record_function`` range holds that
    range once mapped onto the profiler's clock, within 0.2 ms each end."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for _ in range(3):
            with rec.session_span("outer"):
                with record_function("inner"):
                    time.sleep(0.005)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "inner")
    spans = sorted((s["lo_ns"], s["hi_ns"]) for s in rec.profiler_spans()
                   if s["name"] == "outer")
    assert len(ranges) == len(spans) == 3
    for (lo, hi), (a, b) in zip(ranges, spans):
        assert a - 200_000 <= lo and hi <= b + 200_000, (lo - a, b - hi)
        assert b - a >= 5_000_000


def test_to_profiler_ns_interpolates_between_anchors():
    r = obs_trace.TraceRecorder()
    r.anchors = [(1_000, 5_000), (2_000, 6_100), (3_000, 7_100)]
    assert r.to_profiler_ns(1_000) == 5_000
    assert r.to_profiler_ns(1_500) == 5_550  # the offset moves 4000 -> 4100
    assert r.to_profiler_ns(2_500) == 6_600
    assert r.to_profiler_ns(500) == 4_500  # before the first: its offset
    assert r.to_profiler_ns(4_000) == 8_100  # after the last: its offset
    m, p = obs_trace.anchor_pair()
    assert abs(p - time.time_ns()) < 50_000_000 and abs(m - time.monotonic_ns()) < 50_000_000


def test_export_carries_the_clock(tmp_path):
    r = obs_trace.TraceRecorder()
    r.enable()
    with r.session_span("x"):
        pass
    r.disable()
    doc = r.to_dict()
    clock = doc["otherData"]["clock"]
    assert len(clock["anchors"]) == 3 and "time.time_ns" in clock["profiler"]
    (m0, p0), (m1, p1) = clock["anchors"][0], clock["anchors"][-1]
    assert m1 >= m0 and abs((p1 - m1) - (p0 - m0)) < 50_000_000
    r.max_events = 0
    for _ in range(obs_trace.MAX_ANCHORS + 5):
        r.anchor()
    assert len(r.anchors) == obs_trace.MAX_ANCHORS and r.anchors[0] == (m0, p0)


def test_capture_cause():
    ptrs = ((1, (2,), torch.float32),)
    entry = device_loop._Captured(None, None, None, None, None, ptrs, [])
    assert device_loop.capture_cause(None, ptrs) == "first"
    assert device_loop.capture_cause(entry, ptrs) is None
    assert device_loop.capture_cause(entry, ((9, (2,), torch.float32),)) == "moved"
    assert device_loop.capture_cause(entry, ((1, (3,), torch.float32),)) == "moved"


def test_idle_split_known_gaps():
    """A synthetic window of 100 units: device work 0-10, 30-40, 70-75 and
    90-95 (30 busy, 70 idle); a reset 0-20, an until-loop 20-80 with a
    capture 40-60 inside, a read 80-92.  Each idle stretch goes to the
    first span that holds it, the rest to ``other``."""
    device = [(0, 10), (30, 40), (32, 38), (70, 75), (90, 95)]
    spans = {"session.reset": [(0, 20)], "session.until": [(20, 80)],
             "until.capture": [(40, 60)], "session.read": [(80, 92)]}
    got = report.idle_split(device, spans, (0, 100))
    assert got == {"window": 100.0, "busy": 30.0, "idle": 70.0,
                   "until.capture": 20.0, "session.until": 10.0 + 10.0 + 5.0,
                   "session.reset": 10.0, "session.read": 10.0, "other": 5.0}
    parts = sum(got[k] for k in report.IDLE_ORDER) + got["other"]
    assert parts == got["idle"]
    # the window clips both device work and spans; no spans: all other
    assert report.idle_split(device, {}, (5, 35)) == {
        "window": 30.0, "busy": 10.0, "idle": 20.0, "until.capture": 0.0,
        "session.until": 0.0, "session.reset": 0.0, "session.read": 0.0, "other": 20.0}


@pytest.mark.cuda
def test_card_events_on_the_recorder_clock(rec):
    """On the card the profiler stamps CUDA kernels on the same clock: a
    kernel launched and waited for inside a recorder span lies inside the
    span once mapped (0.2 ms each end)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with rec.session_span("outer"):
                x.mul_(1.0001)
                torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA" and "mul" in e.name().lower())
    spans = sorted((s["lo_ns"], s["hi_ns"]) for s in rec.profiler_spans()
                   if s["name"] == "outer")
    assert len(kernels) == len(spans) == 3
    for (lo, hi), (a, b) in zip(kernels, spans):
        assert a - 200_000 <= lo and hi <= b + 200_000, (lo - a, b - hi)
