"""Structured trace layer: bounded span/instant buffers + Perfetto export
(the port's copy of ``repro.obs.trace``).

Events follow the Chrome trace-event JSON format (loadable in Perfetto /
``chrome://tracing``): ``ph="X"`` complete spans with microsecond
``ts``/``dur``, ``ph="i"`` instants, ``ph="M"`` track-naming metadata.
``pid`` groups a host process and ``tid`` is a member of it
(``TID_SESSION`` for the session's own track).

**Clocks.**  Timestamps are ``time.monotonic()`` microseconds
(CLOCK_MONOTONIC is system-wide on Linux, so spans from several processes,
the procs workers' telemetry among them, share a timeline).
``torch.profiler`` stamps its kineto events (``KinetoEvent.start_ns()``,
host ranges and CUDA kernels alike) on the Unix-epoch clock,
``time.time_ns()`` (:func:`profiler_ns`): PyTorch converts its
approximate clock, and CUPTI's timestamps through the same callback, to
Unix time.  The recorder keeps anchor pairs of the two clocks (one when
it is enabled or disabled, one when it is read or exported), and
:meth:`TraceRecorder.to_profiler_ns` maps a monotonic time onto the
profiler's clock through them; an exported trace carries the anchors
under ``otherData.clock``.  So a span can be laid against the device
trace of the same window: device time comes from there, and no span
synchronizes with the card.  A span's start and end are the host's
times when the call starts and returns.

**Session spans** (:meth:`TraceRecorder.session_span`) carry
``args.run``, the count of ``Simulation.reset`` calls in the process
(``TraceRecorder.run``), which the spans of one run share, and
nest on ``TID_SESSION``: ``session.reset`` (``init.state``,
``init.tables`` inside, in the fused and graph engines, which build the
two apart), ``session.until`` (``until.capture`` inside, its
``cause`` ``first`` or ``moved``) and ``session.read``.

The recorder is process-global and bounded: past ``max_events`` new
events are dropped and counted (``trace.dropped`` in the export), never
grown.  When disabled (default) ``span``/``instant`` return after one
flag check.
"""
from __future__ import annotations

import atexit
import bisect
import contextlib
import json
import os
import time

ENV_TRACE = "REPRO_TRACE"

#: tid of the launcher/session track within a host pid.
TID_SESSION = 1000
#: Anchor pairs a recorder keeps (the first and the newest).
MAX_ANCHORS = 64


def profiler_ns() -> int:
    """Now on the clock of ``torch.profiler``'s kineto events: Unix-epoch
    nanoseconds."""
    return time.time_ns()


def anchor_pair() -> tuple[int, int]:
    """(``time.monotonic_ns()``, :func:`profiler_ns`) read as one instant:
    of three tries, the one whose two monotonic reads bracket the profiler
    read most tightly, stamped at their midpoint."""
    best = None
    for _ in range(3):
        a = time.monotonic_ns()
        p = profiler_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, p)
    return best[1], best[2]


class TraceRecorder:
    """Bounded in-memory event buffer, Chrome-trace-format export."""

    def __init__(self, max_events: int = 400_000):
        self.enabled = False
        self.max_events = int(max_events)
        self.events: list[dict] = []
        self.dropped = 0
        self._tracks: dict[tuple[int, int], str] = {}
        self._procs: dict[int, str] = {}
        #: (monotonic ns, profiler ns) pairs, in the order taken
        self.anchors: list[tuple[int, int]] = []
        #: ``Simulation.reset`` calls so far: the ``run`` of a session span
        self.run = 0

    # ---------------------------------------------------------------- clock
    def enable(self) -> None:
        self.enabled = True
        self.anchor()

    def disable(self) -> None:
        if self.enabled:
            self.anchor()
        self.enabled = False

    def anchor(self) -> None:
        """Record one anchor pair of the two clocks."""
        if len(self.anchors) >= MAX_ANCHORS:
            del self.anchors[1]
        self.anchors.append(anchor_pair())

    def to_profiler_ns(self, mono_ns: float) -> int:
        """``mono_ns`` (``time.monotonic_ns()``) on the profiler's clock:
        the offset between the clocks interpolated linearly between the
        two anchors around ``mono_ns``, and the nearest anchor's outside
        them.  Takes an anchor where the recorder has none."""
        if not self.anchors:
            self.anchor()
        pts = self.anchors  # taken in order: monotonic times ascend
        i = bisect.bisect_right(pts, (mono_ns, float("inf")))
        if i == 0 or i == len(pts):
            m, p = pts[0] if i == 0 else pts[-1]
            return int(round(mono_ns + (p - m)))
        (m0, p0), (m1, p1) = pts[i - 1], pts[i]
        off0, off1 = p0 - m0, p1 - m1
        w = (mono_ns - m0) / (m1 - m0) if m1 > m0 else 0.0
        return int(round(mono_ns + off0 + w * (off1 - off0)))

    # ------------------------------------------------------------ recording
    def _append(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def set_process(self, pid: int, name: str) -> None:
        self._procs[int(pid)] = str(name)

    def set_track(self, pid: int, tid: int, name: str) -> None:
        self._tracks[(int(pid), int(tid))] = str(name)

    def span(self, name: str, t0: float, dur: float, *, pid: int = 0,
             tid: int = TID_SESSION, cat: str = "sim",
             args: dict | None = None) -> None:
        """One complete span; ``t0`` is monotonic seconds, ``dur`` seconds."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": t0 * 1e6, "dur": max(dur, 0.0) * 1e6,
              "pid": int(pid), "tid": int(tid)}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, *, pid: int = 0, tid: int = TID_SESSION,
                cat: str = "sim", args: dict | None = None,
                ts: float | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
              "ts": (time.monotonic() if ts is None else ts) * 1e6,
              "pid": int(pid), "tid": int(tid)}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span_ctx(self, name: str, *, pid: int = 0, tid: int = TID_SESSION,
                 cat: str = "sim", args: dict | None = None):
        """Time the body as one span (no-op when disabled); yields
        ``args``, which the body may fill."""
        if not self.enabled:
            yield args
            return
        t0 = time.monotonic()
        try:
            yield args
        finally:
            self.span(name, t0, time.monotonic() - t0, pid=pid, tid=tid,
                      cat=cat, args=args)

    def session_span(self, name: str, **args):
        """:meth:`span_ctx` on ``TID_SESSION``, category ``session``, its
        args ``run`` and ``args``; the body may fill the dict it yields."""
        return self.span_ctx(name, cat="session", args={"run": self.run, **args})

    def profiler_spans(self) -> list[dict]:
        """The complete spans of ``TID_SESSION`` on the profiler's clock:
        ``{"name", "lo_ns", "hi_ns", "args"}`` each, after one anchor."""
        self.anchor()
        out = []
        for ev in self.events:
            if ev["ph"] != "X" or ev["tid"] != TID_SESSION:
                continue
            lo = ev["ts"] * 1e3
            out.append({"name": ev["name"], "lo_ns": self.to_profiler_ns(lo),
                        "hi_ns": self.to_profiler_ns(lo + ev["dur"] * 1e3),
                        "args": ev.get("args", {})})
        return out

    # -------------------------------------------------------------- export
    def to_dict(self) -> dict:
        meta: list[dict] = []
        for pid, name in sorted(self._procs.items()):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(self._tracks.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {
            "traceEvents": meta + self.events,
            "displayTimeUnit": "ms",
            "otherData": {"recorder": "repro_torch.obs", "dropped": self.dropped,
                          "clock": self._clock()},
        }

    def _clock(self) -> dict:
        self.anchor()
        return {"ts": "time.monotonic() us",
                "profiler": "time.time_ns(), the clock of torch.profiler's events",
                "anchors": [list(a) for a in self.anchors]}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")
        return path

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._tracks.clear()
        self._procs.clear()
        self.anchors.clear()
        if self.enabled:
            self.anchor()


_RECORDER = TraceRecorder()
_env_armed = False


def recorder() -> TraceRecorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def span(name: str, t0: float, dur: float, **kw) -> None:
    _RECORDER.span(name, t0, dur, **kw)


def instant(name: str, **kw) -> None:
    _RECORDER.instant(name, **kw)


def _flush_engines() -> None:
    """Pull any undrained worker telemetry into the recorder before an
    export (live procs engines hold it in their shm rings)."""
    import sys

    launcher = sys.modules.get("repro_torch.runtime.launcher")
    if launcher is None:  # no procs engine was ever built here
        return
    for eng in list(launcher._live_engines):
        try:
            eng.flush_telemetry()
        except Exception:  # noqa: BLE001 - the export stays best-effort
            pass


def _atexit_export() -> None:  # pragma: no cover - interpreter exit
    path = os.environ.get(ENV_TRACE)
    if path and _RECORDER.enabled:
        _flush_engines()
    if path and _RECORDER.enabled and (_RECORDER.events or _RECORDER._tracks):
        _RECORDER.export(path)


def maybe_enable_from_env() -> bool:
    """Arm the recorder from ``REPRO_TRACE=<path>`` (idempotent): enable
    now, export to the named path at interpreter exit.  Returns whether
    tracing is enabled after the call."""
    global _env_armed
    path = os.environ.get(ENV_TRACE)
    if path and not _env_armed:
        _env_armed = True
        _RECORDER.enable()
        atexit.register(_atexit_export)
    return _RECORDER.enabled


__all__ = ["ENV_TRACE", "MAX_ANCHORS", "TID_SESSION", "TraceRecorder", "anchor_pair",
           "enabled", "instant", "maybe_enable_from_env", "profiler_ns", "recorder",
           "span"]
