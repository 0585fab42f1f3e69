"""Structured trace layer: bounded span/instant buffers + Perfetto export
(the port's copy of ``repro.obs.trace``).

Events follow the Chrome trace-event JSON format (loadable in Perfetto /
``chrome://tracing``): ``ph="X"`` complete spans with microsecond
``ts``/``dur``, ``ph="i"`` instants, ``ph="M"`` track-naming metadata.
``pid`` groups a host process and ``tid`` is a member of it
(``TID_SESSION`` for the session's own track).

Timestamps are ``time.monotonic()`` microseconds (CLOCK_MONOTONIC is
system-wide on Linux, so spans from several processes share a timeline).
A span the session records on a CUDA state ends after the stream has
finished the window's work (``Simulation._advance_epochs``), so its
duration covers the device work, not only the launches.

The recorder is process-global and bounded: past ``max_events`` new
events are dropped and counted (``trace.dropped`` in the export), never
grown.  When disabled (default) ``span``/``instant`` return after one
flag check.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import time

ENV_TRACE = "REPRO_TRACE"

#: tid of the launcher/session track within a host pid.
TID_SESSION = 1000


class TraceRecorder:
    """Bounded in-memory event buffer, Chrome-trace-format export."""

    def __init__(self, max_events: int = 400_000):
        self.enabled = False
        self.max_events = int(max_events)
        self.events: list[dict] = []
        self.dropped = 0
        self._tracks: dict[tuple[int, int], str] = {}
        self._procs: dict[int, str] = {}

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
        """Time the body as one span (no-op when disabled)."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.span(name, t0, time.monotonic() - t0, pid=pid, tid=tid,
                      cat=cat, args=args)

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
            "otherData": {"recorder": "repro_torch.obs", "dropped": self.dropped},
        }

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
        _RECORDER.enabled = True
        atexit.register(_atexit_export)
    return _RECORDER.enabled


__all__ = ["ENV_TRACE", "TID_SESSION", "TraceRecorder", "enabled", "instant",
           "maybe_enable_from_env", "recorder", "span"]
