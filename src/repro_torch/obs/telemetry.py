"""Per-worker shm telemetry ring: fixed-size phase records, as in
``repro.obs.telemetry`` (the same 48-byte record, codes and ring name).

Each procs worker gets ONE extra SPSC ring (``{prefix}t{w}``, same
``runtime/shmem.py`` machinery as the data/credit rings — those stay
untouched).  The worker is the producer: every traced phase emits one
48-byte record, non-blocking — when the launcher falls behind and the
ring fills, records are *dropped and counted*, never awaited, so
telemetry can never deadlock or slow the simulation beyond the push.
The launcher is the consumer: it drains at command boundaries and from
the monitor thread while the fleet free-runs.

Record layout (6 little-endian f64, ``TELEM_RECORD_BYTES`` = 48)::

    [code, arg, ts, dur, v0, v1]

``ts`` is ``time.monotonic()`` seconds at phase start (CLOCK_MONOTONIC
is system-wide on Linux, so worker records align with launcher spans),
``dur`` is the phase wall time in seconds.  ``arg`` and ``v0``/``v1``
are per-code (see the ``TEV_*`` table below).  A worker on the card ends
each traced phase with a synchronize of its stream (``Worker.
_traced_epoch``), so ``dur`` covers the device work the phase launched,
not only the launches: a cycle-graph replay returns before the card has
run it.
"""
from __future__ import annotations

import struct
import time

import numpy as np

TELEM_RECORD_F64 = 6
TELEM_RECORD_BYTES = TELEM_RECORD_F64 * 8
#: default ring capacity in records (the SPSC ring holds capacity-1).
TELEM_RING_RECORDS = 4096

_PACK = struct.Struct("<6d")

# Event codes.  arg / v0 / v1 meanings:
TEV_INGEST = 1.0   # ext-port ingest; arg unused
TEV_STEP = 2.0     # compiled step; arg = cycles advanced
TEV_ISSUE = 3.0    # exchange issue (credit wait + pack + push); arg = tier
TEV_COMMIT = 4.0   # exchange commit (slab wait + unpack); arg = tier
TEV_FLUSH = 5.0    # ext-port flush; arg unused
TEV_EPOCH = 6.0    # whole epoch; arg = epoch index, v0 = wait_s delta
TEV_OCC = 7.0      # occupancy sample; v0 = data-ring size sum, v1 = chans

_NAMES = {
    TEV_INGEST: "ingest",
    TEV_STEP: "step",
    TEV_ISSUE: "exchange_issue",
    TEV_COMMIT: "exchange_commit",
    TEV_FLUSH: "flush",
    TEV_EPOCH: "epoch",
    TEV_OCC: "occupancy",
}

#: codes rendered as spans (the rest become counters/instants).
_SPAN_CODES = (TEV_INGEST, TEV_STEP, TEV_ISSUE, TEV_COMMIT, TEV_FLUSH,
               TEV_EPOCH)


def telemetry_ring_name(prefix: str, worker: int) -> str:
    """Ring name for worker ``worker`` under launcher prefix ``prefix``
    (sits beside ``{prefix}d{c}`` / ``{prefix}c{c}`` / ``{prefix}hb``)."""
    return f"{prefix}t{worker}"


def code_name(code: float) -> str:
    return _NAMES.get(float(code), f"tev_{int(code)}")


class TelemetryWriter:
    """Producer side: non-blocking emit into the worker's shm ring."""

    __slots__ = ("ring", "enabled", "dropped", "emitted")

    def __init__(self, ring):
        self.ring = ring
        self.enabled = False
        self.dropped = 0
        self.emitted = 0

    def emit(self, code: float, arg: float, ts: float, dur: float,
             v0: float = 0.0, v1: float = 0.0) -> None:
        if not self.ring.push_record(_PACK.pack(code, arg, ts, dur, v0, v1)):
            self.dropped += 1
        else:
            self.emitted += 1

    def phase(self, code: float, arg: float, t0: float,
              v0: float = 0.0, v1: float = 0.0) -> None:
        """Emit a span record for a phase that started at ``t0``."""
        self.emit(code, arg, t0, time.monotonic() - t0, v0, v1)


def drain(ring, max_records: int = 1 << 20) -> np.ndarray:
    """Consumer side: pop every pending record, return an ``(n, 6)``
    float64 array (columns ``code, arg, ts, dur, v0, v1``)."""
    rows = []
    for _ in range(max_records):
        rec = ring.pop_record()
        if rec is None:
            break
        rows.append(_PACK.unpack(rec))
    if not rows:
        return np.empty((0, TELEM_RECORD_F64), dtype=np.float64)
    return np.asarray(rows, dtype=np.float64)


def records_to_events(records: np.ndarray, *, worker: int, pid: int = 0,
                      recorder=None, registry=None,
                      prefix: str = "procs") -> int:
    """Fold drained records into the trace recorder (one span per phase
    record, track ``tid=worker``) and the metrics registry (per-phase
    histograms ``{prefix}.phase.<name>.s`` plus per-worker wait/epoch
    tallies).  Returns the number of records consumed."""
    n = int(records.shape[0])
    if n == 0:
        return 0
    rec_spans = recorder is not None and recorder.enabled
    for i in range(n):
        code, arg, ts, dur, v0, v1 = records[i]
        name = code_name(code)
        if registry is not None and registry.enabled:
            if code == TEV_OCC:
                registry.observe(f"{prefix}.ring.occupancy", v0)
            else:
                registry.observe(f"{prefix}.phase.{name}.s", dur)
                if code == TEV_EPOCH:
                    registry.observe(f"{prefix}.worker.{worker}.epoch.s", dur)
                    registry.observe(f"{prefix}.worker.{worker}.wait.s", v0)
        if rec_spans and code in _SPAN_CODES:
            args = None
            if code in (TEV_ISSUE, TEV_COMMIT):
                args = {"tier": int(arg)}
            elif code == TEV_STEP:
                args = {"cycles": int(arg)}
            elif code == TEV_EPOCH:
                args = {"epoch": int(arg), "wait_s": float(v0)}
            recorder.span(name, float(ts), float(dur), pid=pid, tid=worker,
                          cat="worker", args=args)
    return n


__all__ = [
    "TELEM_RECORD_BYTES", "TELEM_RECORD_F64", "TELEM_RING_RECORDS",
    "TEV_COMMIT", "TEV_EPOCH", "TEV_FLUSH", "TEV_INGEST", "TEV_ISSUE",
    "TEV_OCC", "TEV_STEP", "TelemetryWriter", "code_name", "drain",
    "records_to_events", "telemetry_ring_name",
]
