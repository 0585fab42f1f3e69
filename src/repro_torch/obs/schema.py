"""The ONE ``Simulation.stats()`` schema + Perfetto trace validator (a
copy of ``repro.obs.schema``).

Every engine family returns the same top-level stats layout
(``repro-stats-v1``) so a consumer can switch engines, or packages,
without code changes.  The engine set is the reference's, ``procs``
included, so one document validates under both packages:

    schema   "repro-stats-v1"
    engine   "single" | "graph" | "fused" | "register" | "procs"
    cycle    int
    epoch    int
    ports    {"tx": {port: {sent,pending,occupancy,credit}},
              "rx": {port: {received,occupancy,credit}}}
    detail   optional engine-specific extras (e.g. single's
             push_count/pop_count arrays) — the ONLY place engines may
             diverge
    metrics  optional registry snapshot ({dotted-name: number|summary})
    faults   optional fault/recovery stats dict
    bridges  optional list of bridge stat rows
    workers  optional list of per-worker stat rows (procs)

CLI::

    python -m repro_torch.obs.schema trace.json      # validate a trace file
"""
from __future__ import annotations

import json
import numbers
import sys

STATS_SCHEMA = "repro-stats-v1"

_ENGINES = {"single", "graph", "fused", "register", "procs"}
_TOP_REQUIRED = {"schema", "engine", "cycle", "epoch", "ports"}
_TOP_OPTIONAL = {"detail", "metrics", "faults", "bridges", "workers"}
_TX_KEYS = {"sent", "pending", "occupancy", "credit"}
_RX_KEYS = {"received", "occupancy", "credit"}

_BRIDGE_REQUIRED = {"link", "bytes_tx", "bytes_rx", "wait_fraction",
                    "connect_s"}

_PH_ALLOWED = {"X", "i", "M", "C"}


def _fail(msg: str) -> None:
    raise ValueError(f"stats schema: {msg}")


def validate_stats(stats: dict) -> dict:
    """Assert ``stats`` conforms to ``repro-stats-v1``; returns it."""
    if not isinstance(stats, dict):
        _fail(f"expected dict, got {type(stats).__name__}")
    keys = set(stats)
    missing = _TOP_REQUIRED - keys
    if missing:
        _fail(f"missing keys {sorted(missing)}")
    extra = keys - _TOP_REQUIRED - _TOP_OPTIONAL
    if extra:
        _fail(f"unknown top-level keys {sorted(extra)}")
    if stats["schema"] != STATS_SCHEMA:
        _fail(f"schema {stats['schema']!r} != {STATS_SCHEMA!r}")
    if stats["engine"] not in _ENGINES:
        _fail(f"unknown engine {stats['engine']!r}")
    for k in ("cycle", "epoch"):
        if not isinstance(stats[k], numbers.Integral):
            _fail(f"{k} must be an int, got {type(stats[k]).__name__}")
    ports = stats["ports"]
    if not isinstance(ports, dict):
        _fail("ports must be a dict")
    if set(ports) != {"tx", "rx"}:
        _fail(f"ports keys {sorted(ports)} != ['rx', 'tx']")
    for direction, want in (("tx", _TX_KEYS), ("rx", _RX_KEYS)):
        side = ports[direction]
        if not isinstance(side, dict):
            _fail(f"ports[{direction!r}] must be a dict of port rows")
        for port, rec in side.items():
            if set(rec) != want:
                _fail(f"ports[{direction!r}][{port!r}] keys "
                      f"{sorted(rec)} != {sorted(want)}")
    if "metrics" in stats and not isinstance(stats["metrics"], dict):
        _fail("metrics must be a dict snapshot")
    if "bridges" in stats:
        rows = stats["bridges"]
        if not isinstance(rows, list):
            _fail("bridges must be a list of rows")
        for row in rows:
            missing = _BRIDGE_REQUIRED - set(row)
            if missing:
                _fail(f"bridge row missing {sorted(missing)}")
    if "workers" in stats and not isinstance(stats["workers"], list):
        _fail("workers must be a list of rows")
    return stats


def _tfail(msg: str) -> None:
    raise ValueError(f"trace format: {msg}")


def validate_trace(doc: dict) -> dict:
    """Assert ``doc`` is a Perfetto/Chrome-loadable trace document
    (the JSON object format with a ``traceEvents`` array)."""
    if not isinstance(doc, dict):
        _tfail(f"expected JSON object, got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        _tfail("missing traceEvents array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _tfail(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in _PH_ALLOWED:
            _tfail(f"event {i} has ph {ph!r} (allowed {sorted(_PH_ALLOWED)})")
        if not isinstance(ev.get("name"), str):
            _tfail(f"event {i} missing string name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), numbers.Integral):
                _tfail(f"event {i} missing integer {k}")
        if ph == "M":
            args = ev.get("args")
            if not (isinstance(args, dict) and isinstance(args.get("name"),
                                                         str)):
                _tfail(f"metadata event {i} missing args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, numbers.Real) or ts < 0:
            _tfail(f"event {i} has bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, numbers.Real) or dur < 0:
                _tfail(f"span event {i} has bad dur {dur!r}")
    return doc


def validate_trace_file(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return validate_trace(doc)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.obs.schema TRACE.json [...]",
              file=sys.stderr)
        return 2
    for path in argv:
        doc = validate_trace_file(path)
        events = doc["traceEvents"]
        spans = sum(1 for e in events if e.get("ph") == "X")
        instants = sum(1 for e in events if e.get("ph") == "i")
        tracks = {(e.get("pid"), e.get("tid")) for e in events
                  if e.get("ph") != "M"}
        print(f"{path}: ok — {len(events)} events "
              f"({spans} spans, {instants} instants, {len(tracks)} tracks)")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI
    raise SystemExit(main())


__all__ = ["STATS_SCHEMA", "main", "validate_stats", "validate_trace",
           "validate_trace_file"]
