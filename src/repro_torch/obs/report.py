"""Flight-recorder text report: ``python -m repro_torch.obs.report trace.json``
(a copy of ``repro.obs.report``).

Renders, from an exported Perfetto trace file:

  * **phase breakdown** — total span seconds per event name, across all
    tracks (where does the wall time go?);
  * **straggler ranking** — per-worker busy seconds, slowest first
    (which worker gates the barrier-less fleet?);
  * **top stalls** — the longest individual wait-like spans (credit
    waits, slab waits, pump waits), with track and timestamp so the
    window can be inspected in the Perfetto UI.
"""
from __future__ import annotations

import argparse
import collections
import json

from . import schema

#: span names treated as stalls for the top-stalls table.
STALL_NAMES = {"exchange_issue", "exchange_commit", "host_wait", "pump_wait",
               "barrier_wait"}


def load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return schema.validate_trace(doc)


def _track_names(events: list) -> dict:
    names: dict = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    return names


def _track_label(names: dict, pid: int, tid: int) -> str:
    return names.get((pid, tid), f"pid{pid}/tid{tid}")


def summarize(doc: dict, *, top: int = 10) -> str:
    events = doc["traceEvents"]
    names = _track_names(events)
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]

    by_phase: dict = collections.defaultdict(lambda: [0, 0.0])
    busy: dict = collections.defaultdict(float)
    stalls = []
    for ev in spans:
        dur_s = ev["dur"] / 1e6
        rec = by_phase[ev["name"]]
        rec[0] += 1
        rec[1] += dur_s
        key = (ev["pid"], ev["tid"])
        if ev["name"] != "epoch":  # epoch spans contain the phase spans
            busy[key] += dur_s
        wait = (ev.get("args") or {}).get("wait_s")
        if ev["name"] in STALL_NAMES or wait is not None:
            stalls.append((wait if wait is not None else dur_s, ev))

    lines = [f"trace: {len(spans)} spans, {len(instants)} instants, "
             f"{len(names) or len(busy)} tracks"]

    lines.append("")
    lines.append("phase breakdown (total seconds per event name):")
    total = sum(rec[1] for rec in by_phase.values()) or 1.0
    for name, (count, secs) in sorted(by_phase.items(),
                                      key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:<18} {secs:10.4f}s  x{count:<7d} "
                     f"{100.0 * secs / total:5.1f}%")

    lines.append("")
    lines.append("straggler ranking (busy seconds per track, slowest first):")
    for (pid, tid), secs in sorted(busy.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {_track_label(names, pid, tid):<24} {secs:10.4f}s")

    lines.append("")
    lines.append(f"top stalls (longest {top}):")
    stalls.sort(key=lambda x: -x[0])
    for secs, ev in stalls[:top]:
        lines.append(f"  {secs * 1e3:9.3f}ms  {ev['name']:<18} "
                     f"{_track_label(names, ev['pid'], ev['tid']):<24} "
                     f"@{ev['ts'] / 1e6:.4f}s")
    if not stalls:
        lines.append("  (none recorded)")

    if instants:
        lines.append("")
        lines.append("incidents:")
        for ev in instants:
            args = ev.get("args") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(args.items()))
            lines.append(f"  @{ev['ts'] / 1e6:.4f}s  {ev['name']} "
                         f"[{_track_label(names, ev['pid'], ev['tid'])}]"
                         f"{('  ' + extra) if extra else ''}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a text summary from a flight-recorder trace.")
    ap.add_argument("trace", help="trace.json exported by repro_torch.obs.trace")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the top-stalls table (default 10)")
    args = ap.parse_args(argv)
    print(summarize(load(args.trace), top=args.top))
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI
    raise SystemExit(main())


__all__ = ["STALL_NAMES", "load", "main", "summarize"]
