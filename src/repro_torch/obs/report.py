"""Flight-recorder text report: ``python -m repro_torch.obs.report trace.json``
(a copy of ``repro.obs.report``).

Renders, from an exported Perfetto trace file:

  * **phase breakdown** — self seconds per event name, across all tracks
    (where does the wall time go?): a span's time less that of the spans
    nested in it on its track, so nested spans (the session's
    ``session.reset`` holds ``init.state``) are not counted twice (the
    text is ``repro.obs.report``'s where no span nests in another);
  * **straggler ranking** — per-worker busy seconds, slowest first
    (which worker gates the barrier-less fleet?): the self seconds of a
    track's spans, ``epoch`` spans left out;
  * **top stalls** — the longest individual wait-like spans (credit
    waits, slab waits, pump waits), with track and timestamp so the
    window can be inspected in the Perfetto UI.

:func:`idle_split` puts a device trace's idle time down to the session's
spans (``obs.trace``), laid on the device trace's clock.
"""
from __future__ import annotations

import argparse
import collections
import json

from . import schema

#: span names treated as stalls for the top-stalls table.
STALL_NAMES = {"exchange_issue", "exchange_commit", "host_wait", "pump_wait",
               "barrier_wait"}


#: The session spans idle time is put down to, the first that covers an
#: instant taking it: a capture, the rest of the until-loop (replay
#: launches, the host's reads of ``stop``), the reset, the result read.
IDLE_ORDER = ("until.capture", "session.until", "session.reset", "session.read")


def _merged(intervals) -> list:
    """``intervals`` as sorted, disjoint (lo, hi) pairs."""
    out: list = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _minus(a: list, b: list) -> list:
    """The merged intervals ``a`` less the merged intervals ``b``."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append([lo, b[k][0]])
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append([lo, hi])
    return out


def _length(intervals: list) -> float:
    return float(sum(hi - lo for lo, hi in intervals))


def idle_split(device, spans: dict, window: tuple) -> dict:
    """The device's idle time over ``window`` (lo, hi), put down to spans.

    ``device`` holds the (lo, hi) intervals of device work and ``spans``
    maps a span name to its (lo, hi) intervals, both on one clock.  Idle
    is the window less the union of ``device``; each idle instant goes to
    the first name of :data:`IDLE_ORDER` whose spans cover it, and to
    ``other`` where none does.  Returns ``window``, ``busy``, ``idle``, each
    name of :data:`IDLE_ORDER` and ``other``, in the intervals' unit: the names' shares and
    ``other`` add up to ``idle``."""
    lo, hi = window
    frame = [[lo, hi]]
    busy = _minus(frame, _minus(frame, _merged(device)))
    idle = _minus(frame, busy)
    out = {"window": float(hi - lo), "busy": _length(busy), "idle": _length(idle)}
    for name in IDLE_ORDER:
        left = _minus(idle, _merged(spans.get(name, ())))
        out[name] = _length(idle) - _length(left)
        idle = left
    out["other"] = _length(idle)
    return out


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


def _self_seconds(spans: list) -> list:
    """Each span's duration less those of the spans nested in it on its
    track (one that starts and ends inside it), in seconds, in the order
    of ``spans``."""
    self_s = [ev["dur"] / 1e6 for ev in spans]
    order = sorted(range(len(spans)), key=lambda i: (
        spans[i]["pid"], spans[i]["tid"], spans[i]["ts"], -spans[i]["dur"]))
    stack: list = []  # the open spans of the current track, outermost first
    track = None
    for i in order:
        ev = spans[i]
        if (ev["pid"], ev["tid"]) != track:
            track, stack = (ev["pid"], ev["tid"]), []
        end = ev["ts"] + ev["dur"]
        while stack and end > spans[stack[-1]]["ts"] + spans[stack[-1]]["dur"] + 1e-3:
            stack.pop()
        if stack:
            self_s[stack[-1]] -= ev["dur"] / 1e6
        stack.append(i)
    return self_s


def summarize(doc: dict, *, top: int = 10) -> str:
    events = doc["traceEvents"]
    names = _track_names(events)
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]

    by_phase: dict = collections.defaultdict(lambda: [0, 0.0])
    busy: dict = collections.defaultdict(float)
    stalls = []
    for ev, self_s in zip(spans, _self_seconds(spans)):
        dur_s = ev["dur"] / 1e6
        rec = by_phase[ev["name"]]
        rec[0] += 1
        rec[1] += self_s
        key = (ev["pid"], ev["tid"])
        if ev["name"] != "epoch":  # epoch spans contain the phase spans
            busy[key] += self_s
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


__all__ = ["IDLE_ORDER", "STALL_NAMES", "idle_split", "load", "main", "summarize"]
