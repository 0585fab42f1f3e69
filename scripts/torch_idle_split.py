"""The card's idle time in one benchmark cell, put down to the session's
spans: a capture, the rest of the until-loop, the reset, the result read.

    python3 scripts/torch_idle_split.py --workload wafer-1M.fused --seed 7 \
        [--seconds 3] [--out idle_split.jsonl]

Builds the cell as ``bench/run.py`` does (its configuration, traffic mix
and system, the kernels it loads), warms it with one run, then runs whole
runs back to back for ``--seconds`` with ``torch.profiler`` and the
program's trace recorder (``repro_torch.obs.trace``) on together.  The
recorder's session spans are laid on the profiler's clock through its
anchors, and ``repro_torch.obs.report.idle_split`` puts the idle time of
the window (the window less the union of the CUDA events, as the
benchmark's ``idle_share`` reads it) down to them.

Prints one JSON line, appended to ``--out`` too: the idle share and its
four parts and remainder (% of the window), ``capture_ms_per_run`` (the
``until.capture`` spans' ms a run), the captures by cause over the
window, the recorder's spans a run by name and their host milliseconds a
run (``span_ms_per_run``: the reset's ``init.state`` against its
``init.tables``), and ``clock_err_ms``: the most by which a session span,
mapped, leaves the benchmark's own ``bench.*`` range around it (0 where
the two clocks agree).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Each benchmark range and the session span it holds.
HOLDS = {"bench.reset": "session.reset", "bench.run": "session.until",
         "bench.readback": "session.read"}


def _intervals(spans: list, name: str) -> list:
    return [(s["lo_ns"], s["hi_ns"]) for s in spans if s["name"] == name]


def clock_err_ns(ranges: dict, spans: list) -> int:
    """The most by which a session span leaves the benchmark range of its
    run that should hold it, in ns."""
    worst = 0
    for outer, inner in HOLDS.items():
        for (lo, hi), (a, b) in zip(sorted(ranges.get(outer, ())),
                                    sorted(_intervals(spans, inner))):
            worst = max(worst, lo - a, b - hi)
    return int(worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import harness
    from repro_torch.kernels import _build
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.registry import REGISTRY

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    _, cfg, mix = harness.cell_files(harness.benchmark(), args.workload)
    for k in mix.get("kernels", ()):
        _build.build(k)
    system = harness.system_module(cfg).System(cfg, mix, args.seed, dev)
    harness.Window(system, dev).one(-1, lambda name: contextlib.nullcontext())

    win = harness.Window(system, dev)
    rec = obs_trace.recorder()
    rec.clear()
    rec.enable()
    causes = ("first", "moved")
    captures = lambda: {c: REGISTRY.counters().get(f"until.captures.{c}", 0.0)  # noqa: E731
                        for c in causes}
    c0 = captures()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    lo, w0 = time.time_ns(), time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        win.one(len(win.runs), record_function)
    hi = time.time_ns()
    prof.__exit__(None, None, None)
    rec.disable()
    spans = rec.profiler_spans()
    n_events = len(rec.events)

    device, ranges = [], {k: [] for k in HOLDS}
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type().name == "CUDA" and not e.name().startswith("bench."):
            device.append((a, b))
        elif e.device_type().name == "CPU" and e.name() in ranges:
            ranges[e.name()].append((a, b))  # not the ranges' copies on the GPU track
    by_name = {n: _intervals(spans, n) for n in report.IDLE_ORDER}
    split = report.idle_split(device, by_name, (lo, hi))

    runs = len(win.runs)
    pct = lambda v: 100.0 * v / split["window"]  # noqa: E731
    counts = collections.Counter(s["name"] for s in spans)
    span_ns = collections.Counter()
    for s in spans:
        span_ns[s["name"]] += s["hi_ns"] - s["lo_ns"]
    line = {
        "workload": args.workload, "seed": args.seed, "runs": runs,
        "window_ms": split["window"] * 1e-6,
        "idle_share": pct(split["idle"]),
        "idle_capture_share": pct(split["until.capture"]),
        "idle_until_share": pct(split["session.until"]),
        "idle_reset_share": pct(split["session.reset"]),
        "idle_readback_share": pct(split["session.read"]),
        "idle_other_share": pct(split["other"]),
        "capture_ms_per_run": sum(b - a for a, b in by_name["until.capture"]) * 1e-6 / runs,
        "captures": {c: v - c0[c] for c, v in captures().items()},
        "spans_per_run": {k: v / runs for k, v in sorted(counts.items())},
        "span_ms_per_run": {k: v * 1e-6 / runs for k, v in sorted(span_ns.items())},
        "recorder_events_per_run": n_events / runs,
        "clock_err_ms": clock_err_ns(ranges, spans) * 1e-6,
        "device": torch.cuda.get_device_name(dev),
    }
    system.close()
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
