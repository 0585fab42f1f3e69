"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the check against the plain reference, the metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` names its system and holds the
limit of every number the check compares, ``systems/<system>.py`` builds
the system and holds its check, ``traffic/<traffic>.json`` says which
engine, which kernels it loads and how inputs change from run to run, and
``metrics/<metric>.py`` reads one metric from what a run recorded.  A run
is a closed loop with one client: an architect running simulation after
simulation, each ``Simulation.reset`` -> ``run(until=done)`` -> the result
read back to the host.

A system module has ``System`` (``reset(run)``, ``run()``, ``readback()``,
``close()``, ``cores`` and, where it simulates cycles, ``cycle``), ``Check``
(called with a run's index, its answer and its record, it returns one
reading a limit of the configuration) and ``control_output`` (the answer
and record of the plain reference in the precision below, in the
program's place); ``run_bytes(cfg, cycles)``, the per-epoch count of one
run, is optional: without it ``cycle_roofline`` has nothing to read.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Seconds of the window the profiler records in a ``--trace 1`` run (whole
#: runs, at least one): enough runs for the shares, few enough events to
#: read back quickly (the queue interpreter launches ~137 a cycle).
TRACE_S = 3.0
#: Top-level modules that may not be loaded in a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPANS = ("reset", "run", "readback")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> tuple:
    """(cell, configuration, traffic mix) of ``workload``."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "configuration")
    cfg = load_json(ROOT / entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def system_module(cfg: dict):
    return importlib.import_module(f"bench.systems.{cfg['system']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``, loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def epoch_count(cfg: dict, cores: int, events: dict, cycles: int) -> float:
    """The per-epoch count (``cfg['epoch_bytes']``) of one run of ``cycles``
    simulated cycles on ``cores`` cores: every core's modelled state read
    and written once an epoch, plus each event of the run at its bytes."""
    eb = cfg["epoch_bytes"]
    epochs = math.ceil(cycles / eb["epoch_cycles"])
    total = epochs * cores * (eb["state_read"] + eb["state_write"])
    for name, count in events.items():
        total += count * eb["per_event"][name]
    return float(total)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> dict:
    from repro_torch.obs.registry import REGISTRY

    snap = REGISTRY.snapshot()
    return {k: float(snap.get(f"until.{k}", 0.0)) for k in ("host_syncs", "captures")}


class Window:
    """The runs of the measured window, each split into its three spans on
    the host clock."""

    def __init__(self, system, device):
        self.system, self.device = system, device
        self.runs: list = []
        self.outputs: list = []

    def one(self, index: int, annotate) -> None:
        s, dev = self.system, self.device
        t0 = time.perf_counter()
        with annotate("bench.reset"):
            s.reset(index)
            _sync(dev)
            start = getattr(s, "cycle", None)
        t1 = time.perf_counter()
        with annotate("bench.run"):
            s.run()
            _sync(dev)
        t2 = time.perf_counter()
        with annotate("bench.readback"):
            out = s.readback()
            cycles = getattr(s, "cycle", None)
        t3 = time.perf_counter()
        self.runs.append({"start_cycle": start, "cycles": cycles, "t0": t0,
                          "reset_s": t1 - t0, "run_s": t2 - t1, "read_s": t3 - t2,
                          "total_s": t3 - t0})
        self.outputs.append(out)


def read_trace(prof, t_window: float) -> dict:
    """Device busy time, events and operations from the profiler's trace:
    over the traced window, and inside the benchmark's ``bench.run`` spans."""
    rows = [(e.name(), e.device_type().name, e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events()]
    spans = {k: [] for k in SPANS}
    device = []
    for name, kind, lo, hi in rows:
        if kind == "CPU" and name.startswith("bench.") and name[6:] in spans:
            spans[name[6:]].append((lo, hi))
        elif kind == "CUDA" and not name.startswith("bench."):
            device.append((lo, hi, name))
    device.sort()

    def union(intervals) -> float:
        busy, reach = 0.0, -math.inf
        for lo, hi in intervals:
            if hi > reach:
                busy += hi - max(lo, reach)
                reach = hi
        return busy

    def locate(sorted_spans, t: float):
        """Index of the span of ``sorted_spans`` holding ``t``, or None."""
        i = bisect.bisect_right(sorted_spans, (t, math.inf)) - 1
        return i if i >= 0 and sorted_spans[i][0] <= t <= sorted_spans[i][1] else None

    run_spans = sorted(spans["run"])
    inside = [(lo, hi, n) for lo, hi, n in device if locate(run_spans, lo) is not None]
    per_op: dict = {}
    for lo, hi, name in device:
        per_op[name] = per_op.get(name, 0.0) + (hi - lo)
    # idle gaps between device work, named by the host span they fall in
    labelled = sorted((lo, hi, k) for k, v in spans.items() for lo, hi in v)
    bounds = [(lo, hi) for lo, hi, _ in labelled]
    gaps, reach = [], None
    for lo, hi, _ in device:
        if reach is not None and lo > reach:
            j = locate(bounds, 0.5 * (reach + lo))
            gaps.append((labelled[j][2] if j is not None else "between runs", lo - reach))
        reach = hi if reach is None else max(reach, hi)
    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": union((lo, hi) for lo, hi, _ in device) if device else None,
        "window_s": t_window,
        "events": len(device),
        "run_events": len(inside),
        "run_busy_s": union((lo, hi) for lo, hi, _ in inside) if inside else None,
        "device_ops": sorted(per_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[k, v] for k, v in gaps[:10]],
    }


def judge(check, limits: dict, runs: list, outputs: list) -> tuple:
    """(runs that failed, the worst reading of each number): every run's
    answer and record through ``check``, each reading against its limit.
    A check that raises reads infinite on every number."""
    readings = dict.fromkeys(limits, 0.0)
    failed = 0
    for i, (rec, out) in enumerate(zip(runs, outputs)):
        try:
            got = check(i, out, rec)
        except (ValueError, RuntimeError, TypeError, IndexError) as e:
            print(f"check of run {i} raised {type(e).__name__}: {e}", file=sys.stderr)
            got = dict.fromkeys(limits, math.inf)
        if set(got) != set(limits):
            raise ValueError(f"the check reads {sorted(got)}, the limits are {sorted(limits)}")
        failed += any(float(got[k]) > limits[k] for k in limits)
        readings = {k: max(readings[k], float(got[k])) for k in limits}
    return failed, readings


def limits_of(cfg: dict) -> dict:
    return {k: float(v) for k, v in cfg["limits"].items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, bench: dict | None = None,
             cfg: dict | None = None, parts: dict | None = None) -> tuple:
    """One run of ``workload``: returns (result line as a dict, the checks
    as (name, value, limit) triples).  ``cfg`` replaces the configuration's
    file (the CPU tests run small sizes); ``t_start`` is when the process
    started (set-up is timed from it); ``parts`` holds the seconds of
    set-up's steps before this call (the imports, the look for cards)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    cell, file_cfg, mix = cell_files(bench, workload)
    cfg = file_cfg if cfg is None else cfg
    sysmod = system_module(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = dict(parts or {})

    # ---- set-up: the card, the kernels (built where the checkout has none
    # yet), the system, then one warm run at the cell's own shapes
    t0 = time.perf_counter()
    parts["start_s"] = t0 - t_start - sum(parts.values())
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
        parts["cuda_s"] = time.perf_counter() - t0
        from repro_torch.kernels import _build

        parts["build_s"] = sum(_build.build(k) for k in mix.get("kernels", ()))
    t0 = time.perf_counter()
    system = sysmod.System(cfg, mix, seed, dev)
    cores = system.cores
    _sync(dev)
    parts["lower_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Window(system, dev).one(-1, lambda name: contextlib.nullcontext())
    parts["warm_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    # ---- the window: runs back to back until ``seconds`` have passed
    gc.collect()
    win = Window(system, dev)
    c0 = _counters()
    allocs0 = torch.cuda.memory_stats(dev).get("num_device_alloc", 0) if cuda else 0
    prof, traced_runs, t_traced = None, 0, 0.0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        annotate = record_function
    else:
        annotate = lambda name: contextlib.nullcontext()  # noqa: E731
    w0 = time.perf_counter()
    while True:
        win.one(len(win.runs), annotate)
        now = time.perf_counter()
        if prof is not None and (now - w0 >= min(TRACE_S, seconds)):
            prof.__exit__(None, None, None)
            traced_runs, t_traced = len(win.runs), now - w0
            prof_done, prof = prof, None
            annotate = lambda name: contextlib.nullcontext()  # noqa: E731
        if now - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    counters = {k: v - c0[k] for k, v in _counters().items()}
    if cuda:
        counters["device_allocs"] = float(
            torch.cuda.memory_stats(dev).get("num_device_alloc", 0) - allocs0)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check: every run's answer and record against the reference
    limits = limits_of(cfg)
    failed, readings = judge(sysmod.Check(cfg, mix, seed, dev), limits, win.runs, win.outputs)
    win.outputs.clear()
    checks = [(k, readings[k], lim) for k, lim in limits.items()]

    tr = None
    if trace:
        tr = read_trace(prof_done, t_traced)
        traced = win.runs[:traced_runs]
        cycles = [r["cycles"] for r in traced]
        tr["cycles"] = sum(cycles) if None not in cycles else None
        count = getattr(sysmod, "run_bytes", None)
        tr["bytes"] = (sum(count(cfg, c) for c in cycles)
                       if count is not None and tr["cycles"] is not None else None)
    ctx = SimpleNamespace(
        setup_s=setup_s, lower_s=parts["lower_s"], window_s=window_s, runs=win.runs,
        cores=cores, counters=counters, trace=tr,
        peaks=load_json(HERE / "peaks.json"), cfg=cfg)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": failed == 0, "attempted": len(win.runs), "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": peak},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"] if tr["busy_s"] is not None else 0.0
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr["device_ops"]],
                               "idle_gaps": tr["idle_gaps"]}
    # set-up's parts: a build in a checkout's first run shows as build_s
    result["setup"] = parts
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def control(workload: str, seed: int, *, device="cuda", bench: dict | None = None,
            cfg: dict | None = None) -> tuple:
    """The control of ``workload``'s check under ``seed``: the plain
    reference in the precision below the configuration's, in the program's
    place, judged as ``run_cell`` judges a run.  Returns (failed, the checks
    as (name, value, limit) triples)."""
    import torch

    bench = benchmark() if bench is None else bench
    _, file_cfg, mix = cell_files(bench, workload)
    cfg = file_cfg if cfg is None else cfg
    sysmod = system_module(cfg)
    dev = torch.device(device)
    out, rec = sysmod.control_output(cfg, mix, seed, 0, dev)
    limits = limits_of(cfg)
    failed, readings = judge(sysmod.Check(cfg, mix, seed, dev), limits, [rec], [out])
    return failed, [(k, readings[k], lim) for k, lim in limits.items()]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))

