"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload wafer-1M.fused --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared with the reference come last, under
``checks``, and as the last lines of standard error.  Exits 3 without a
result where there is no CUDA card or fewer cards than the cell asks for,
and 1 where the run loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be non-negative")

    # the program and the benchmark import from the checkout; every kernel
    # cache stays inside it (the port builds into build/repro_torch/)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    # one process with one host thread for CPU ops: the card does the work,
    # and a pool of host threads would spin on the cores beside it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    from bench import harness

    bench = harness.benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    t0 = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    t1 = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    parts = {"torch_s": t1 - t0, "devices_s": time.perf_counter() - t1}
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), t_start=T_START, bench=bench,
                                      parts=parts)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark drives the port alone", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
