"""Run one cell several times, a fresh process a run, and summarise the
spread of each metric (how its bounds were set).

    python3 bench/sets.py --workload wafer-1M.fused --seconds 30 \\
        --seeds 11 12 13 14 15 16 --repeat 2 --out sets.jsonl

Each run is ``bench/run.py`` as the benchmark's command gives it; its
result line goes to ``--out`` (one JSON object a line, with the seed, the
set and its wall seconds).  The summary gives, for each metric and set,
the median and the spread: the distance between the first and third
quartiles (``statistics.quantiles(n=4)``) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1, help="sets, each over every seed")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        command = json.load(f)["command"]
    sets: list = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for k in range(args.repeat):
            lines = []
            for seed in args.seeds:
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [*command, "--workload", args.workload, "--seed", str(seed),
                     "--seconds", str(args.seconds), "--trace", str(args.trace)],
                    cwd=ROOT, capture_output=True, text=True)
                wall = time.perf_counter() - t0
                last = proc.stdout.strip().splitlines()[-1:] if proc.stdout.strip() else []
                try:
                    res = json.loads(last[0]) if last else None
                except json.JSONDecodeError:
                    res = None
                rec = {"workload": args.workload, "set": k, "seed": seed, "rc": proc.returncode,
                       "wall_s": wall, "result": res}
                if res is None or proc.returncode:
                    rec["stderr"] = proc.stderr[-4000:]
                out.write(json.dumps(rec) + "\n")
                out.flush()
                short = {n: m["value"] for n, m in (res or {}).get("metrics", {}).items()}
                print(f"set {k} seed {seed} rc {proc.returncode} wall {wall:.1f} s correct "
                      f"{res and res['correct']} runs {res and res['attempted']} {short}",
                      flush=True)
                lines.append(res)
            sets.append(lines)
    for k, lines in enumerate(sets):
        ok = [r for r in lines if r]
        series = {n: [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
                  for n in sorted({n for r in ok for n in r["metrics"]})}
        # set-up's parts; the first run of a set may build the kernels
        for part in sorted({p for r in ok for p in r.get("setup", {})}):
            series[f"setup.{part}"] = [r["setup"][part] for r in ok if part in r.get("setup", {})]
        for n, vals in series.items():
            if len(vals) >= 4 and statistics.median(vals[1:]) > 0:
                print(f"set {k} {n}: median {statistics.median(vals)!r} spread "
                      f"{spread(vals):.4%} over {len(vals)} runs, without the farthest "
                      f"{spread(trimmed(vals)):.4%}, without the first "
                      f"{spread(vals[1:]):.4%} (median {statistics.median(vals[1:])!r}); "
                      f"correct {sum(bool(r['correct']) for r in ok)}/{len(lines)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
