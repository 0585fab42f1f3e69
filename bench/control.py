"""The control of each cell's check, on the card at the cell's own size: the
plain reference computed in the precision below the configuration's
(bfloat16 for float32) put in the program's place, its answer judged by
the same comparison and limits as a run's (``harness.judge``).  It has to
come out not correct on every seed.

    python3 bench/control.py --seeds 101 102 103

Prints one line a cell, seed and number: its reading and its limit.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workloads", nargs="*", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    bench = harness.benchmark()
    names = args.workloads or [w["name"] for w in bench["workloads"]]
    passed = 0
    for name in names:
        for seed in args.seeds:
            failed, checks = harness.control(name, seed, bench=bench)
            passed += not failed
            for number, value, limit in checks:
                print(f"control {name} seed {seed}: {number} {value!r} limit {limit!r}")
            print(f"control {name} seed {seed}: "
                  f"{'not correct' if failed else 'CORRECT: the check cannot see it'}",
                  flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
