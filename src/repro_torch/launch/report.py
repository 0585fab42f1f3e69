"""Tables of the dry-run's records, as ``repro.launch.report``.

    python -m repro_torch.launch.report [--mesh single|multi|card] [--out-dir DIR]

(with ``src`` on ``PYTHONPATH``).  The reference's two tables over the
port's records (``launch.dryrun``): a term that a record lacks prints as
``-`` (the ``single`` and ``multi`` records have no roofline terms).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import OUT_DIR

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(mesh: str | None = None, out_dir: str | None = None) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir or OUT_DIR, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh is None or r.get("mesh") == mesh:
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9), r["mesh"]))
    return recs


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    x = float(x)
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}us"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def roofline_table(mesh: str = "single", out_dir: str | None = None) -> str:
    rows = [
        "| arch | shape | step | compute | memory | collective | dominant | "
        "MODEL_FLOPs | HLO/MODEL | peak-frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh, out_dir):
        if r["arch"] == "manycore":
            continue
        if r["status"] == "skipped":
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | SKIP | — | — | "
                f"{r['reason'][:48]} |"
            )
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | {r['error'][:60]} |")
            continue
        terms = [r.get(k) for k in ("compute_s", "memory_s", "collective_s")]
        if None in terms:
            frac = ratio = dom = "-"
        else:
            total = max(terms)
            frac = f"{(terms[0] / total if total else 0.0) * 100:.1f}%"
            ratio = (f"{r['hlo_flops'] / r['model_flops']:.2f}" if r.get("model_flops")
                     else "-")
            dom = r["dominant"][:-2]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['step_kind']} | "
            + " | ".join(_fmt_s(t) for t in terms)
            + f" | {dom} | {r.get('model_flops', 0):.2e} | {ratio} | {frac} |"
        )
    return "\n".join(rows)


def dryrun_table(out_dir: str | None = None) -> str:
    rows = [
        "| arch | shape | mesh | status | chips | args/dev | compile | collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in load(out_dir=out_dir):
        if r["status"] == "ok":
            gb = r.get("memory_analysis", {}).get("argument_size_in_bytes", 0) / 1e9
            coll = ", ".join(
                f"{k}:{int(v)}" for k, v in sorted(r.get("collective_counts", {}).items())
            )
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
                f"{r.get('n_chips','-')} | {gb:.2f} GB | {r.get('compile_s','-')}s | {coll} |"
            )
        elif r["status"] == "skipped":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | - | - | - | "
                f"{r['reason'][:52]} |"
            )
        else:
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL** | - | - | - | "
                f"{r['error'][:52]} |"
            )
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--table", default="both", choices=["roofline", "dryrun", "both"])
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    if args.table in ("dryrun", "both"):
        print("## Dry-run matrix\n")
        print(dryrun_table(args.out_dir))
        print()
    if args.table in ("roofline", "both"):
        print(f"## Roofline ({args.mesh})\n")
        print(roofline_table(args.mesh, args.out_dir))


if __name__ == "__main__":
    main()
