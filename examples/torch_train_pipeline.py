"""End-to-end training on the PyTorch port (``examples/train_pipeline.py``
in JAX): a ~100M-parameter LM for a few hundred steps on the full
substrate stack (synthetic pipeline -> model -> AdamW -> watchdog ->
periodic checkpoints), with a crash injected mid-run to show restore and
continue.

    python examples/torch_train_pipeline.py [--steps 300]      # on the card
    python examples/torch_train_pipeline.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import repro_torch.configs.llama3_2_1b as base  # noqa: E402
import repro_torch.launch.train as T  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_pipeline"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps (CI-friendly)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.smoke:
        args.steps = min(args.steps, 8)
        args.batch = 2
        args.seq = 32
        args.ckpt_dir = args.ckpt_dir + "_smoke"
        # a stale checkpoint at or past the final step would leave no step
        # to run: smoke runs start fresh
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    # a ~100M-parameter llama-family config (d 512, 8 layers, 32k vocab);
    # --smoke shrinks it to a ~1M-parameter toy of the same topology
    if args.smoke:
        cfg = dataclasses.replace(
            base.CONFIG, name="llama-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
            use_kernels=False)
    else:
        cfg = dataclasses.replace(
            base.CONFIG, name="llama-100m", n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32768, dtype="float32",
            use_kernels=False)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.0f}M params, {args.steps} "
          f"steps, crash injected at step {args.steps // 2}, on {args.device}")

    T.get_config = lambda arch, smoke=True: cfg  # this run's config for the registry's
    out = T.train(arch=cfg.name, smoke=False, steps=args.steps, batch=args.batch,
                  seq=args.seq, lr=1e-3, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                  fail_at=(args.steps // 2,), log_every=20, device=args.device)
    print(f"\nfinal loss {out['final_loss']:.4f} (first {out['losses'][0]:.4f}), "
          f"restarts={out['restarts']}, steps_run={out['steps_run']}")
    assert out["final_loss"] < out["losses"][0]
    print("torch_train_pipeline OK: loss decreased through a crash/restore cycle")


if __name__ == "__main__":
    main()
