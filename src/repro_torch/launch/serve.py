"""Batched serving, as ``repro.launch.serve``: prefill a batch of
prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import get_config
from ..core.device import resolve_device
from ..models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "llama3.2-1b", smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          verbose: bool = True, device="cuda") -> dict:
    """Random weights from ``seed``, prompts from a generator seeded with
    ``seed + 1``, then ``prefill`` and ``gen - 1`` greedy ``decode_step``s,
    under ``torch.inference_mode()`` on ``device`` (``"cuda"`` by default;
    raises without CUDA — pass ``device="cpu"``).

    Returns ``tokens`` (batch, gen), ``prefill_s`` and ``tok_per_s`` (over
    the decode steps after the first), as ``repro.launch.serve`` does, plus
    ``setup_s`` (weights on the device) and ``finite`` (every logit of the
    run was finite).  An encoder-only or embeddings-input config raises
    ``ValueError``: serve makes token prompts, so such a model is driven
    through ``models.model`` (``forward``; ``prefill`` and ``decode_step``)
    with its embeddings."""
    cfg = get_config(arch, smoke=smoke)
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only; no decode step")
    if cfg.input_mode == "embeddings":
        raise ValueError(
            f"{arch} takes embeddings (B, S, d), not the token prompts serve makes; "
            "drive models.model.prefill and decode_step with them")
    dev = resolve_device(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed, device=dev)
        _sync(dev)
        t_setup = time.perf_counter() - t0
        prompts = torch.randint(2, cfg.vocab, (batch, prompt_len),
                                generator=torch.Generator().manual_seed(seed + 1))
        prompts = prompts.to(dev)
        max_seq = prompt_len + gen

        t0 = time.perf_counter()
        states, logits = M.prefill(params, cfg, prompts, max_seq=max_seq)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()

        tok = logits.argmax(-1)
        out = [tok.cpu().numpy()]
        # the first step is left out of the rate, as ``repro.launch.serve``
        # leaves its compile out
        states, logits = M.decode_step(params, cfg, states, tok, prompt_len)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok.cpu().numpy())
        t0 = time.perf_counter()
        for t in range(1, gen - 1):
            states, logits = M.decode_step(params, cfg, states, tok, prompt_len + t)
            finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1)
            out.append(tok.cpu().numpy())
        _sync(dev)
        t_decode = time.perf_counter() - t0
    tokens = np.stack(out, axis=1)  # (batch, gen)
    tps = batch * (gen - 2) / max(t_decode, 1e-9)
    if verbose:
        print(f"prefill({batch}x{prompt_len}): {t_prefill*1e3:.1f} ms")
        print(f"decode steady-state: {tps:.1f} tok/s ({t_decode/max(gen-2, 1)*1e3:.1f} ms/step)")
        print(f"first generated tokens: {tokens[:, :8].tolist()}")
    return {"tokens": tokens, "prefill_s": t_prefill, "tok_per_s": tps,
            "setup_s": t_setup, "finite": bool(finite)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(arch=args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
