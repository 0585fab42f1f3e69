"""Gradient compression for data parallelism over a slow axis, as
``repro.optim.grad_compression``.

  * :func:`quantized_psum`: an int8 block-quantized all-reduce, 4x (bf16)
    or 8x (f32) fewer bytes on the wire; deterministic and stateless;
  * :class:`TopKCompressor`: top-k magnitude sparsification with error
    feedback (the unsent remainder accumulates in a residual).

The reference runs its all-reduce inside ``shard_map`` (``psum`` of the int8
payloads, ``pmax`` of the scales).  The port's shards are a single
controller's (``core/mesh.py``): one tensor a shard, each on its own device,
and the reduction gathers them.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from ..core.struct import tree_map

Tree = Any
_BLOCK = 256


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization of the flattened ``x``: (q
    (n_blocks, 256) int8, scale (n_blocks, 1) f32)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale
    return blocks.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def quantized_psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The int8-quantized all-reduce of one tensor a shard: each shard
    quantizes its tensor; the int8 payloads sum as int32 and the block
    scales take their maximum (the reference's ``psum``/``pmax``: a
    conservative magnitude), and every shard gets the dequantized sum on
    its own device, in its tensor's dtype."""
    parts = [_quantize_int8(x) for x in xs]
    home = xs[0].device
    q_sum = sum(q.to(home, torch.int32) for q, _ in parts)
    scale_max = torch.stack([s.to(home) for _, s in parts]).amax(dim=0)
    blocks = q_sum.to(torch.float32) * scale_max
    out = blocks.reshape(-1)[:xs[0].numel()].reshape(xs[0].shape)
    return [out.to(device=x.device, dtype=x.dtype) for x in xs]


class TopKCompressor:
    """Top-k sparsification with error feedback.

    state: a residual tree (the gradients' shapes, f32).  ``compress``
    keeps, a leaf, the top ``ratio`` fraction by magnitude of (grad +
    residual) as (values, flat indices); what was not sent stays in the
    residual, so every coordinate ships eventually."""

    def __init__(self, ratio: float = 0.01):
        self.ratio = ratio

    def init(self, params: Tree) -> Tree:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def compress(self, grads: Tree, residual: Tree):
        """(compressed tree of (values, indices), new residual tree)."""
        def one(g, r):
            flat = (g.to(torch.float32) + r).reshape(-1)
            k = max(int(flat.numel() * self.ratio), 1)
            idx = torch.topk(flat.abs(), k).indices
            sent = flat[idx]
            new_r = flat.clone()
            new_r[idx] = 0.0
            return (sent, idx), new_r.reshape(g.shape)

        both = tree_map(one, grads, residual)
        return (tree_map(lambda _, b: b[0], grads, both),
                tree_map(lambda _, b: b[1], grads, both))

    def decompress(self, compressed: Tree, template: Tree) -> Tree:
        """The dense tree of ``template``'s shapes and dtypes from the
        compressed one (zeros where nothing was sent)."""
        def one(t, c):
            vals, idx = c
            flat = torch.zeros(t.numel(), dtype=torch.float32, device=t.device)
            flat[idx] = vals
            return flat.reshape(t.shape).to(t.dtype)

        return tree_map(one, template, compressed)


__all__ = ["TopKCompressor", "quantized_psum"]
