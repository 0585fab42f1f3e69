"""Shared layer primitives, as ``repro.models.layers``: RMSNorm, RoPE and
M-RoPE, attention (prefill and one-token decode), the gated MLP, embedding.

Functions over explicit parameter dicts of tensors.  Parameters are in
``cfg.dtype`` (bf16 by default) and norm, softmax and recurrence math runs
in f32, with the JAX package's casts.  ``jax.nn.gelu`` is the tanh form, so
every GeLU here is ``approximate="tanh"``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig


#: Elements of the largest leaf :func:`truncnorm` draws in one piece; a
#: larger one (a stacked expert weight at full width) is drawn in slices
#: along its leading dims, so the f32 draw stays at most 4 GiB.
DRAW_LIMIT = 1 << 30


def _draw(gen, shape, scale: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * scale


def _draw_into(out: torch.Tensor, gen, scale: float) -> None:
    if out.numel() <= DRAW_LIMIT:
        out.copy_(_draw(gen, out.shape, scale, out.device))
        return
    step = max(1, DRAW_LIMIT // out[0].numel())
    for i in range(0, out.shape[0], step):
        _draw_into(out[i:i + step] if step > 1 else out[i], gen, scale)


def truncnorm(gen: torch.Generator, shape, scale: float, dtype,
              device) -> torch.Tensor:
    """Normal truncated to [-2, 2] (not renormalized), times ``scale``,
    drawn in f32 from ``gen`` and cast to ``dtype``; a leaf of more than
    ``DRAW_LIMIT`` elements in slices along its leading dims.  On the
    ``meta`` device (``gen`` None) nothing is drawn: the leaf's shape and
    dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if math.prod(shape) <= DRAW_LIMIT:
        return _draw(gen, shape, scale, device).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    _draw_into(out, gen, scale)
    return out


def no_constraint(x, kind: str):
    """The default sharding hook (``sharding.partition.make_constrain``'s
    place): ``x`` as it is."""
    return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(lead: tuple, d: int, dtype, device) -> dict:
    return {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    norm = xf * torch.rsqrt(var + eps)
    # (1 + scale) parameterization (gemma/llama-style zero-centered scale)
    return (norm * (1.0 + params["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T).  Rotates the split halves, in
    f32."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  positions: (3, B, T), the (t, h, w)
    streams.  The D/2 frequencies fall into three sections, each rotated
    by its own stream; with three equal streams this is :func:`apply_rope`."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    sec = torch.tensor(sum(([i] * s for i, s in enumerate(sections)), []),
                       dtype=torch.long, device=x.device)  # (D/2,) stream ids
    pos_sec = positions.float()[sec]  # (D/2, B, T)
    angles = pos_sec.movedim(0, -1) * freqs  # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positional_rotate(cfg: ModelConfig, x, positions):
    if cfg.rope_type == "mrope":
        if positions.dim() == 2:  # a text-only stream: the same on all three axes
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------- attention
def attention_init(gen, lead: tuple, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, scale: truncnorm(gen, lead + shape, scale, dtype, device)  # noqa: E731
    return {
        "wq": tn((d, cfg.n_heads * hd), s),
        "wk": tn((d, cfg.n_kv_heads * hd), s),
        "wv": tn((d, cfg.n_kv_heads * hd), s),
        "wo": tn((cfg.n_heads * hd, d), 1.0 / math.sqrt(cfg.n_heads * hd)),
    }


def attention_fwd(params: dict, cfg: ModelConfig, x, positions, window):
    """Full-sequence attention, x: (B, T, d).  The kernel runs when
    ``cfg.use_kernels`` and T % 128 == 0."""
    B, T, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (x @ params["wk"]).reshape(B, T, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, T, Hkv, hd)
    q = positional_rotate(cfg, q, positions)
    k = positional_rotate(cfg, k, positions)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    use_kernel = cfg.use_kernels and T % 128 == 0
    o = kops.flash_attention(qh, kh, vh, causal=cfg.causal, window=window,
                             use_kernel=use_kernel)
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    return o @ params["wo"]


def attention_decode(params: dict, cfg: ModelConfig, x, cache_k, cache_v,
                     pos: int, window):
    """One-token decode over a KV cache (B, S, Hkv, hd); returns (out,
    new_k, new_v).  A windowed layer's cache is a ring of S = window slots,
    position p at slot p % S."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = cache_k.shape[1]
    G = H // Hkv
    q = (x @ params["wq"]).reshape(B, 1, H, hd)
    k = (x @ params["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, 1, Hkv, hd)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = positional_rotate(cfg, q, posb)
    k = positional_rotate(cfg, k, posb)
    slot = min(pos, S - 1) if window is None else pos % S
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]

    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) / math.sqrt(hd)
    idx = torch.arange(S, device=x.device)
    valid = idx <= pos
    if window is not None:
        # the ring holds the last S positions once it has wrapped around
        valid = valid | (pos >= S)
    s = torch.where(valid, s, -1e30)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        s = torch.tanh(s / c) * c
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return o @ params["wo"], cache_k, cache_v


# ---------------------------------------------------------------- MLP
def mlp_init(gen, lead: tuple, d: int, d_ff: int, dtype, device) -> dict:
    tn = lambda shape, scale: truncnorm(gen, lead + shape, scale, dtype, device)  # noqa: E731
    return {
        "wi": tn((d, d_ff), 1.0 / math.sqrt(d)),
        "wg": tn((d, d_ff), 1.0 / math.sqrt(d)),
        "wo": tn((d_ff, d), 1.0 / math.sqrt(d_ff)),
    }


def mlp_fwd(params: dict, x, act: str):
    gate = x @ params["wg"]
    gate = F.silu(gate) if act == "silu" else gelu(gate)
    return (gate * (x @ params["wi"])) @ params["wo"]


# ---------------------------------------------------------------- embedding
def embed_lookup(table, tokens):
    return table[tokens]


def embed_scale(cfg: ModelConfig, x):
    """x times sqrt(d_model) rounded to x's dtype first, as the JAX package
    does (50.5 in bf16 for d = 2560)."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def unembed(table_or_head, x, tied: bool):
    """Logits in f32.  On the card this is a full-f32 product: it needs
    ``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default."""
    w = table_or_head.float()
    xf = x.float()
    if tied:
        return xf @ w.T
    return xf @ w
