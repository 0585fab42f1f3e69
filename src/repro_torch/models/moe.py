"""Mixture-of-Experts FFN with capacity-based dispatch, as
``repro.models.moe`` (GShard-style scatter/gather, no one-hot einsums over
tokens x experts x capacity).

Per group (a batch row):
  1. router logits -> top_k experts and gate weights (:func:`_router`),
  2. each choice's position in its expert by a cumsum of int32 one-hots,
  3. tokens scattered into (E, capacity, d) expert buffers; a choice past
     its expert's capacity goes to the overflow slot ``E * cap`` and is
     dropped,
  4. the expert products as batched einsums over the expert dim,
  5. a gather back and the gate-weighted combine in f32, in rank order.

The reference computes all of this in XLA, outside any Pallas kernel, so
plain PyTorch (``einsum``, ``index_add_``, indexing) is its counterpart
here.  ``constrain`` is the reference's sharding hook, called on the
dispatch and combine buffers.  On the card the scatter adds with
atomics; each real slot takes exactly one add onto zero, so only the
overflow slot, whose row every kept choice weights by 0 and whose gather
is discarded, sees contended adds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import gelu, mlp_fwd, mlp_init, no_constraint, truncnorm


def moe_init(gen, lead: tuple, cfg: ModelConfig, dtype, device) -> dict:
    """``router`` (d, E) f32, ``wi``/``wg`` (E, d, dff), ``wo`` (E, dff, d)
    and, with ``shared_expert``, a gated MLP of width ``d_ff_expert``;
    each with the leading dims ``lead``."""
    mc = cfg.moe
    d, dff, E = cfg.d_model, mc.d_ff_expert, mc.n_experts
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, scale, dt=dtype: truncnorm(  # noqa: E731
        gen, lead + shape, scale, dt, device)
    p = {
        "router": tn((d, E), s, torch.float32),
        "wi": tn((E, d, dff), s),
        "wg": tn((E, d, dff), s),
        "wo": tn((E, dff, d), 1.0 / math.sqrt(dff)),
    }
    if mc.shared_expert:
        p["shared"] = mlp_init(gen, lead, d, dff, dtype, device)
    return p


def _router(params, mc: MoEConfig, x):
    """x (G, S, d) -> (expert idx (G, S, k) int64, gates (G, S, k) f32,
    the Switch load-balancing aux loss () f32)."""
    logits = x.float() @ params["router"].float()
    if mc.gate_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(scores, mc.top_k, dim=-1)
    if mc.router_norm_topk and mc.top_k > 1:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    E = logits.shape[-1]
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))  # (E,)
    counts = torch.bincount(idx[..., 0].reshape(-1), minlength=E).float()
    ce = counts / (idx.shape[0] * idx.shape[1])
    return idx, gates, E * (me * ce).sum()


def capacity(mc: MoEConfig, S: int) -> int:
    """Slots an expert holds in a group of S tokens (the reference's
    expression)."""
    return max(int(mc.capacity_factor * S * mc.top_k / mc.n_experts), 4)


def dispatch(params, mc: MoEConfig, x):
    """The router and each choice's slot: (idx, gates, aux, slot (B, S, k)
    with ``E * cap`` for a dropped choice, keep (B, S, k) bool, cap)."""
    B, S, _ = x.shape
    E, k = mc.n_experts, mc.top_k
    cap = capacity(mc, S)
    idx, gates, aux = _router(params, mc, x)
    flat_idx = idx.reshape(B, S * k)
    onehot = (flat_idx[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    position = pos_in_e.gather(-1, flat_idx[..., None])[..., 0].reshape(B, S, k)
    keep = position < cap
    slot = torch.where(keep, idx * cap + position, E * cap)
    return idx, gates, aux, slot, keep, cap


def scatter(x, slot, n_slots: int):
    """One scatter-add a choice rank of the tokens x (B, S, d) into their
    slots of a (B, n_slots, d) buffer of zeros."""
    B, S, d = x.shape
    rows = torch.arange(B, device=x.device)[:, None] * n_slots  # (B, 1)
    buf = torch.zeros((B * n_slots, d), dtype=x.dtype, device=x.device)
    tokens = x.reshape(B * S, d)
    for i in range(slot.shape[-1]):
        buf.index_add_(0, (rows + slot[:, :, i]).reshape(-1), tokens)
    return buf.view(B, n_slots, d)


def experts(params: dict, cfg: ModelConfig, expert_in):
    """The gated expert MLPs, batched over the expert dim: (B, E, cap, d)
    -> (B, E, cap, d)."""
    gate_h = torch.einsum("becd,edf->becf", expert_in, params["wg"])
    act = F.silu(gate_h) if cfg.hidden_act == "silu" else gelu(gate_h)
    h = act * torch.einsum("becd,edf->becf", expert_in, params["wi"])
    return torch.einsum("becf,efd->becd", h, params["wo"])


def combine(expert_out, slot, gates, keep):
    """One gather a choice rank (the overflow slot reads a row of zeros),
    weighted by its gate (0 where dropped) and summed in f32 in rank
    order -> (B, S, d) in expert_out's dtype."""
    B, E, cap, d = expert_out.shape
    flat_out = torch.cat([expert_out.reshape(B, E * cap, d),
                          expert_out.new_zeros((B, 1, d))], dim=1)
    batch = torch.arange(B, device=slot.device)[:, None]
    y = torch.zeros(slot.shape[:2] + (d,), dtype=torch.float32, device=slot.device)
    for i in range(slot.shape[-1]):
        got = flat_out[batch, slot[:, :, i]]  # (B, S, d)
        w = gates[:, :, i] * keep[:, :, i]
        y = y + got.float() * w[..., None]
    return y.to(expert_out.dtype)


def moe_fwd(params: dict, cfg: ModelConfig, x, constrain=no_constraint):
    """x (B, S, d), B doubling as the group dim -> (y (B, S, d) in x's
    dtype, aux ()).  ``constrain(buffer, "dispatch" | "combine")`` is the
    sharding hook at the reference's two points."""
    mc = cfg.moe
    B, S, d = x.shape
    E = mc.n_experts
    idx, gates, aux, slot, keep, cap = dispatch(params, mc, x)
    buf = scatter(x, slot, E * cap + 1)
    expert_in = constrain(buf[:, :E * cap].reshape(B, E, cap, d), "dispatch")
    expert_out = constrain(experts(params, cfg, expert_in), "combine")
    y = combine(expert_out, slot, gates, keep)
    if mc.shared_expert:
        y = y + mlp_fwd(params["shared"], x, cfg.hidden_act)
    return y, aux
