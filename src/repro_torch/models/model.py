"""Model assembly, as ``repro.models.model``: init, full-sequence forward
(differentiable), the training loss, prefill and one-token decode.

A model is a list of *segments*, each (pattern, n_stages): ``pattern`` is a
tuple of layer kinds (e.g. ('rglru', 'rglru', 'attn_local')) and the
segment's parameters are stacked over stages, in the JAX package's layout
(``params["segments"][seg][i]`` holds the leaves of pattern position ``i``
with a leading ``n_stages`` dim).  A Python loop over the stages takes the
place of ``lax.scan`` and walks them in the same order.  Decode states are
stacked the same way.

Layer kinds: attn | attn_local | attn_moe | rglru | mlstm | slstm.  Every
layer is pre-norm residual; attention and RG-LRU layers carry a gated MLP
(``attn_moe``: the MoE FFN of ``moe.py``), xLSTM blocks are self-contained
(d_ff = 0).  ``forward`` and ``prefill`` take token ids (B, S) or, for an
``input_mode="embeddings"`` config, embeddings (B, S, d).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from . import layers as L
from . import recurrent as R
from .config import ModelConfig
from .moe import moe_fwd, moe_init

ATTN_KINDS = ("attn", "attn_local", "attn_moe")


def segments_of(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    segs = [(cfg.block_pattern, cfg.n_stages)]
    if cfg.remainder:
        segs.append((cfg.remainder, 1))
    return segs


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind == "attn_moe":
        return True
    return kind in ("attn", "attn_local", "rglru") and cfg.d_ff > 0


def _uses_moe(cfg: ModelConfig, kind: str) -> bool:
    return kind == "attn_moe"


def _window(cfg: ModelConfig, kind: str):
    return cfg.attn_window if kind == "attn_local" else None


def _at(tree, s: int):
    """Stage ``s`` of a stage-stacked (nested) dict of tensors."""
    return {k: _at(v, s) if isinstance(v, dict) else v[s] for k, v in tree.items()}


def _stack(stages: list, empty: tuple) -> tuple:
    """Per-stage tuples of per-layer dicts -> a tuple of stage-stacked
    dicts; ``empty`` (the segment's states, stacked over 0 stages) where
    there are none, as the reference's scan of length 0 gives them."""
    if not stages:
        return empty
    return tuple({k: torch.stack([st[i][k] for st in stages]) for k in stages[0][i]}
                 for i in range(len(stages[0])))


# ----------------------------------------------------------------- init
def _layer_init(gen, lead, cfg: ModelConfig, kind: str, dtype, device) -> dict:
    p: dict = {"norm1": L.rmsnorm_init(lead, cfg.d_model, dtype, device)}
    if kind in ATTN_KINDS:
        p["mix"] = L.attention_init(gen, lead, cfg, dtype, device)
    elif kind == "rglru":
        p["mix"] = R.rglru_block_init(gen, lead, cfg, dtype, device)
    elif kind == "mlstm":
        p["mix"] = R.mlstm_block_init(gen, lead, cfg, dtype, device)
    elif kind == "slstm":
        p["mix"] = R.slstm_block_init(gen, lead, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if _has_mlp(cfg, kind):
        p["norm2"] = L.rmsnorm_init(lead, cfg.d_model, dtype, device)
        if _uses_moe(cfg, kind):
            p["mlp"] = moe_init(gen, lead, cfg, dtype, device)
        else:
            p["mlp"] = L.mlp_init(gen, lead, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``"cuda"`` by default; raises without CUDA — pass
    ``device="cpu"``).  The JAX package's tree and dtypes; not its numbers
    (``convert.lm_params_from_numpy`` carries those across).  On
    ``device="meta"`` nothing is drawn: the tree of shapes and dtypes
    (``jax.eval_shape`` of the reference's ``init_params``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    params: dict = {"embed": L.truncnorm(gen, (cfg.vocab, cfg.d_model), 1.0, dtype, dev)}
    params["segments"] = [
        tuple(_layer_init(gen, (n_stages,), cfg, kind, dtype, dev) for kind in pattern)
        for pattern, n_stages in segments_of(cfg)
    ]
    params["final_norm"] = L.rmsnorm_init((), cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.truncnorm(gen, (cfg.d_model, cfg.vocab),
                                        1.0 / math.sqrt(cfg.d_model), dtype, dev)
    return params


# ----------------------------------------------------------------- forward
no_constraint = L.no_constraint


def _ffn(p: dict, cfg: ModelConfig, kind: str, x, constrain=no_constraint):
    """The layer's MLP or MoE FFN on its pre-norm input -> (out, aux)."""
    if _uses_moe(cfg, kind):
        return moe_fwd(p["mlp"], cfg, x, constrain)
    return L.mlp_fwd(p["mlp"], x, cfg.hidden_act), None


def _layer_fwd(p: dict, cfg: ModelConfig, kind: str, x, positions, state,
               constrain=no_constraint):
    """One layer over the full sequence.  Returns (x, new_state, aux): the
    MoE aux loss, or None for a layer without one.  ``constrain`` is the
    reference's sharding hook (``sharding.partition.make_constrain``), at
    the reference's points: each residual branch, and the MoE's dispatch
    and combine buffers."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    new_state, aux = state, None
    if kind in ATTN_KINDS:
        mix = L.attention_fwd(p["mix"], cfg, h, positions, _window(cfg, kind))
    elif kind == "rglru":
        mix, new_state = R.rglru_block_fwd(p["mix"], cfg, h, state)
    elif kind == "mlstm":
        mix, new_state = R.mlstm_block_fwd(p["mix"], cfg, h, state)
    elif kind == "slstm":
        mix, new_state = R.slstm_block_fwd(p["mix"], cfg, h, state)
    else:
        raise ValueError(kind)
    x = x + constrain(mix, "residual")
    if _has_mlp(cfg, kind):
        ff, aux = _ffn(p, cfg, kind, L.rmsnorm(p["norm2"], x, cfg.norm_eps), constrain)
        x = x + constrain(ff, "residual")
    return x, new_state, aux


def _embed(params, cfg: ModelConfig, tokens):
    return L.embed_scale(cfg, L.embed_lookup(params["embed"], tokens))


def _inputs(params, cfg: ModelConfig, inputs):
    """The first layer's input: embeddings (B, S, d) cast to ``cfg.dtype``,
    or token ids (B, S) looked up."""
    if cfg.input_mode == "embeddings":
        return inputs.to(getattr(torch, cfg.dtype))
    return _embed(params, cfg, inputs)


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x, cfg.tie_embeddings)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _stage_fwd(cfg: ModelConfig, pattern: tuple, stage_p: tuple, x, aux_total,
               positions, constrain=no_constraint):
    """One stage (a pass over ``pattern``) -> (x, aux_total)."""
    for p, kind in zip(stage_p, pattern):
        x, _, aux = _layer_fwd(p, cfg, kind, x, positions, None, constrain)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def forward(params: dict, cfg: ModelConfig, inputs, constrain=no_constraint):
    """Full-sequence forward over token ids (B, S) or embeddings (B, S, d)
    -> (logits (B, S, vocab) f32, the MoE aux loss summed over the layers
    () f32).  With ``cfg.remat`` and grad enabled each stage runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    stage body): its activations are recomputed in the backward, not
    kept; the gradients are the same."""
    x = constrain(_inputs(params, cfg, inputs), "activation")
    positions = _positions(*x.shape[:2], x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for (pattern, n_stages), seg in zip(segments_of(cfg), params["segments"]):
        for s in range(n_stages):
            stage_p = tuple(_at(layer, s) for layer in seg)
            if remat:
                x, aux_total = checkpoint(_stage_fwd, cfg, pattern, stage_p, x,
                                          aux_total, positions, constrain,
                                          use_reentrant=False)
            else:
                x, aux_total = _stage_fwd(cfg, pattern, stage_p, x, aux_total, positions,
                                          constrain)
    return _logits(params, cfg, x), aux_total


# ----------------------------------------------------------------- loss
def loss_fn(params: dict, cfg: ModelConfig, batch: dict, constrain=no_constraint):
    """The reference's training loss: the mean f32 next-token NLL by
    logsumexp, plus ``z_loss`` 1e-4 mean(logz^2) and 0.01 x the MoE aux
    loss.  ``batch``: {"inputs": token ids (B, S) or embeddings (B, S, d),
    "labels": (B, S) ints}.  Returns (loss, {"nll", "z_loss", "moe_aux"}),
    each () f32."""
    logits, aux = forward(params, cfg, batch["inputs"], constrain)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    nll = (logz - ll).mean()
    z_loss = 1e-4 * (logz ** 2).mean()
    loss = nll + z_loss + 0.01 * aux
    return loss, {"nll": nll, "z_loss": z_loss, "moe_aux": aux}


# ----------------------------------------------------------------- decode
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device) -> list:
    """Per-segment, stage-stacked per-layer states for decoding."""
    dtype = getattr(torch, cfg.dtype)

    def one(kind):
        if kind in ATTN_KINDS:
            S = max_seq if kind == "attn" else min(cfg.attn_window or max_seq, max_seq)
            shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
        if kind == "rglru":
            return R.rglru_init_state(cfg, batch, device)
        if kind == "mlstm":
            return R.mlstm_init_state(cfg, batch, device)
        if kind == "slstm":
            return R.slstm_init_state(cfg, batch, device)
        raise ValueError(kind)

    return [tuple({k: v.expand((n_stages,) + v.shape).clone() for k, v in one(kind).items()}
                  for kind in pattern)
            for pattern, n_stages in segments_of(cfg)]


def _layer_decode(p: dict, cfg: ModelConfig, kind: str, x, pos: int, state: dict,
                  constrain=no_constraint):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        mix, ck, cv = L.attention_decode(p["mix"], cfg, h, state["k"], state["v"],
                                         pos, _window(cfg, kind))
        new_state = {"k": ck, "v": cv}
    elif kind == "rglru":
        mix, new_state = R.rglru_block_decode(p["mix"], cfg, h, state)
    elif kind == "mlstm":
        mix, new_state = R.mlstm_block_decode(p["mix"], cfg, h, state)
    elif kind == "slstm":
        mix, new_state = R.slstm_block_decode(p["mix"], cfg, h, state)
    else:
        raise ValueError(kind)
    x = x + mix
    if _has_mlp(cfg, kind):
        x = x + _ffn(p, cfg, kind, L.rmsnorm(p["norm2"], x, cfg.norm_eps), constrain)[0]
    return x, new_state


def decode_step(params: dict, cfg: ModelConfig, states: list, token, pos: int,
                constrain=no_constraint):
    """One autoregressive step: token (B,) at position ``pos``.  Returns
    (new_states, logits (B, vocab) f32); ``states`` is left as it was."""
    x = _embed(params, cfg, token[:, None])
    new_states = []
    for (pattern, n_stages), seg, seg_state in zip(segments_of(cfg),
                                                   params["segments"], states):
        stages = []
        for s in range(n_stages):
            new_s = []
            for i, kind in enumerate(pattern):
                x, st = _layer_decode(_at(seg[i], s), cfg, kind, x, pos,
                                      _at(seg_state[i], s), constrain)
                new_s.append(st)
            stages.append(new_s)
        new_states.append(_stack(stages, seg_state))
    return new_states, _logits(params, cfg, x)[:, 0]


def prefill(params: dict, cfg: ModelConfig, inputs, max_seq: int,
            constrain=no_constraint):
    """Run the prompts, token ids (B, S) or embeddings (B, S, d), through
    the model, building decode states.  Returns (states, last-token logits
    (B, vocab) f32)."""
    x = constrain(_inputs(params, cfg, inputs), "activation")
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    states = init_decode_state(cfg, B, max_seq, x.device)
    new_states = []
    for (pattern, n_stages), seg, seg_state in zip(segments_of(cfg),
                                                   params["segments"], states):
        stages = []
        for s in range(n_stages):
            new_s = []
            for i, kind in enumerate(pattern):
                p = _at(seg[i], s)
                if kind in ATTN_KINDS:
                    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
                    mix, kk, vv = _attention_prefill(p["mix"], cfg, h, positions,
                                                     _window(cfg, kind),
                                                     _at(seg_state[i], s))
                    x = x + constrain(mix, "residual")
                    if _has_mlp(cfg, kind):
                        ff = _ffn(p, cfg, kind, L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                                  constrain)[0]
                        x = x + constrain(ff, "residual")
                    new_s.append({"k": kk, "v": vv})
                else:
                    # the final recurrent state seeds the decode state
                    x, st, _ = _layer_fwd(p, cfg, kind, x, positions, None, constrain)
                    new_s.append(st)
            stages.append(new_s)
        new_states.append(_stack(stages, seg_state))
    return new_states, _logits(params, cfg, x[:, -1:])[:, 0]


def _attention_prefill(p, cfg: ModelConfig, h, positions, window, state):
    """Full-sequence attention that also fills the KV cache: the last S
    positions, and for a windowed layer in its ring layout (position p at
    slot p % S)."""
    B, T, _ = h.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = (h @ p["wk"]).reshape(B, T, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, T, Hkv, hd)
    k = L.positional_rotate(cfg, k, positions)
    mix = L.attention_fwd(p, cfg, h, positions, window)
    S = state["k"].shape[1]
    if T >= S:
        ck, cv = k[:, T - S:], v[:, T - S:]
        if window is not None:
            ck = torch.roll(ck, T % S, dims=1)
            cv = torch.roll(cv, T % S, dims=1)
    else:
        ck, cv = state["k"].clone(), state["v"].clone()
        ck[:, :T] = k
        cv[:, :T] = v
    return mix, ck, cv
