"""Recurrent time-mixing blocks, as ``repro.models.recurrent``: the RG-LRU
(Griffin / RecurrentGemma), the mLSTM and the sLSTM (xLSTM), differentiable.

Each block has
  *_init(gen, lead, cfg, dtype, device) -> params (leading dims ``lead``)
  *_fwd(params, cfg, x, state=None)    -> (y, final state)   (prefill)
  *_decode(params, cfg, x, state)      -> (y, state)         (one token)
  *_init_state(cfg, batch, device)     -> zero state
with f32 recurrence math and parameters in the model dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import gelu, truncnorm

# =========================================================== RG-LRU block
_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness


def rglru_block_init(gen, lead: tuple, cfg: ModelConfig, dtype, device) -> dict:
    d, dr = cfg.d_model, cfg.rnn_dim
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, scale: truncnorm(gen, lead + shape, scale, dtype, device)  # noqa: E731
    # a = sigmoid(lam) ** c spread over (0.9, 0.999)
    u = 0.9 + 0.099 * torch.rand(lead + (dr,), generator=gen, device=device)
    lam = torch.log(u ** (1.0 / _C_RGLRU) / (1.0 - u ** (1.0 / _C_RGLRU)))
    return {
        "wx": tn((d, dr), s),
        "wg": tn((d, dr), s),
        "conv": tn((cfg.conv_width, dr), 1.0 / math.sqrt(cfg.conv_width)),
        "wa": tn((dr, dr), 1.0 / math.sqrt(dr)),
        "lam": lam,
        "wi": tn((dr, dr), 1.0 / math.sqrt(dr)),
        "wo": tn((dr, d), 1.0 / math.sqrt(dr)),
    }


def _causal_conv(x, w, carry):
    """Depthwise causal conv, taps summed in order from 0.  x: (B, T, D);
    w: (W, D); carry: (B, W-1, D) or None."""
    W = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)  # (B, T+W-1, D)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(W))
    new_carry = xp[:, xp.shape[1] - (W - 1):] if W > 1 else carry
    return out, new_carry


def _rglru_gates(params, xc):
    """Decay a_t and the normalized input of the recurrence, in f32."""
    rt = torch.sigmoid((xc @ params["wa"].to(xc.dtype)).float())
    it = torch.sigmoid((xc @ params["wi"].to(xc.dtype)).float())
    log_a = -_C_RGLRU * rt * F.softplus(params["lam"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    xin = xc.float() * it * mult
    return a, xin


def rglru_block_fwd(params: dict, cfg: ModelConfig, x, state=None):
    """x: (B, T, d).  state: None or {conv (B, W-1, dr), h (B, dr)}.  The
    kernel runs when ``cfg.use_kernels``, T % 256 == 0 and dr % 256 == 0."""
    xb = x @ params["wx"]
    gate = gelu((x @ params["wg"]).float())
    conv_carry = None if state is None else state["conv"]
    xc, conv_carry = _causal_conv(xb, params["conv"], conv_carry)
    a, xin = _rglru_gates(params, xc)
    h0 = None if state is None else state["h"]
    use_kernel = (cfg.use_kernels and xin.shape[1] % 256 == 0
                  and xin.shape[2] % 256 == 0)
    h, h_last = kops.rglru(xin, a, h0, use_kernel=use_kernel)
    y = (h.float() * gate).to(x.dtype) @ params["wo"]
    return y, {"conv": conv_carry, "h": h_last.float()}


def rglru_block_decode(params: dict, cfg: ModelConfig, x, state: dict):
    """x: (B, 1, d), one step."""
    return rglru_block_fwd(params, cfg, x, state)


def rglru_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_dim),
                            dtype=_dt(cfg), device=device),
        "h": torch.zeros((batch, cfg.rnn_dim), dtype=torch.float32, device=device),
    }


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# =========================================================== mLSTM block
# xLSTM (arXiv:2405.04517) matrix-memory block, pre-up-projection style; the
# prefill runs the chunkwise-parallel stabilized form, decode the recurrent
# form with state (C, n, m) per head.


def mlstm_block_init(gen, lead: tuple, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    di = 2 * d  # inner dim
    H = cfg.n_heads
    s = 1.0 / math.sqrt(d)
    si = 1.0 / math.sqrt(di)
    tn = lambda shape, scale: truncnorm(gen, lead + shape, scale, dtype, device)  # noqa: E731
    b_if = torch.cat([torch.zeros(H), 3.0 + torch.arange(H, dtype=torch.float32) * 0.5])
    return {
        "w_up": tn((d, di), s),
        "w_gate": tn((d, di), s),
        "conv": tn((cfg.conv_width, di), 0.5),
        "wq": tn((di, di), si),
        "wk": tn((di, di), si),
        "wv": tn((di, di), si),
        "w_if": tn((di, 2 * H), si),
        "b_if": b_if.to(device).expand(lead + (2 * H,)).clone(),
        "skip": torch.ones(lead + (di,), dtype=dtype, device=device),
        "w_down": tn((di, d), si),
    }


MLSTM_CHUNK = 256  # chunkwise-parallel block length


def mlstm_chunked(q, k, v, log_i, log_f, state, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilized mLSTM.  q, k, v: (B, T, H, hd) f32;
    log_i, log_f: (B, T, H) f32; state: (C (B, H, hd, hd), n (B, H, hd),
    m (B, H)).  Quadratic within a chunk, recurrent across chunks.  Returns
    (h (B, T, H, hd), (C, n, m) final)."""
    B, T, H, hd = q.shape
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"T={T} must be divisible by chunk={c}")
    C0, n0, m0 = state
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    hs = []
    for t0 in range(0, T, c):
        qt, kt, vt = q[:, t0:t0 + c], k[:, t0:t0 + c], v[:, t0:t0 + c]
        li, lf = log_i[:, t0:t0 + c], log_f[:, t0:t0 + c]
        F_ = torch.cumsum(lf, dim=1)  # (B, c, H) decay from chunk start to t
        # per-step stabilizer: m_t = max(F_t + m0, max_{s<=t}(F_t - F_s + li_s))
        g = li - F_
        g_run = torch.cummax(g, dim=1).values
        m_t = torch.maximum(F_ + m0[:, None], F_ + g_run)

        # inter-chunk term
        scale_in = torch.exp(F_ + m0[:, None] - m_t)
        h_inter = torch.einsum("bchd,bhde->bche", qt, C0) * scale_in[..., None]
        n_inter = torch.einsum("bchd,bhd->bch", qt, n0) * scale_in

        # intra-chunk term: D[t, s] = exp(F_t - F_s + li_s - m_t), s <= t
        dmat = F_[:, :, None] - F_[:, None, :] + li[:, None, :] - m_t[:, :, None]
        dexp = torch.where(mask[None, :, :, None], torch.exp(dmat), 0.0)
        s_qk = torch.einsum("bthd,bshd->btsh", qt, kt) * dexp
        h_intra = torch.einsum("btsh,bshd->bthd", s_qk, vt)
        n_intra = s_qk.sum(dim=2)

        norm = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_t))
        hs.append((h_inter + h_intra) / (norm[..., None] + 1e-6))

        # state update to the chunk's end
        F_end = F_[:, -1]
        m_end = torch.maximum(F_end + m0, F_end + g_run[:, -1])
        sc_state = torch.exp(F_end[:, None] + li - F_ - m_end[:, None])
        decay = torch.exp(F_end + m0 - m_end)
        C0 = C0 * decay[..., None, None] + torch.einsum(
            "bchd,bche,bch->bhde", kt, vt, sc_state)
        n0 = n0 * decay[..., None] + torch.einsum("bchd,bch->bhd", kt, sc_state)
        m0 = m_end
    return torch.cat(hs, 1), (C0, n0, m0)


def _mlstm_inputs(params, cfg: ModelConfig, x, conv_carry):
    """The projections both forms share: (up, gate, q, k, v, log_i, log_f,
    conv carry), q/k/v (B, T, H, hd) f32."""
    B, T, d = x.shape
    H = cfg.n_heads
    hd = 2 * d // H
    up = x @ params["w_up"]
    gate = F.silu((x @ params["w_gate"]).float())
    qk_src, conv_carry = _causal_conv(up, params["conv"], conv_carry)
    qk_src = F.silu(qk_src.float()).to(x.dtype)
    q = (qk_src @ params["wq"]).reshape(B, T, H, hd).float()
    k = (qk_src @ params["wk"]).reshape(B, T, H, hd).float() / math.sqrt(hd)
    v = (up @ params["wv"]).reshape(B, T, H, hd).float()
    gif = (qk_src @ params["w_if"]).float() + params["b_if"]
    return up, gate, q, k, v, gif[..., :H], F.logsigmoid(gif[..., H:]), conv_carry


def _mlstm_out(params, x, up, gate, h):
    y = h * gate + up.float() * params["skip"].float()
    return y.to(x.dtype) @ params["w_down"]


def mlstm_block_fwd(params: dict, cfg: ModelConfig, x, state=None):
    """Chunkwise-parallel form.  x: (B, T, d) -> (y, state)."""
    B, T, d = x.shape
    H = cfg.n_heads
    hd = 2 * d // H
    conv_carry = None if state is None else state["conv"]
    up, gate, q, k, v, log_i, log_f, conv_carry = _mlstm_inputs(
        params, cfg, x, conv_carry)
    if state is None:
        rec0 = (torch.zeros((B, H, hd, hd), device=x.device),
                torch.zeros((B, H, hd), device=x.device),
                torch.full((B, H), -math.inf, device=x.device))
    else:
        rec0 = (state["C"], state["n"], state["m"])
    h, (C, n, m) = mlstm_chunked(q, k, v, log_i, log_f, rec0,
                                 chunk=min(MLSTM_CHUNK, T))
    y = _mlstm_out(params, x, up, gate, h.reshape(B, T, 2 * d))
    return y, {"conv": conv_carry, "C": C, "n": n, "m": m}


def mlstm_block_decode(params: dict, cfg: ModelConfig, x, state: dict):
    """Recurrent form, x: (B, 1, d)."""
    B, _, d = x.shape
    up, gate, q, k, v, log_i, log_f, conv_carry = _mlstm_inputs(
        params, cfg, x, state["conv"])
    q, k, v, log_i, log_f = q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    fdec = torch.exp(log_f + m - m_new)
    iexp = torch.exp(log_i - m_new)
    C = C * fdec[..., None, None] + iexp[..., None, None] * (k[..., :, None] @ v[..., None, :])
    n = n * fdec[..., None] + iexp[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    h = (num / (den[..., None] + 1e-6)).reshape(B, 1, 2 * d)
    y = _mlstm_out(params, x, up, gate, h)
    return y, {"conv": conv_carry, "C": C, "n": n, "m": m_new}


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    di = 2 * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=_dt(cfg),
                            device=device),
        "C": torch.zeros((batch, H, hd, hd), device=device),
        "n": torch.zeros((batch, H, hd), device=device),
        "m": torch.full((batch, H), -math.inf, device=device),
    }


# =========================================================== sLSTM block
# Scalar-memory LSTM with exponential gating: the input projections are
# hoisted out of the recurrence into one (B, T, d) x (d, 4d) product, and
# the recurrent matrices are block-diagonal per head; the recurrence is the
# slstm_scan kernel.

_GATES = ("i", "f", "z", "o")


def slstm_block_init(gen, lead: tuple, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, scale: truncnorm(gen, lead + shape, scale, dtype, device)  # noqa: E731
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = tn((d, d), s)
        # block-diagonal recurrence: one (hd, hd) block per head
        p[f"r_{g}"] = tn((H, hd, hd), 1.0 / math.sqrt(hd))
    for g, b in zip(_GATES, (0.0, 3.0, 0.0, 0.0)):
        p[f"b_{g}"] = torch.full(lead + (d,), b, dtype=torch.float32, device=device)
    # gated FFN (factor 4/3) after the recurrence
    dff = max(4 * d // 3, 8)
    p["ff_wi"] = tn((d, dff), s)
    p["ff_wg"] = tn((d, dff), s)
    p["ff_wo"] = tn((dff, d), 1.0 / math.sqrt(dff))
    return p


def _slstm_pre(params, x):
    """Hoisted input projections: (B, T, 4, d) f32."""
    pre = torch.stack([x @ params[f"w_{g}"] for g in _GATES], dim=2).float()
    bias = torch.stack([params[f"b_{g}"] for g in _GATES], dim=0)
    return pre + bias


def slstm_block_fwd(params: dict, cfg: ModelConfig, x, state=None):
    B, T, d = x.shape
    pre = _slstm_pre(params, x)
    if state is None:
        z = torch.zeros((B, d), device=x.device)
        carry = (z, z, z, torch.full((B, d), -math.inf, device=x.device))
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    hs, _, carry = kops.slstm_scan({g: params[f"r_{g}"] for g in _GATES}, pre, carry)
    h = hs.to(x.dtype)
    gate = gelu((h @ params["ff_wg"]).float()).to(x.dtype)
    y = (gate * (h @ params["ff_wi"])) @ params["ff_wo"]
    return y, {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}


def slstm_block_decode(params: dict, cfg: ModelConfig, x, state: dict):
    return slstm_block_fwd(params, cfg, x, state)


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    d = cfg.d_model
    z = torch.zeros((batch, d), device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, d), -math.inf, device=device)}
