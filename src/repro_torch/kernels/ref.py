"""Plain PyTorch oracles of the LM kernels, as ``repro.kernels.ref``.

``attention_ref``, ``rglru_ref`` and ``slstm_scan_ref`` are the routes the
model takes off the kernels (tiny shapes, and decode at T = 1 for attention
and RG-LRU), and what each kernel's plain version is held against in the
tests.  All math in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  sm_scale: float | None = None) -> torch.Tensor:
    """Dense-mask attention with GQA and sliding window.  q: (B, Hq, T, D);
    k, v: (B, Hkv, S, D).  Rows with no visible key give 0."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    qf = q.float() * sm_scale
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    mask = attention_mask(T, S, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", p, vf)
    out = torch.where(mask.any(-1)[:, None], out, 0.0)
    return out.to(q.dtype)


def attention_mask(T: int, S: int, causal: bool, window: int | None, device,
                   q0: int = 0, k0: int = 0) -> torch.Tensor:
    """(T, S) bool: query ``q0 + i`` may see key ``k0 + j``."""
    q_pos = q0 + torch.arange(T, device=device)[:, None]
    k_pos = k0 + torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def affine_scan(a: torch.Tensor, x: torch.Tensor, dim: int = 1):
    """Inclusive scan of the affine maps h -> a_t h + x_t along ``dim`` by
    doubling (Hillis–Steele): returns (A, X) with X_t the scan from a zero
    state and A_t the product of a up to t."""
    A, X = a, x
    n = a.shape[dim]
    d = 1
    while d < n:
        A_s = torch.cat([torch.ones_like(A.narrow(dim, 0, d)),
                         A.narrow(dim, 0, n - d)], dim)
        X_s = torch.cat([torch.zeros_like(X.narrow(dim, 0, d)),
                         X.narrow(dim, 0, n - d)], dim)
        X = X + A * X_s
        A = A * A_s
        d *= 2
    return A, X


def rglru_ref(x, a, h0=None):
    """RG-LRU linear recurrence h_t = a_t h_{t-1} + x_t over (B, T, D), by an
    associative scan in f32.  Returns (h (B, T, D), h_last (B, D)) in x's
    dtype."""
    xf = x.float()
    af = a.float()
    if h0 is not None:
        # fold the initial state into step 0: h_0' = a_0 h0 + x_0
        xf = torch.cat([xf[:, :1] + af[:, :1] * h0.float()[:, None], xf[:, 1:]], 1)
    _, h = affine_scan(af, xf, dim=1)
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def slstm_scan_ref(r: dict, pre, carry0: tuple):
    """The sLSTM recurrence, one step at a time in f32.

    r: {'i','f','z','o': (H, hd, hd)}; pre: (B, T, 4, d); carry0: (c, n, h,
    m), each (B, d).  Returns (hs, (cs, ns, ms), final carry), sequences
    (B, T, d)."""
    B, T, _, d = pre.shape
    H = r["i"].shape[0]
    hd = d // H
    rf = {g: r[g].float() for g in "ifzo"}
    pre = pre.float()
    c, n, h, m = carry0
    seqs = []
    for t in range(T):
        hb = h.reshape(B, H, hd)

        def rmat(g):
            return torch.einsum("bhd,hde->bhe", hb, rf[g]).reshape(B, d)

        li = pre[:, t, 0] + rmat("i")
        lf = F.logsigmoid(pre[:, t, 1] + rmat("f"))
        z = torch.tanh(pre[:, t, 2] + rmat("z"))
        o = torch.sigmoid(pre[:, t, 3] + rmat("o"))
        m_new = torch.maximum(lf + m, li)
        c = c * torch.exp(lf + m - m_new) + torch.exp(li - m_new) * z
        n = n * torch.exp(lf + m - m_new) + torch.exp(li - m_new)
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        seqs.append((c, n, h, m))
    cs, ns, hs, ms = (torch.stack(s, 1) for s in zip(*seqs))
    return hs, (cs, ns, ms), (c, n, h, m)
