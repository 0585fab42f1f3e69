"""The LM kernels as the model calls them, as ``repro.kernels.ops``:
differentiable, with the JAX package's backward passes.

Each keeps the JAX package's shape rule for when the kernel runs: the
caller's ``use_kernel`` (the model sets it from ``cfg.use_kernels`` and
``T % 128`` for attention, ``T % 256 and D % 256`` for the RG-LRU), and
``T % min(block_t, T) == 0`` for the sLSTM.  The rule decides between the
kernel module (which runs its plain version on CPU tensors and its Hopper
kernel on CUDA tensors) and the oracles of ``ref``, exactly as the JAX
package decides between its Pallas kernel and ``ref``; it is not a
fallback.

Where the kernel module runs, it runs inside a ``torch.autograd.Function``
(:class:`FlashFn`, :class:`RglruFn`, :class:`SlstmFn`), the counterpart of
the JAX package's ``jax.custom_vjp``s (``_flash``, ``_rglru`` and
``models/recurrent.py::_slstm_scan``).  Its forward is the kernel module's
dispatcher, so a CUDA tensor goes through the Hopper kernel and a CPU
tensor through the plain version, and its backward follows the reference's
VJP op for op in PyTorch ops:

  * flash: ``delta = sum(do o)``, dK/dV by a loop over KV blocks, dQ by a
    loop over Q blocks, in f32 with the GQA group axis and the masks of
    ``_block_mask`` (blocks that no pair of the two sees are skipped: the
    same sums);
  * RG-LRU: the reverse recurrence ``g_t = dh_t + a_{t+1} g_{t+1}`` run as
    the forward recurrence on the time-reversed ``dh`` and ``a_next``, so on
    the card it is a launch of the RG-LRU kernel;
  * sLSTM: a reverse loop over T taking the VJP of one step (written out,
    the step's forward values recomputed from the saved carries for all T
    at once, R held constant), then ``dR_g = sum_t h_{t-1} (x) dpre_g,t``
    as one einsum a gate.

A ``Function`` saves its residuals only when grad is enabled and an input
requires grad; otherwise its forward is the plain call (no ``lse``, nothing
saved), so serving is unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import ref
from . import rglru_scan as _rg
from . import slstm_scan as _sl


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ===================================================== flash attention
def _span(lo: int, hi: int, n: int) -> tuple[int, int]:
    return max(lo, 0), min(hi, n)


def flash_bwd(q, k, v, o, lse, do, causal: bool, window, scale: float,
              bq: int, bk: int):
    """``_flash_bwd_impl``: (dq, dk, dv) in the inputs' dtypes from the
    forward's ``o`` and ``lse`` (B, Hq, T) and the output's gradient."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    qg = q.to(f32).reshape(B, Hkv, G, T, D)
    kf, vf = k.to(f32), v.to(f32)
    dog = do.to(f32).reshape(B, Hkv, G, T, D)
    lseg = lse.reshape(B, Hkv, G, T)
    deltag = (do.to(f32) * o.to(f32)).sum(-1).reshape(B, Hkv, G, T)

    def probs(qs, kj, lses, q0, k0):
        s = torch.einsum("bkgtd,bksd->bkgts", qs, kj) * scale
        mask = ref.attention_mask(qs.shape[3], kj.shape[2], causal, window, q.device,
                                  q0, k0)
        return torch.where(mask, torch.exp(s - lses[..., None]), 0.0)

    # dK, dV: a loop over KV blocks, each over the queries that see it
    dk = torch.zeros((B, Hkv, S, D), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, S, bk):
        k1 = min(k0 + bk, S)
        lo, hi = _span(k0 if causal else 0,
                       T if window is None else k1 - 1 + window, T)
        if lo >= hi:
            continue
        kj, vj = kf[:, :, k0:k1], vf[:, :, k0:k1]
        dos = dog[:, :, :, lo:hi]
        p = probs(qg[:, :, :, lo:hi], kj, lseg[:, :, :, lo:hi], lo, k0)
        dv[:, :, k0:k1] = torch.einsum("bkgts,bkgtd->bksd", p, dos)
        dp = torch.einsum("bkgtd,bksd->bkgts", dos, vj)
        ds = p * (dp - deltag[:, :, :, lo:hi, None]) * scale
        dk[:, :, k0:k1] = torch.einsum("bkgts,bkgtd->bksd", ds, qg[:, :, :, lo:hi])

    # dQ: a loop over Q blocks, each over the keys it sees
    dq = torch.zeros((B, Hkv, G, T, D), dtype=f32, device=q.device)
    for q0 in range(0, T, bq):
        q1 = min(q0 + bq, T)
        lo, hi = _span(0 if window is None else q0 - window + 1,
                       q1 if causal else S, S)
        if lo >= hi:
            continue
        kj, vj = kf[:, :, lo:hi], vf[:, :, lo:hi]
        p = probs(qg[:, :, :, q0:q1], kj, lseg[:, :, :, q0:q1], q0, lo)
        dp = torch.einsum("bkgtd,bksd->bkgts", dog[:, :, :, q0:q1], vj)
        ds = p * (dp - deltag[:, :, :, q0:q1, None]) * scale
        dq[:, :, :, q0:q1] = torch.einsum("bkgts,bksd->bkgtd", ds, kj)
    return (dq.reshape(B, Hq, T, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashFn(torch.autograd.Function):
    """``_flash``: the kernel module's attention forward, the reference's
    blocked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bq, bk, save):
        kw = dict(causal=causal, window=window, sm_scale=scale, block_q=bq, block_k=bk)
        if not save:
            return _fa.flash_attention(q, k, v, **kw)
        o, lse = _fa.flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, scale, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do, *ctx.cfg) + (None,) * 6


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, block_q: int = 512,
                    block_k: int = 512, use_kernel: bool = True):
    """(B, Hq, T, D) x (B, Hkv, S, D)^2 -> (B, Hq, T, D).  ``use_kernel=False``
    takes the dense oracle (tiny shapes), differentiated by autograd."""
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    bq = min(128, block_q, q.shape[2])
    bk = min(128, block_k, k.shape[2])
    return FlashFn.apply(q, k, v, causal, window, scale, bq, bk,
                         _needs_grad(q, k, v))


# ===================================================== RG-LRU
def rglru_bwd(a, h, h0, dh, dh_last, block_t: int, block_d: int):
    """``_rglru_bwd``: (dx, da, dh0) from the forward's ``a`` and ``h`` (and
    ``h0``, zeros where None).  The reverse recurrence runs through the
    kernel module: the RG-LRU kernel on the card, its plain version on the
    CPU."""
    f32 = torch.float32
    af = a.to(f32)
    dh = dh.to(f32).clone()
    dh[:, -1] += dh_last.to(f32)
    a_next = torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], dim=1)
    g, _ = _rg.rglru_scan(dh.flip(1).contiguous(), a_next.flip(1).contiguous(), None,
                          block_t=block_t, block_d=block_d)
    g = g.flip(1)
    first = (torch.zeros_like(af[:, 0]) if h0 is None else h0.to(f32))[:, None]
    h_prev = torch.cat([first, h.to(f32)[:, :-1]], dim=1)
    dx = g.to(a.dtype)
    da = (g * h_prev).to(a.dtype)
    dh0 = None if h0 is None else (af[:, 0] * g[:, 0]).to(h0.dtype)
    return dx, da, dh0


class RglruFn(torch.autograd.Function):
    """``_rglru``: the kernel module's recurrence forward, the reference's
    reverse-scan backward."""

    @staticmethod
    def forward(ctx, x, a, h0, block_t, block_d, save):
        h, h_last = _rg.rglru_scan(x, a, h0, block_t=block_t, block_d=block_d)
        if save:
            ctx.save_for_backward(a, h, h0)
            ctx.blocks = (block_t, block_d)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        return rglru_bwd(a, h, h0, dh, dh_last, *ctx.blocks) + (None,) * 3


def rglru(x, a, h0=None, *, block_t: int = 256, block_d: int = 256,
          use_kernel: bool = True):
    """Linear recurrence h_t = a_t h_{t-1} + x_t -> (h, h_last)."""
    if not use_kernel:
        return ref.rglru_ref(x, a, h0)
    return RglruFn.apply(x, a, h0, block_t, block_d, _needs_grad(x, a, h0))


# ===================================================== sLSTM
def slstm_step(r: dict, carry: tuple, pre_t):
    """``_slstm_step``: one step of the recurrence, h rounded to R's dtype
    before each R product (accumulated in f32); ``max`` where the reference
    takes ``jnp.maximum``, so autograd splits a tie as JAX does."""
    c, n, h, m = carry
    B, d = h.shape
    H, hd = r["i"].shape[:2]

    def rmat(g):
        hb = h.reshape(B, H, hd).to(r[g].dtype).float()
        return torch.einsum("bhd,hde->bhe", hb, r[g].float()).reshape(B, d)

    li = pre_t[:, 0] + rmat("i")
    lf = F.logsigmoid(pre_t[:, 1] + rmat("f"))
    z = torch.tanh(pre_t[:, 2] + rmat("z"))
    o = torch.sigmoid(pre_t[:, 3] + rmat("o"))
    m_new = torch.maximum(lf + m, li)
    c = c * torch.exp(lf + m - m_new) + torch.exp(li - m_new) * z
    n = n * torch.exp(lf + m - m_new) + torch.exp(li - m_new)
    h = o * c / torch.maximum(n, torch.ones_like(n))
    return c, n, h, m_new


def _tie(x, y):
    """d max(x, y) / dx as ``jnp.maximum`` (and ``torch.maximum``) take it:
    1 where x > y, 1/2 where x == y, 0 where x < y."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def slstm_bwd(r: dict, pre, carry0: tuple, seqs: tuple, dhs, dcarry: tuple):
    """``_slstm_scan_bwd``: (dR by gate, dpre (B, T, 4, d), dcarry0) from the
    forward's sequences (hs, cs, ns, ms), each (B, T, d).

    The reference takes ``jax.vjp`` of one ``_slstm_step`` a step, R held
    constant.  Here that VJP is written out: every forward value of the
    step is recomputed from the pre-step carries (the sequences shifted one
    step) for all T at once (one R product), and the reverse loop carries
    only the cotangents (c, n, h, m) through the step's chain rule and one
    product with R^T, h's cotangent rounded to R's dtype after each gate's
    product as the reference's transposed ``dot_general`` rounds it.  Then
    ``dR_g = sum_t h_{t-1} (x) dpre_g,t``, one einsum a gate."""
    f32 = torch.float32
    B, T, _, d = pre.shape
    H, hd = r["i"].shape[:2]
    rt = torch.stack([r[g].detach() for g in _sl.GATES])  # (4, H, hd, hd)
    rf = rt.float()
    c_prev, n_prev, h_prev, m_prev = (
        torch.cat([x0[:, None].to(f32), x.to(f32)[:, :-1]], dim=1)
        for x0, x in zip(carry0, (seqs[1], seqs[2], seqs[0], seqs[3])))
    # the steps' forward values
    hq = h_prev.reshape(B, T, H, hd).to(rt.dtype).float()
    a = pre.to(f32) + torch.einsum("bthd,ghde->btghe", hq, rf).reshape(B, T, 4, d)
    a_i, a_f, a_z, a_o = a.unbind(2)
    lf, z, o = F.logsigmoid(a_f), torch.tanh(a_z), torch.sigmoid(a_o)
    x1 = lf + m_prev
    m_new = torch.maximum(x1, a_i)
    e_f, e_i = torch.exp(x1 - m_new), torch.exp(a_i - m_new)
    c_new = c_prev * e_f + e_i * z
    n_new = n_prev * e_f + e_i
    nc = torch.maximum(n_new, torch.ones_like(n_new))
    # the chain rule's coefficients, a (B, T, d) tensor each
    w1 = _tie(x1, a_i)
    co = c_new * o * (1.0 - o)                       # d h / d a_o, over 1 / nc
    nco = -(o * c_new) / (nc * nc) * _tie(n_new, 1.0)  # d h / d n_new
    cpf, npf = c_prev * e_f, n_prev * e_f
    zei, eidz = z * e_i, e_i * (1.0 - z * z)
    snf = torch.sigmoid(-a_f)                        # d logsigmoid
    gc, gn, gh, gm = (x.to(f32) for x in dcarry)
    gh = gh + dhs[:, T - 1].to(f32)
    dpre = []
    for t in range(T - 1, -1, -1):
        q = gh / nc[:, t]
        gct = torch.addcmul(gc, q, o[:, t])
        gnt = torch.addcmul(gn, gh, nco[:, t])
        gef = torch.addcmul(gct * cpf[:, t], gnt, npf[:, t])
        gei = torch.addcmul(gct * zei[:, t], gnt, e_i[:, t])
        gmn = gm - gef - gei
        gx1 = torch.addcmul(gef, gmn, w1[:, t])
        da = torch.stack([gei + gmn * (1.0 - w1[:, t]), gx1 * snf[:, t],
                          gct * eidz[:, t], q * co[:, t]], dim=1)  # (B, 4, d)
        dpre.append(da)
        dh = torch.einsum("bghe,ghde->bghd", da.view(B, 4, H, hd), rf)
        gh = dh.to(rt.dtype).float().sum(1).reshape(B, d)
        gc, gn, gm = gct * e_f[:, t], gnt * e_f[:, t], gx1
        if t:
            gh = gh + dhs[:, t - 1].to(f32)
    dpre = torch.stack(dpre[::-1], dim=1)  # (B, T, 4, d)
    # one reduction for the recurrent weights, outside the loop
    hb = h_prev.reshape(B, T, H, hd)
    dr = {gate: torch.einsum("bthd,bthe->hde", hb,
                             dpre[:, :, gi].reshape(B, T, H, hd)).to(r[gate].dtype)
          for gi, gate in enumerate(_sl.GATES)}
    dcarry0 = (gc, gn, gh, gm)
    return dr, dpre.to(pre.dtype), tuple(x.to(c.dtype) for x, c in zip(dcarry0, carry0))


class SlstmFn(torch.autograd.Function):
    """``_slstm_scan``: the recurrence forward (the kernel module where T
    meets its shape rule, else the oracle) -> (hs, final c, n, h, m, then
    cs, ns, ms); the reference's reverse-loop backward.  The c/n/m
    sequences carry no gradient."""

    @staticmethod
    def forward(ctx, block_t, save, r_i, r_f, r_z, r_o, pre, c0, n0, h0, m0):
        r = dict(zip(_sl.GATES, (r_i, r_f, r_z, r_o)))
        carry0 = (c0, n0, h0, m0)
        T = pre.shape[1]
        if T % min(block_t, T) == 0:
            hs, seqs, fin = _sl.slstm_scan(r, pre, carry0, block_t=block_t)
        else:
            hs, seqs, fin = ref.slstm_scan_ref(r, pre, carry0)
        ctx.mark_non_differentiable(*seqs)
        if save:
            ctx.save_for_backward(r_i, r_f, r_z, r_o, pre, *carry0, hs, *seqs)
        return (hs, *fin, *seqs)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm, *_):
        r_i, r_f, r_z, r_o, pre, c0, n0, h0, m0, hs, cs, ns, ms = ctx.saved_tensors
        r = dict(zip(_sl.GATES, (r_i, r_f, r_z, r_o)))
        dr, dpre, dcarry0 = slstm_bwd(r, pre, (c0, n0, h0, m0), (hs, cs, ns, ms), dhs,
                                      (dc, dn, dh, dm))
        return (None, None, *(dr[g] for g in _sl.GATES), dpre, *dcarry0)


def slstm_scan(r: dict, pre, carry0: tuple, *, block_t: int = 128):
    """The sLSTM recurrence -> (hs, (cs, ns, ms), final carry), always
    through :class:`SlstmFn` (the JAX package's model always takes its
    custom VJP); its forward takes the kernel module when T meets the
    shape rule, else the oracle."""
    rs = tuple(r[g] for g in _sl.GATES)
    hs, c, n, h, m, cs, ns, ms = SlstmFn.apply(
        block_t, _needs_grad(*rs, pre, *carry0), *rs, pre, *carry0)
    return hs, (cs, ns, ms), (c, n, h, m)
