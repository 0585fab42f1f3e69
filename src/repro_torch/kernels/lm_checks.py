"""The LM kernels against their plain versions on the card: the checks
``chip_smoke.py`` (phases ``lm-small``, ``rg-full``, ``xl-full``,
``train-small``, ``train-full``) and the ``cuda`` tests of
``tests/test_torch_kernel.py`` and ``tests/test_torch_train_cuda.py`` share.

Every check runs the kernel and its plain version on the same CUDA inputs
and raises ``AssertionError`` unless they agree within the stated
tolerance; it returns the largest absolute difference.  Tolerances:

  * f32 outputs: relative 1e-5, plus an absolute 1e-5 times the output's
    largest magnitude (the two sum in other orders, so values near 0 carry
    the rounding of the terms that cancelled there);
  * bf16 outputs (attention and the RG-LRU on bf16 inputs): one bf16 ulp
    of the larger of the two values, values below 1e-3 of the output's
    largest magnitude taken at that floor (both round an f32 result that
    differs in its last bits, which can move the bf16 result by one ulp);
  * the sLSTM over thousands of steps: relative and absolute 1e-4, since a
    step's rounding is carried through every later step.

The gradient checks (``compare_*_grads``) run one ``Function`` of
``kernels/ops.py`` twice on the same CUDA inputs and output gradients:
its kernel forward (the kernel path; the RG-LRU's backward launches the
kernel too) and its plain forward (:func:`plain_forward`), with the same
backward code.  Each input's gradient must agree: for f32 inputs (and
f32 R) within ``GRAD_TOL_F32`` of the largest magnitude of the plain
path's gradient, for bf16 inputs or R within ``GRAD_TOL_BF16`` of it
(the kernel's bf16 ``o`` may sit one ulp from the plain version's, and
``delta = sum(do o)`` and the rounded sLSTM cotangents carry that).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import flash_attention as fa
from . import rglru_scan as rg
from . import slstm_scan as sl

#: (B, Hq, Hkv, T, S, D, causal, window, dtype) — the CPU tests' shapes.
FLASH_CASES = (
    (1, 2, 2, 128, 128, 32, True, None, torch.float32),    # MHA
    (2, 4, 2, 256, 256, 32, True, 40, torch.float32),      # GQA, window skips blocks
    (1, 4, 1, 128, 128, 16, True, 48, torch.float32),      # MQA
    (1, 4, 1, 256, 256, 64, True, 96, torch.bfloat16),     # MQA, bf16
    (2, 2, 2, 128, 128, 32, False, None, torch.bfloat16),  # not causal
    (1, 10, 1, 512, 512, 256, True, 200, torch.bfloat16),  # the served head dim and
                                                           # MQA 10:1, window skips tiles
    (2, 4, 2, 320, 320, 128, True, 96, torch.bfloat16),    # T not a multiple of 128
    (1, 2, 2, 256, 256, 128, False, None, torch.bfloat16),  # not causal, D 128
    (1, 4, 1, 256, 256, 192, True, 96, torch.bfloat16),    # D 192: 3 column chunks
    (1, 2, 2, 384, 384, 80, False, None, torch.bfloat16),  # hubert's D 80, not causal:
                                                           # a chunk of 16 real columns
    (1, 10, 2, 256, 256, 128, True, None, torch.bfloat16),  # GQA group 5 (llama4)
    (1, 16, 1, 256, 256, 128, True, None, torch.bfloat16),  # GQA group 16 (qwen3-moe)
)
#: (B, T, D, with h0[, dtype]) — f32 where no dtype is given.  The
#: comments give the kernel's cut at its chunk of 256 steps.
RGLRU_CASES = ((1, 256, 256, True), (2, 128, 64, False), (2, 64, 32, True),
               (2, 3072, 64, True),      # 12 chunks: look-back over up to 11
               (2, 300, 64, False),      # a partial last chunk of 44 steps
               (3, 1, 64, True),         # T = 1: one step of one sub-chunk
               (2, 512, 48, True),       # D = 48: a tile of 32 and one of 16
               (2, 640, 96, True, torch.bfloat16),   # bf16, 3 chunks
               (2, 300, 37, False, torch.bfloat16),  # bf16 with D odd
               (1, 3072, 2560, True))    # batch 1 at recurrentgemma-2b's width
#: (B, T, d, H, R dtype, carry) — carry "zero" starts m at -inf.  The
#: comments give ``slstm_scan.cluster_plan``'s cluster size C and groups of
#: batch rows on the card.
SLSTM_CASES = ((1, 1, 16, 2, torch.float32, "zero"),      # hd 8: C 1
               (2, 64, 32, 4, torch.float32, "random"),   # hd 8: C 1
               (2, 128, 64, 4, torch.float32, "zero"),    # hd 16: C 2
               (2, 1, 64, 4, torch.bfloat16, "random"),   # hd 16: C 2
               (2, 128, 64, 4, torch.bfloat16, "zero"),   # hd 16: C 2
               (4, 1, 768, 4, torch.bfloat16, "random"),  # xlstm-125m's decode: C 8
               (4, 512, 768, 4, torch.bfloat16, "zero"),  # its width over 512 steps: C 8
               (4, 64, 768, 4, torch.float32, "random"),  # f32 R: C 8
               (1, 256, 64, 4, torch.bfloat16, "random"),  # hd 16: C 2
               (5, 32, 64, 2, torch.float32, "random"),   # hd 32: C 4; B > 4
               (32, 64, 768, 4, torch.bfloat16, "random"),  # C 8, 8 groups of 4 rows
               (23, 32, 768, 4, torch.bfloat16, "zero"),  # C 8, 5 groups of 4, one of 3
               (64, 16, 768, 4, torch.bfloat16, "random"))  # C 8, 16 groups: more CTAs
                                                            # than the card holds at once


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (x > 0): 2^(floor(log2 x) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def assert_close(got, want, name: str, *, rtol: float = 1e-5,
                 atol_rel: float = 1e-5) -> float:
    """f32 comparison: |got - want| <= rtol |want| + atol_rel max|want|."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: the kernel's result is not finite")
    err = (g - w).abs()
    tol = rtol * w.abs() + atol_rel * w.abs().max()
    if not (err <= tol).all():
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e}, "
                             f"max |diff| / tol {(err / tol).max().item():.3f}")
    return err.max().item()


def assert_bf16_close(got, want, name: str) -> float:
    """Within one bf16 ulp (see the module note)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: the kernel's result is not finite")
    err = (g - w).abs()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()), 1e-3 * w.abs().max())
    tol = bf16_ulp(mag)
    if not (err <= tol).all():
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e}, "
                             f"max |diff| / ulp {(err / tol).max().item():.3f}")
    return err.max().item()


# ------------------------------------------------------------ comparisons
def ref_block(n: int) -> int:
    """The plain version's block for an axis of n: 128, or the largest
    power of two that divides n."""
    return min(128, n & -n)


def compare_flash(q, k, v, *, causal=True, window=None, sm_scale=None) -> float:
    """Kernel against plain version (at blocks that divide T and S); o and
    lse."""
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, return_lse=True)
    o_k, lse_k = fa.flash_attention_cuda(q, k, v, **kw)
    o_p, lse_p = fa.flash_attention_ref(q, k, v, block_q=ref_block(q.shape[2]),
                                        block_k=ref_block(k.shape[2]), **kw)
    torch.cuda.synchronize()
    if q.dtype == torch.bfloat16:
        err = assert_bf16_close(o_k, o_p, "flash_attention o")
    else:
        err = assert_close(o_k, o_p, "flash_attention o")
    assert_close(lse_k, lse_p, "flash_attention lse")
    return err


def compare_rglru(x, a, h0=None, kernel=rg.rglru_scan_cuda) -> float:
    """``kernel`` (the CUDA kernel, or a :func:`rglru_scan.chunk_variant`)
    against the plain version (at a ``block_t`` that divides T); h and
    h_last, bf16 within one ulp."""
    h_k, last_k = kernel(x, a, h0)
    h_p, last_p = rg.rglru_scan_ref(x, a, h0, block_t=math.gcd(x.shape[1], 256))
    torch.cuda.synchronize()
    close = assert_bf16_close if x.dtype == torch.bfloat16 else assert_close
    err = close(h_k, h_p, "rglru_scan h")
    close(last_k, last_p, "rglru_scan h_last")
    return err


def compare_slstm(r, pre, carry0) -> float:
    """Kernel against plain version: hs, the c/n/m sequences and the final
    carry."""
    long = pre.shape[1] > 256
    tol = dict(rtol=1e-4, atol_rel=1e-4) if long else {}
    hs_k, seqs_k, fin_k = sl.slstm_scan_cuda(r, pre, carry0)
    hs_p, seqs_p, fin_p = sl.slstm_scan_ref(r, pre, carry0)
    torch.cuda.synchronize()
    err = assert_close(hs_k, hs_p, "slstm_scan hs", **tol)
    for name, a, b in zip(("cs", "ns", "ms", "c", "n", "h", "m"),
                          seqs_k + fin_k, seqs_p + fin_p):
        err = max(err, assert_close(a, b, f"slstm_scan {name}", **tol))
    return err


# ------------------------------------------------------- the small checks
def _gen(seed: int):
    return np.random.RandomState(seed)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32), device="cuda").to(dtype)


def check_flash(case, seed: int = 0) -> float:
    B, Hq, Hkv, T, S, D, causal, window, dtype = case
    rng = _gen(seed)
    q, k, v = (_t(rng.randn(B, h, n, D), dtype)
               for h, n in ((Hq, T), (Hkv, S), (Hkv, S)))
    return compare_flash(q, k, v, causal=causal, window=window)


def check_rglru(case, seed: int = 0) -> float:
    B, T, D, with_h0, *dtype = case
    dtype = dtype[0] if dtype else torch.float32
    rng = _gen(seed)
    x = _t(rng.randn(B, T, D), dtype)
    a = _t(rng.uniform(0.3, 0.999, (B, T, D)), dtype)
    h0 = _t(rng.randn(B, D)) if with_h0 else None
    return compare_rglru(x, a, h0)


def r_scale(hd: int, T: int) -> float:
    """Standard deviation of the test R: 0.3 for one step (T = 1) or up to
    hd = 16, else 1.2 / sqrt(hd), so that the recurrent gain 0.3 sqrt(hd)
    stays at most 1.2 over a sequence.  At hd = 192 with 0.3 (gain 4.2) the
    recurrence is chaotic: two plain f32 versions that sum in other orders
    drift apart ~10x every 8 steps (2e-6 after 8 steps, 2.0 after 512), so
    no kernel could be held to a tolerance there.  One step carries no
    drift."""
    return 0.3 if T == 1 else min(0.3, 1.2 / hd ** 0.5)


def slstm_inputs(case, seed: int = 0, device="cuda"):
    """r, pre and carry0 of an sLSTM case, from a numpy seed."""
    B, T, d, H, r_dtype, carry = case
    rng = _gen(seed)
    hd = d // H
    t = lambda x, dt=torch.float32: torch.tensor(  # noqa: E731
        np.asarray(x, np.float32), device=device).to(dt)
    r = {g: t(rng.randn(H, hd, hd) * r_scale(hd, T), r_dtype) for g in sl.GATES}
    pre = t(rng.randn(B, T, 4, d))
    if carry == "zero":
        z = np.zeros((B, d), np.float32)
        carry0 = (t(z), t(z), t(z), t(np.full((B, d), -np.inf, np.float32)))
    else:
        carry0 = (t(rng.randn(B, d)), t(rng.uniform(1, 3, (B, d))),
                  t(rng.randn(B, d)), t(rng.randn(B, d)))
    return r, pre, carry0


def check_slstm(case, seed: int = 0) -> float:
    return compare_slstm(*slstm_inputs(case, seed))


# ------------------------------------------------------------ gradients
#: Gradient tolerances, as a share of the plain path's largest magnitude.
GRAD_TOL_F32 = 1e-4
GRAD_TOL_BF16 = 2e-2
#: (B, Hq, Hkv, T, D, causal, window, dtype) of ``train-small``'s flash checks.
FLASH_GRAD_CASES = ((1, 4, 2, 128, 32, True, None, torch.float32),
                    (2, 4, 2, 256, 32, True, 40, torch.float32),
                    (1, 4, 1, 256, 64, True, 96, torch.bfloat16),
                    (2, 2, 2, 128, 128, False, None, torch.bfloat16))
#: (B, T, D, with h0) of its RG-LRU checks (f32, as the model runs it).
RGLRU_GRAD_CASES = ((1, 256, 256, True), (2, 512, 256, False), (2, 128, 64, True))
#: (B, T, d, H, R dtype, carry) of its sLSTM checks.
SLSTM_GRAD_CASES = ((2, 64, 64, 4, torch.float32, "random"),
                    (2, 64, 64, 4, torch.bfloat16, "zero"),
                    (4, 32, 768, 4, torch.bfloat16, "zero"))


@contextlib.contextmanager
def plain_forward():
    """Inside, the kernel modules' dispatchers send CUDA tensors to their
    plain versions: the ``Function``s' plain path on the card, for the
    gradient checks only."""
    saved = (fa.flash_attention, rg.rglru_scan, sl.slstm_scan)
    fa.flash_attention = fa.flash_attention_ref
    rg.rglru_scan = rg.rglru_scan_ref
    sl.slstm_scan = sl.slstm_scan_ref
    try:
        yield
    finally:
        fa.flash_attention, rg.rglru_scan, sl.slstm_scan = saved


def assert_grads_close(got, want, name: str, bf16: bool) -> float:
    """|got - want| <= tol * max|want| (``GRAD_TOL_BF16`` or ``_F32``),
    both finite; returns the largest absolute difference."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{name}: a gradient is not finite")
    err = (g - w).abs().max().item()
    tol = (GRAD_TOL_BF16 if bf16 else GRAD_TOL_F32) * w.abs().max().item()
    if err > tol:
        raise AssertionError(f"{name}: max |diff| {err:.3e} > {tol:.3e}")
    return err


def _both_paths(fn, inputs: list, grads_out):
    """(outputs, input gradients) of ``fn(*inputs)`` by the kernel path and
    by the plain path, each from fresh leaves of the same values."""
    def run():
        leaves = [None if x is None else x.detach().clone().requires_grad_(True)
                  for x in inputs]
        outs = fn(*leaves)
        used = [x for x in leaves if x is not None]
        grads = torch.autograd.grad(outs, used, grads_out)
        return [o.detach() for o in outs], grads

    kernel = run()
    with plain_forward():
        plain = run()
    torch.cuda.synchronize()
    return kernel, plain


def compare_flash_grads(q, k, v, do, *, causal=True, window=None, sm_scale=None) -> float:
    """``FlashFn``'s kernel path against its plain path: o, dq, dk, dv."""
    from . import ops

    fn = lambda q_, k_, v_: (ops.flash_attention(  # noqa: E731
        q_, k_, v_, causal=causal, window=window, sm_scale=sm_scale),)
    before = fa.launches
    (o_k, g_k), (o_p, g_p) = _both_paths(fn, [q, k, v], (do,))
    if fa.launches != before + 1:
        raise AssertionError(f"flash_attention: {fa.launches - before} kernel launches "
                             "in the kernel path, expected 1")
    bf16 = q.dtype == torch.bfloat16
    (assert_bf16_close if bf16 else assert_close)(o_k[0], o_p[0], "flash_attention o")
    return max(assert_grads_close(a, b, f"flash_attention d{n}", bf16)
               for n, a, b in zip("qkv", g_k, g_p))


def compare_rglru_grads(x, a, h0, dh, dh_last) -> float:
    """``RglruFn``'s kernel path (the forward and the backward's reverse
    scan both launch the kernel) against its plain path: dx, da, dh0."""
    from . import ops

    before = rg.launches
    (_, g_k), (_, g_p) = _both_paths(lambda *t: ops.rglru(*t), [x, a, h0], (dh, dh_last))
    if rg.launches != before + 2:
        raise AssertionError(f"rglru_scan: {rg.launches - before} kernel launches in "
                             "the kernel path, expected 2")
    return max(assert_grads_close(a_, b_, f"rglru d{n}", x.dtype == torch.bfloat16)
               for n, a_, b_ in zip(("x", "a", "h0"), g_k, g_p))


def compare_slstm_grads(r, pre, carry0, dhs, dfinal) -> float:
    """``SlstmFn``'s kernel path against its plain path: dR by gate, dpre
    and dcarry0."""
    from . import ops

    def fn(r_i, r_f, r_z, r_o, pre_, c0, n0, h0, m0):
        hs, _, fin = ops.slstm_scan(dict(zip(sl.GATES, (r_i, r_f, r_z, r_o))), pre_,
                                    (c0, n0, h0, m0))
        return (hs, *fin)

    before = sl.launches
    (_, g_k), (_, g_p) = _both_paths(fn, [r[g] for g in sl.GATES] + [pre, *carry0],
                                     (dhs, *dfinal))
    if sl.launches != before + 1:
        raise AssertionError(f"slstm_scan: {sl.launches - before} kernel launches in "
                             "the kernel path, expected 1")
    bf16 = r["i"].dtype == torch.bfloat16
    names = [f"dR_{g}" for g in sl.GATES] + ["dpre", "dc0", "dn0", "dh0", "dm0"]
    return max(assert_grads_close(a_, b_, f"slstm {n}", bf16)
               for n, a_, b_ in zip(names, g_k, g_p))


def check_flash_grads(case, seed: int = 0) -> float:
    B, Hq, Hkv, T, D, causal, window, dtype = case
    rng = _gen(seed)
    q, k, v, do = (_t(rng.randn(B, h, T, D), dtype) for h in (Hq, Hkv, Hkv, Hq))
    return compare_flash_grads(q, k, v, do, causal=causal, window=window)


def check_rglru_grads(case, seed: int = 0) -> float:
    B, T, D, with_h0 = case
    rng = _gen(seed)
    x = _t(rng.randn(B, T, D))
    a = _t(rng.uniform(0.3, 0.999, (B, T, D)))
    h0 = _t(rng.randn(B, D)) if with_h0 else None
    return compare_rglru_grads(x, a, h0, _t(rng.randn(B, T, D)), _t(rng.randn(B, D)))


def check_slstm_grads(case, seed: int = 0) -> float:
    r, pre, carry0 = slstm_inputs(case, seed)
    rng = _gen(seed + 1)
    B, T, _, d = pre.shape
    return compare_slstm_grads(r, pre, carry0, _t(rng.randn(B, T, d)),
                               [_t(rng.randn(B, d)) for _ in range(4)])


# ------------------------------------------------------------- op counts
@contextlib.contextmanager
def plain_versions():
    """Each LM kernel module's dispatcher (``flash_attention``,
    ``rglru_scan``, ``slstm_scan``) replaced by its plain version on every
    device while the block runs: the plain path that ``count_paths``
    holds the kernel path against."""
    swaps = ((fa, "flash_attention", fa.flash_attention_ref),
             (rg, "rglru_scan", rg.rglru_scan_ref),
             (sl, "slstm_scan", sl.slstm_scan_ref))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def count_paths(run):
    """``obs.op_counts`` counts of ``run()`` through the kernels (on
    the card each launch reports its plain version's counts) and through
    the plain versions (:func:`plain_versions`): (kernel path, plain
    path).  ``run`` builds its own inputs each call."""
    from ..obs import op_counts

    with op_counts.count() as kernel:
        run()
    with plain_versions(), op_counts.count() as plain:
        run()
    return kernel, plain


def flash_layout_bytes(cfg, batch: int, T: int, kernel_counts) -> int:
    """The bytes by which a step of ``cfg`` through the kernels counts more
    than through their plain versions: the kernel writes o in (B, H, T, D)
    order, the plain version into ``empty_like(q)``, which keeps the
    layer's (B, T, H, D) memory; so ``attention_fwd``'s ``o.transpose(1,
    2).reshape(...)`` copies o (read and written) after each kernel call
    only."""
    o = batch * cfg.n_heads * T * cfg.head_dim * getattr(torch, cfg.dtype).itemsize
    return kernel_counts.kernels.get("flash_attention", 0) * 2 * o
