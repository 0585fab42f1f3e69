"""The redesigned LM kernels' numerics and launch plans, on the CPU.

The tensor-core flash kernel (``csrc/flash_attention.cu``, ``fa_fwd_tc``)
and the cluster sLSTM kernel (``csrc/slstm_scan.cu``) run only on the
card; here their arithmetic and their plans are held in plain torch:

  * an emulation of ``fa_fwd_tc``'s rounding points and tiling (a 64-row
    warpgroup a CTA, 64-key tiles, bf16 Q K^T summed in f32,
    the scale applied after the product in the log2 domain, P split into
    bf16 hi + lo parts whose products sum in f32) against the plain
    version, within one bf16 ulp (``lm_checks.assert_bf16_close``), and
    the same with P rounded to bf16 once, which is not;
  * ``slstm_scan.cluster_plan`` for every ``SLSTM_CASES`` shape and for
    xlstm-125m up to 64 batch rows;
  * ``flash_attention.route`` and ``smem_bytes``.

The plans' byte counts are checked against their bounds here; each
kernel's launch refuses a count that is not its own.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lm_checks
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels.ref import NEG_INF

LOG2E = 1.4426950408889634


def emulate_fa_tc(q, k, v, *, causal, window, sm_scale, split=True):
    """``fa_fwd_tc`` in plain torch, warpgroup by warpgroup: returns o in
    bf16 and lse in f32.  ``split=False`` rounds P to bf16 once."""
    B, Hq, T, D = q.shape
    S = k.shape[2]
    G = Hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    c = torch.tensor(sm_scale * LOG2E, dtype=torch.float32)
    o = torch.empty((B, Hq, T, D), dtype=torch.float32)
    lse = torch.empty((B, Hq, T), dtype=torch.float32)
    for r0 in range(0, T, 64):
        rows = torch.arange(r0, min(r0 + 64, T))
        n = len(rows)
        m = torch.full((B, Hq, n), NEG_INF)
        l = torch.zeros((B, Hq, n))
        acc = torch.zeros((B, Hq, n, D))
        for k0 in range(0, S, 64):
            if not fa._visible(r0, 64, k0, 64, causal, window):
                continue
            keys = torch.arange(k0, min(k0 + 64, S))
            x = (qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)) * c
            ok = torch.ones((n, len(keys)), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if window is not None:
                ok &= keys[None, :] > rows[:, None] - window
            x = torch.where(ok, x, NEG_INF)
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            vt = vf[:, :, keys]
            acc = acc * alpha[..., None] + hi @ vt
            if split:
                acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
            m = mn
        lsafe = torch.where(l == 0.0, 1.0, l)
        o[:, :, rows] = acc / lsafe[..., None]
        m_nat = torch.where(m == NEG_INF, NEG_INF, m * math.log(2.0))
        lse[:, :, rows] = torch.where(l == 0.0, NEG_INF, m_nat + torch.log(lsafe))
    return o.to(torch.bfloat16), lse


def _qkv(B, Hq, Hkv, T, S, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(B, h, n, D).astype(np.float32)).to(torch.bfloat16)
                 for h, n in ((Hq, T), (Hkv, S), (Hkv, S)))


@pytest.mark.parametrize("case", [
    (1, 10, 1, 512, 512, 256, True, 200, 0.0625),   # served head dim, MQA 10:1
    (1, 10, 1, 512, 512, 256, True, 200, None),      # scale 1/16 too, by default
    (2, 4, 2, 320, 320, 128, True, 96, 0.1),         # a scale that is not a power of 2
    (1, 2, 2, 256, 256, 128, False, None, None),     # not causal
], ids=str)
def test_tensor_core_rounding_matches_plain_version(case):
    """The split-P emulation is within one bf16 ulp of the plain version
    (the kernel's tolerance on the card); its lse within f32 rounding."""
    B, Hq, Hkv, T, S, D, causal, window, scale = case
    q, k, v = _qkv(B, Hq, Hkv, T, S, D, seed=T + D)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o_e, lse_e = emulate_fa_tc(q, k, v, causal=causal, window=window, sm_scale=scale)
    o_p, lse_p = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        sm_scale=scale, block_q=lm_checks.ref_block(T),
                                        block_k=lm_checks.ref_block(S), return_lse=True)
    lm_checks.assert_bf16_close(o_e, o_p, "emulated tensor-core o")
    lm_checks.assert_close(lse_e, lse_p, "emulated tensor-core lse")


def test_p_rounded_once_is_not_within_one_ulp():
    """Why the kernel pays for P_lo: with P rounded to bf16 once, outputs
    that cancel to near 0 move by many bf16 ulps."""
    q, k, v = _qkv(1, 10, 1, 512, 512, 256, seed=768)
    o_e, _ = emulate_fa_tc(q, k, v, causal=True, window=200, sm_scale=0.0625,
                           split=False)
    o_p = fa.flash_attention_ref(q, k, v, window=200, sm_scale=0.0625)
    with pytest.raises(AssertionError, match="ulp"):
        lm_checks.assert_bf16_close(o_e, o_p, "o with P rounded once")


# ------------------------------------------------------------ flash routes
@pytest.mark.parametrize("D", range(16, 257, 16))
def test_flash_bf16_route_takes_multiples_of_16(D):
    assert fa.route(torch.bfloat16, D) == "tensor_cores"
    smem = fa.smem_bytes(torch.bfloat16, D)
    # at least Q (64 rows) and two stages of K and V (64 keys) in bf16
    assert 5 * 64 * D * 2 <= smem <= _build.SMEM_LIMIT
    assert smem >= fa.smem_bytes(torch.bfloat16, max(16, D - 16))


def test_flash_f32_route_and_refusals():
    for D in (4, 16, 32, 100, 256):
        assert fa.route(torch.float32, D) == "cuda_cores"
        assert fa.smem_bytes(torch.float32, D) <= _build.SMEM_LIMIT
    for dtype, D in ((torch.bfloat16, 24), (torch.bfloat16, 8), (torch.bfloat16, 272),
                     (torch.float32, 6), (torch.float32, 260), (torch.float16, 64)):
        with pytest.raises(ValueError):
            fa.route(dtype, D)
    # every FLASH_CASES entry has a route, bf16 ones the tensor cores
    for case in lm_checks.FLASH_CASES:
        assert fa.route(case[8], case[5]) == fa.ROUTES[case[8]]


def test_flash_wrapper_refuses_before_launching():
    """The wrapper refuses a shape or dtype no route takes, then a tensor
    that is not on the card; nothing launches."""
    before = (fa.launches, dict(fa.route_launches))
    for dtype, D, why in ((torch.bfloat16, 24, "head dim"), (torch.float16, 64, "bf16 or f32"),
                          (torch.float32, 16, "CUDA")):
        q = torch.zeros(1, 1, 128, D, dtype=dtype)
        with pytest.raises(ValueError, match=why):
            fa.flash_attention_cuda(q, q, q)
    assert (fa.launches, fa.route_launches) == before


# ------------------------------------------------------- the sLSTM cluster
def _hd_125m():
    xl = get_config("xlstm-125m")
    return xl.d_model // xl.n_heads


def _plans():
    hd = _hd_125m()
    shapes = {(c[0], c[2] // c[3], c[4]) for c in lm_checks.SLSTM_CASES}
    shapes |= {(B, hd, dt) for B in (4, 32, 64) for dt in (torch.bfloat16, torch.float32)}
    return sorted(shapes, key=str)


@pytest.mark.parametrize("B,hd,dtype", _plans(), ids=str)
def test_slstm_cluster_plan_fits(B, hd, dtype):
    """C divides hd, the slice and buffers fit, the groups of at most 4
    rows cover B in the fewest clusters of balanced size, and no larger
    cluster size that divides hd and leaves a CTA at least 8 channels
    would fit."""
    plan = sl.cluster_plan(B, hd, dtype)
    assert plan.C in sl.CLUSTER_SIZES and hd % plan.C == 0
    assert plan.E == hd // plan.C and plan.threads == plan.E * plan.KS <= sl.MAX_THREADS
    assert plan.C == 1 or plan.E >= sl.MIN_CHANNELS
    assert plan.smem <= _build.SMEM_LIMIT
    # R's slice alone: 4 x hd x E in R's dtype
    assert plan.smem > 4 * hd * plan.E * dtype.itemsize
    assert (plan.groups - 1) * plan.Bg < B <= plan.groups * plan.Bg
    assert plan.Bg <= sl.MAX_ROWS and plan.groups == -(-B // sl.MAX_ROWS)
    assert sl.cluster_plan(plan.Bg, hd, dtype).groups == 1  # a group fits one cluster
    if plan.groups > 1:  # one group fewer would not fit
        assert sl.cluster_plan(-(-B // (plan.groups - 1)), hd, dtype).groups > 1
    for C in sl.CLUSTER_SIZES[sl.CLUSTER_SIZES.index(plan.C) + 1:]:
        if hd % C == 0 and hd // C >= sl.MIN_CHANNELS:
            with pytest.raises(ValueError, match="no cluster"):
                sl.cluster_plan(B, hd, dtype, sizes=(C,))


def test_slstm_cluster_plan_at_xlstm_125m():
    """xlstm-125m (hd 192): R over a cluster of 8, 24 channels a CTA
    (36,864 B of bf16 R, 73,728 B of f32); the served batch of 4 in one
    cluster a head, 32 rows in eight, 23 in six (five of 4 rows, one of
    3).  A cluster of 2 is the smallest that holds bf16 R; 1 does not."""
    hd = _hd_125m()
    assert hd == 192
    for dtype in (torch.bfloat16, torch.float32):
        plan = sl.cluster_plan(4, hd, dtype)
        assert (plan.C, plan.E, plan.threads, plan.Bg, plan.groups) == (8, 24, 384, 4, 1)
    for dtype in (torch.bfloat16, torch.float32):
        plan = sl.cluster_plan(32, hd, dtype)
        assert (plan.C, plan.Bg, plan.groups) == (8, 4, 8)
        plan = sl.cluster_plan(23, hd, dtype)
        assert (plan.C, plan.Bg, plan.groups) == (8, 4, 6)
    assert sl.cluster_plan(4, hd, torch.bfloat16, sizes=(2,)).C == 2
    with pytest.raises(ValueError, match="no cluster"):
        sl.cluster_plan(4, hd, torch.bfloat16, sizes=(1,))


def test_slstm_cluster_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no cluster"):
        sl.cluster_plan(4, 1024, torch.bfloat16)
    with pytest.raises(ValueError, match="no cluster"):
        sl.cluster_plan(4, 7 * 97, torch.float32)  # no size of 1, 2, 4, 8 fits
    with pytest.raises(ValueError):
        sl.cluster_plan(4, 64, torch.float16)
