"""The RG-LRU kernel's schedule (``csrc/rglru_scan.cu``, ``rglru_fwd``)
emulated in plain torch on the CPU, against the JAX Pallas kernel in
interpret mode, the JAX oracle ``rglru_ref`` and the port's plain version.

The kernel cuts T into chunks of ``CHUNK`` steps (one CTA each) and each
chunk into sub-chunks of ``STEPS`` steps (one warp each), both read from
the source.  Channels are independent, so the emulation takes them all at
once.  Its association order is the kernel's:

  1. within a sub-chunk, the sequential FMA chain X = fma(a, X, x) from 0,
     and A = A * a;
  2. the sequential scan of the sub-chunks' maps: each one's exclusive
     prefix and the chunk's map;
  3. the look-back: chunk 0 publishes its inclusive h, fma(A_0, h0, X_0);
     chunk c composes the maps of chunks c - 1, ..., 1 in that order and
     applies the result to chunk 0's h: the same order on every call;
  4. the rerun of each sub-chunk's chain from its carry-in.

Steps past T are identity steps (a = 1, x = 0), which leave X, A and h
exactly as the kernel's masked steps do.  A fused multiply-add is taken in
f64 and rounded to f32 (the product of two f32 is exact in f64).

Tolerance as ``kernels.lm_checks``: f32 at relative 1e-5 plus 1e-5 times
the largest magnitude; bf16 outputs within one bf16 ulp.
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as j_rglru
from repro_torch.kernels import lm_checks
from repro_torch.kernels import rglru_scan as rg


_SOURCE = Path(rg.__file__).parent / "csrc" / "rglru_scan.cu"


def _constant(pattern):
    return int(re.search(pattern, _SOURCE.read_text()).group(1))


STEPS = _constant(r"constexpr int STEPS = (\d+);")
CHUNK = _constant(r"#define RGLRU_CHUNK (\d+)")


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate(x, a, h0=None, *, chunk=CHUNK, drop=None):
    """(h, h_last) in the kernel's association order.  ``drop=(c, j)``: chunk
    c's look-back skips chunk j's map (a mutation of step 3)."""
    B, T, D = x.shape
    L, S, n = STEPS, chunk // STEPS, -(-T // chunk)
    pad = n * chunk - T
    af = torch.cat([a.float(), torch.ones(B, pad, D)], 1).reshape(B, n, S, L, D)
    xf = torch.cat([x.float(), torch.zeros(B, pad, D)], 1).reshape(B, n, S, L, D)
    # 1. each sub-chunk's map
    A, X = torch.ones(B, n, S, D), torch.zeros(B, n, S, D)
    for u in range(L):
        X = fma(af[:, :, :, u], X, xf[:, :, :, u])
        A = A * af[:, :, :, u]
    # 2. exclusive prefixes and each chunk's map
    PA, PX = torch.empty_like(A), torch.empty_like(X)
    CA, CX = torch.ones(B, n, D), torch.zeros(B, n, D)
    for k in range(S):
        PA[:, :, k], PX[:, :, k] = CA, CX
        CX = fma(A[:, :, k], CX, X[:, :, k])
        CA = CA * A[:, :, k]
    # 3. the carry-in of each chunk by look-back
    carry = torch.empty(B, n, D)
    incl = torch.empty(B, n, D)
    for c in range(n):
        if c == 0:
            cr = torch.zeros(B, D) if h0 is None else h0.float()
        else:
            acc_a, acc_x = torch.ones(B, D), torch.zeros(B, D)
            for j in range(c - 1, 0, -1):
                if drop == (c, j):
                    continue
                acc_x = fma(acc_a, CX[:, j], acc_x)
                acc_a = acc_a * CA[:, j]
            cr = fma(acc_a, incl[:, 0], acc_x)
        carry[:, c] = cr
        incl[:, c] = fma(CA[:, c], cr, CX[:, c])
    # 4. rerun from each sub-chunk's carry-in
    hv = fma(PA, carry[:, :, None], PX)
    h = torch.empty(B, n, S, L, D)
    for u in range(L):
        hv = fma(af[:, :, :, u], hv, xf[:, :, :, u])
        h[:, :, :, u] = hv
    h = h.reshape(B, n * chunk, D)[:, :T]
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def inputs(B, T, D, with_h0, lo=0.3):
    rng = np.random.RandomState(T * 7 + D)
    x = rng.randn(B, T, D).astype(np.float32)
    a = rng.uniform(lo, 0.999, (B, T, D)).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32) if with_h0 else None
    return x, a, h0


def _t(v, dtype=torch.float32):
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return torch.tensor(v).to(dtype)
    return torch.tensor(np.asarray(jnp.asarray(v, jnp.float32))).to(dtype)


@functools.lru_cache(maxsize=None)
def references(B, T, D, with_h0, dtype="float32", pallas=True, lo=0.3):
    """(name, h, h_last) of each reference, as torch tensors in the dtype."""
    x, a, h0 = inputs(B, T, D, with_h0, lo)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jx, ja = jnp.asarray(x, jdt), jnp.asarray(a, jdt)
    jh0 = None if h0 is None else jnp.asarray(h0)
    out = []
    if pallas:
        out.append(("Pallas (interpret)", *j_rglru(jx, ja, jh0, interpret=True)))
    out.append(("JAX rglru_ref", *jax.jit(jref.rglru_ref)(jx, ja, jh0)))
    out = [(name, _t(h, tdt), _t(last, tdt)) for name, h, last in out]
    tx, ta, th0 = _t(x, tdt), _t(a, tdt), _t(h0)
    out.append(("port rglru_scan_ref",
                *rg.rglru_scan_ref(tx, ta, th0, block_t=math.gcd(T, 256))))
    return out


def check(B, T, D, with_h0, chunk, dtype="float32", pallas=True, lo=0.3, drop=None):
    tdt = getattr(torch, dtype)
    x, a, h0 = (_t(v, tdt) if v is not None and v.ndim == 3 else _t(v)
                for v in inputs(B, T, D, with_h0, lo))
    h, last = emulate(x, a, h0, chunk=chunk, drop=drop)
    close = lm_checks.assert_bf16_close if tdt == torch.bfloat16 else lm_checks.assert_close
    for name, want, want_last in references(B, T, D, with_h0, dtype, pallas, lo):
        close(h, want, f"schedule h vs {name}")
        close(last, want_last, f"schedule h_last vs {name}")


# (B, T, D, with h0, chunk): shapes the TPU kernel takes (T and D divisible
# by its blocks of min(256, T) and min(256, D))
PALLAS_CASES = [
    (2, 768, 64, True, 256),   # T a multiple of the chunk: 3 chunks
    (2, 512, 32, False, 64),   # 8 chunks of 64
    (2, 100, 40, True, 256),   # T < chunk: one partial chunk, 4 sub-chunks idle
    (3, 1, 16, True, 256),     # T = 1
    (2, 200, 24, False, 64),   # a partial last chunk (8 steps of 64)
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=str)
def test_schedule_matches_pallas_and_oracles(case):
    check(*case)


def test_schedule_bf16_matches_pallas_and_oracles():
    """bf16 a and x, f32 math, h rounded to bf16 once."""
    check(2, 512, 64, True, 256, dtype="bfloat16")


@pytest.mark.parametrize("case", [(2, 300, 48, True, 256), (1, 600, 8, False, 128),
                                  (2, 1000, 8, True, 512)], ids=str)
def test_schedule_partial_last_chunk_matches_oracles(case):
    """T not a multiple of the chunk, over 256 steps: the TPU kernel does
    not take it, so against the oracles only."""
    check(*case, pallas=False)


@pytest.mark.parametrize("chunk", [64, CHUNK])
def test_schedule_long_sequence_matches_oracle(chunk):
    """The served T = 3072 (12 chunks at 256, 48 at 64) at a narrow D, with
    a in (0.9, 0.999) as the model draws it, so a chunk's carry reaches far
    into the next."""
    check(2, 3072, 8, True, chunk, pallas=False, lo=0.9)


@pytest.mark.parametrize("case,drop", [((2, 768, 64, True, 256), (2, 1)),
                                       ((2, 3072, 8, True, 256), (11, 10))], ids=str)
def test_dropped_lookback_composition_fails(case, drop):
    """A look-back that skips one predecessor's map is caught."""
    lo = 0.9 if case[1] == 3072 else 0.3
    with pytest.raises(AssertionError, match="schedule h"):
        check(*case, pallas=False, lo=lo, drop=drop)


def test_source_constants():
    """The emulation's cut is the source's: sub-chunks of 32 steps, chunks
    of 256 (the TPU kernel's block_t)."""
    assert (STEPS, CHUNK) == (32, 256)
    assert CHUNK in rg.CHUNK_SWEEP and all(c % STEPS == 0 for c in rg.CHUNK_SWEEP)
