"""The port's LM kernel modules against the JAX package on the CPU.

Each kernel's plain version (what its wrapper runs on CPU tensors) is held
against the JAX Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it, and against the JAX oracle; the port's oracles against the JAX
oracles.  Inputs come from a numpy seed and cross as numpy arrays.

Tolerances: f32 at 1e-5 relative, with an absolute 1e-5 times the largest
magnitude for values near 0 (the two packages sum in other orders); bf16
attention outputs within one bf16 ulp (``lm_checks.assert_bf16_close``),
since both round an f32 result that differs in its last bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rglru_scan import rglru_scan as j_rglru
from repro.models.recurrent import mlstm_chunked as j_mlstm_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lm_checks, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.models.recurrent import mlstm_chunked as t_mlstm_chunked


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, name="", rtol=1e-5, atol_rel=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(), err_msg=name)


def close_bf16(got, want, name=""):
    lm_checks.assert_bf16_close(torch.tensor(_np(got)), torch.tensor(_np(want)), name)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("case", lm_checks.FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas_and_oracle(case):
    """The plain version, at the Pallas kernel's own blocks (32 x 32, so the
    window skips whole blocks), against the Pallas kernel and the oracle:
    o and lse."""
    B, Hq, Hkv, T, S, D, causal, window, dtype = case
    rng = np.random.RandomState(T + D)
    q, k, v = (rng.randn(B, h, n, D).astype(np.float32)
               for h, n in ((Hq, T), (Hkv, S), (Hkv, S)))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    o_pl, lse_pl = j_flash(jq, jk, jv, causal=causal, window=window, block_q=32,
                           block_k=32, interpret=True, return_lse=True)
    o_jr = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    tq, tk, tv = (torch.tensor(x).to(dtype) for x in (q, k, v))
    o, lse = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                block_q=32, block_k=32, return_lse=True)
    o_tr = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert o.dtype == dtype and o.shape == (B, Hq, T, D)
    cmp = close_bf16 if dtype == torch.bfloat16 else close
    cmp(o, o_pl, "plain vs Pallas")
    cmp(o, o_jr, "plain vs JAX oracle")
    cmp(o_tr, o_jr, "oracle vs JAX oracle")
    close(lse, lse_pl, "lse")


def test_flash_blocks_do_not_change_the_result():
    """The plain version at 32 x 32 and 128 x 64 blocks (ops' default is
    128 x 128) gives the same o; an empty row gives o = 0, lse = -1e30."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(1, 2, 256, 16).astype(np.float32))
               for _ in range(3))
    a = fa.flash_attention_ref(q, k, v, window=64, block_q=32, block_k=32)
    b = fa.flash_attention_ref(q, k, v, window=64, block_q=128, block_k=64)
    close(a, b)
    # not causal, window 8 over 128 keys: the query block [192, 224) sees
    # no key block at all, so its rows are empty
    o, lse = fa.flash_attention_ref(q, k[:, :, :128], v[:, :, :128], causal=False,
                                    window=8, block_q=32, block_k=128,
                                    return_lse=True)
    assert (o[:, :, 192:224] == 0).all() and (lse[:, :, 192:224] == -1e30).all()
    assert (o[:, :, 128:136] != 0).any()


def test_ops_flash_rule():
    """use_kernel=False takes the dense oracle, as in JAX; with the kernel
    rule the plain version runs at blocks min(128, T)."""
    rng = np.random.RandomState(6)
    q = torch.tensor(rng.randn(1, 4, 96, 16).astype(np.float32))
    k = torch.tensor(rng.randn(1, 2, 96, 16).astype(np.float32))
    v = torch.tensor(rng.randn(1, 2, 96, 16).astype(np.float32))
    dense = ops.flash_attention(q, k, v, window=24, use_kernel=False)
    blocked = ops.flash_attention(q, k, v, window=24)
    want = jref.attention_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)), window=24)
    close(dense, want)
    close(blocked, want)


# ------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("B,T,D,bt,bd,with_h0", [
    (1, 256, 256, 256, 256, True), (2, 128, 64, 32, 64, False),
    (2, 64, 32, 16, 16, True)])
def test_rglru_plain_matches_pallas_and_oracle(B, T, D, bt, bd, with_h0):
    rng = np.random.RandomState(T + D)
    x = rng.randn(B, T, D).astype(np.float32)
    a = rng.uniform(0.3, 0.999, (B, T, D)).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    h_pl, last_pl = j_rglru(jnp.asarray(x), jnp.asarray(a), jh0, block_t=bt,
                            block_d=bd, interpret=True)
    h_jr, last_jr = jax.jit(jref.rglru_ref)(jnp.asarray(x), jnp.asarray(a), jh0)
    th0 = None if h0 is None else torch.tensor(h0)
    h, last = rg.rglru_scan(torch.tensor(x), torch.tensor(a), th0, block_t=bt,
                            block_d=bd)
    h_tr, last_tr = tref.rglru_ref(torch.tensor(x), torch.tensor(a), th0)
    for got, want, name in ((h, h_pl, "plain vs Pallas"), (last, last_pl, "h_last"),
                            (h, h_jr, "plain vs JAX oracle"),
                            (h_tr, h_jr, "oracle vs JAX oracle"),
                            (last_tr, last_jr, "oracle h_last")):
        close(got, want, name)


def test_rglru_shape_rule():
    """The kernel module takes the TPU kernel's rule on either device: T
    and D divisible by the blocks."""
    x = torch.zeros(1, 96, 256)
    with pytest.raises(ValueError, match="divide"):
        rg.rglru_scan(x, x, block_t=64)
    h, last = ops.rglru(x, x, use_kernel=False)  # the oracle takes any shape
    assert h.shape == x.shape and last.shape == (1, 256)


# ------------------------------------------------------------- sLSTM
# The plain version against the Pallas kernel: tests/test_torch_slstm_kernels.py
def test_ops_slstm_rule():
    """T % min(block_t, T) == 0 takes the kernel module, otherwise the
    oracle; both give the same sequences."""
    case = (1, 130, 16, 2, torch.float32, "zero")
    r, pre, carry0 = lm_checks.slstm_inputs(case, device="cpu")
    before = sl.launches
    via_ref = ops.slstm_scan(r, pre, carry0)  # 130 % 128 != 0: the oracle
    via_plain = sl.slstm_scan_ref(r, pre, carry0, block_t=10)
    close(via_ref[0], via_plain[0])
    with pytest.raises(ValueError, match="divide"):
        sl.slstm_scan(r, pre, carry0)
    assert sl.launches == before  # nothing launches on the CPU


# ------------------------------------------------------------- mLSTM
def test_mlstm_chunked_matches_jax():
    """The chunkwise-parallel mLSTM (plain torch, no kernel) against the
    JAX one from a zero state (m = -inf) and a random state, chunk 8 and 32."""
    rng = np.random.RandomState(11)
    B, T, H, hd = 2, 32, 2, 8
    q, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(2))
    k = (rng.randn(B, T, H, hd) / np.sqrt(hd)).astype(np.float32)
    log_i = rng.randn(B, T, H).astype(np.float32)
    log_f = np.log(rng.uniform(0.6, 0.95, (B, T, H))).astype(np.float32)
    states = [
        (np.zeros((B, H, hd, hd), np.float32), np.zeros((B, H, hd), np.float32),
         np.full((B, H), -np.inf, np.float32)),
        (rng.randn(B, H, hd, hd).astype(np.float32),
         rng.randn(B, H, hd).astype(np.float32), rng.randn(B, H).astype(np.float32)),
    ]
    args = (q, k, v, log_i, log_f)
    for state in states:
        for chunk in (8, 32):
            hj, sj = j_mlstm_chunked(*(jnp.asarray(x) for x in args),
                                     tuple(jnp.asarray(x) for x in state), chunk=chunk)
            ht, st = t_mlstm_chunked(*(torch.tensor(x) for x in args),
                                     tuple(torch.tensor(x) for x in state), chunk=chunk)
            close(ht, hj, f"h chunk {chunk}")
            for a, b in zip(st, sj):
                close(a, b, f"state chunk {chunk}")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (nothing is built or
    launched for a CPU tensor)."""
    x = torch.zeros(1, 128, 256)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan_cuda(x, x)
    q = torch.zeros(1, 1, 128, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
    r, pre, carry0 = lm_checks.slstm_inputs(lm_checks.SLSTM_CASES[0], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm_scan_cuda(r, pre, carry0)
    assert jax.default_backend() == "cpu"
