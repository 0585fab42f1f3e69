"""The three LM kernels' backward passes against the JAX package on the
CPU: each ``torch.autograd.Function`` of ``repro_torch.kernels.ops``
(its plain forward here) against ``jax.grad`` through the JAX package's
custom VJP, at the tolerances of ``tests/test_kernels.py`` (flash: atol
5e-4, rtol 1e-4; RG-LRU: 1e-3).  The sLSTM's ``_slstm_scan`` is held
at atol 1e-5, rtol 1e-4 with f32 R (the two run the same f32 ops) and at
atol and rtol 1e-2 with bf16 R: h rounds to bf16 before the R products
and its cotangent after them (as JAX's transposed ``dot_general`` does),
so where two f32 sums differ in their last bit the cotangent can round
one bf16 ulp apart (0.4%), and every earlier step carries that.  Also:
the model's calls go through the ``Function``s, and with grad off the
forward is the plain call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.models import recurrent as j_rec
from repro_torch.configs.registry import get_config
from repro_torch.core.struct import tree_leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.models import model as TM


def _t(a, grad=True):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


# ------------------------------------------------------------- flash
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
def test_flash_grads_match_jax(causal, window):
    """(1, 4/2, 128, 32) f32, blocks of 64, as tests/test_kernels.py:54,
    with backend="xla" (the blocked forward, the custom VJP)."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, h, 128, 32).astype(np.float32) for h in (4, 2, 2))
    w = rng.randn(1, 4, 128, 32).astype(np.float32)
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)

    def loss_j(q, k, v):
        return (j_ops.flash_attention(q, k, v, backend="xla", **kw) * w).sum()

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q), _t(k), _t(v)
    o = ops.flash_attention(qt, kt, vt, **kw)
    assert type(o.grad_fn).__name__ == "FlashFnBackward"
    gt = torch.autograd.grad((o * torch.tensor(w)).sum(), (qt, kt, vt))
    for name, a, b in zip("qkv", gt, gj):
        _close(a, b, 5e-4, 1e-4, f"d{name}")


def test_flash_bwd_skips_only_masked_blocks():
    """The backward's block skipping against the dense oracle differentiated
    by autograd, bf16 inputs and a window that empties whole blocks."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.tensor(rng.randn(2, h, 256, 16), dtype=torch.float32)
               for h in (4, 1, 1))
    do = torch.tensor(rng.randn(2, 4, 256, 16), dtype=torch.float32)
    kw = dict(causal=True, window=48)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    g_fn = torch.autograd.grad(ops.flash_attention(*args, **kw), args, do)
    args = [x.clone().requires_grad_(True) for x in (q, k, v)]
    g_ref = torch.autograd.grad(ops.flash_attention(*args, use_kernel=False, **kw), args, do)
    for a, b in zip(g_fn, g_ref):
        _close(a, b.numpy(), 5e-4, 1e-4, "grad")


# ------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_grads_match_jax(with_h0):
    """As tests/test_kernels.py::test_rglru_grad_vs_ref: h, h_last and h0."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 256, 256).astype(np.float32)
    a = rng.uniform(0.5, 0.99, (2, 256, 256)).astype(np.float32)
    h0 = rng.randn(2, 256).astype(np.float32)
    w = rng.randn(256).astype(np.float32)

    def lj(x, a, h0):
        h, hl = j_ops.rglru(x, a, h0 if with_h0 else None)
        return (h * w).sum() + (hl ** 2).sum()

    gj = jax.grad(lj, argnums=(0, 1, 2))(*map(jnp.asarray, (x, a, h0)))
    xt, at, h0t = _t(x), _t(a), _t(h0)
    h, hl = ops.rglru(xt, at, h0t if with_h0 else None)
    assert type(h.grad_fn).__name__ == "RglruFnBackward"
    ins = (xt, at, h0t) if with_h0 else (xt, at)
    gt = torch.autograd.grad((h * torch.tensor(w)).sum() + (hl ** 2).sum(), ins)
    for name, a_, b_ in zip(("x", "a", "h0"), gt, gj):
        _close(a_, b_, 1e-3, 1e-3, f"d{name}")


def test_rglru_reverse_scan_runs_the_kernel_module(monkeypatch):
    """The backward's reverse recurrence goes through ``rglru_scan`` (the
    kernel on the card), on the flipped, contiguous f32 tensors."""
    seen = []
    orig = rg.rglru_scan

    def spy(x, a, h0=None, **kw):
        seen.append((x.dtype, x.is_contiguous(), h0))
        return orig(x, a, h0, **kw)

    monkeypatch.setattr(rg, "rglru_scan", spy)
    x = torch.randn(1, 256, 256, requires_grad=True)
    a = torch.rand(1, 256, 256).requires_grad_(True)
    h, _ = ops.rglru(x, a)
    h.sum().backward()
    assert len(seen) == 2 and seen[1] == (torch.float32, True, None)


# ------------------------------------------------------------- sLSTM
@pytest.mark.parametrize("r_dtype,carry", [("float32", "zero"), ("float32", "random"),
                                           ("bfloat16", "random")])
def test_slstm_grads_match_jax(r_dtype, carry):
    """``_slstm_scan`` at a smoke shape (B 2, T 16, d 64, 4 heads): dR,
    dpre and dcarry0 (m0 = -inf for the zero carry: no NaN, as JAX)."""
    rng = np.random.RandomState(5)
    B, T, d, H = 2, 16, 64, 4
    hd = d // H
    r = {g: (rng.randn(H, hd, hd) * 0.3).astype(np.float32) for g in "ifzo"}
    pre = rng.randn(B, T, 4, d).astype(np.float32)
    if carry == "zero":
        z = np.zeros((B, d), np.float32)
        c0 = (z, z, z, np.full((B, d), -np.inf, np.float32))
    else:
        c0 = (rng.randn(B, d), rng.uniform(1, 3, (B, d)), rng.randn(B, d), rng.randn(B, d))
        c0 = tuple(x.astype(np.float32) for x in c0)
    w = rng.randn(B, T, d).astype(np.float32)
    wc = [rng.randn(B, d).astype(np.float32) for _ in range(4)]
    jdt = jnp.bfloat16 if r_dtype == "bfloat16" else jnp.float32

    def lj(r, pre, c0):
        hs, fin = j_rec._slstm_scan(r, pre, c0)
        return (hs * w).sum() + sum((f * x).sum() for f, x in zip(fin, wc))

    gr, gpre, gc0 = jax.grad(lj, argnums=(0, 1, 2))(
        {g: jnp.asarray(x, jdt) for g, x in r.items()}, jnp.asarray(pre),
        tuple(map(jnp.asarray, c0)))
    tdt = getattr(torch, r_dtype)
    rt = {g: torch.tensor(x).to(tdt).requires_grad_(True) for g, x in r.items()}
    pret = _t(pre)
    c0t = tuple(_t(x) for x in c0)
    hs, _, fin = ops.slstm_scan(rt, pret, c0t)
    assert type(hs.grad_fn).__name__ == "SlstmFnBackward"
    loss = (hs * torch.tensor(w)).sum() + sum((f * torch.tensor(x)).sum()
                                              for f, x in zip(fin, wc))
    ins = [rt[g] for g in "ifzo"] + [pret, *c0t]
    gt = torch.autograd.grad(loss, ins)
    tol = (1e-5, 1e-4) if r_dtype == "float32" else (1e-2, 1e-2)
    for i, g in enumerate("ifzo"):
        assert gt[i].dtype == tdt
        _close(gt[i], np.asarray(gr[g], np.float32), *tol, f"dR_{g}")
    _close(gt[4], gpre, *tol, "dpre")
    for name, a_, b_ in zip("cnhm", gt[5:], gc0):
        assert torch.isfinite(a_).all(), f"dcarry0 {name} not finite"
        _close(a_, b_, *tol, f"dcarry0 {name}")


# ------------------------------------------------- the model's calls, serving
def test_model_calls_go_through_the_functions(monkeypatch):
    """A kernel-aligned forward with grad: every flash, RG-LRU and sLSTM
    output the model gets is its ``Function``'s; with grad off the kernel
    modules are called as serving calls them (no ``lse``), nothing saved."""
    import dataclasses

    got = {"flash": [], "rglru": [], "slstm": []}
    lse_asked = []
    orig_fa = fa.flash_attention

    def spy_fa(*a, return_lse=False, **kw):
        lse_asked.append(return_lse)
        return orig_fa(*a, return_lse=return_lse, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy_fa)
    for key, name in (("flash", "flash_attention"), ("rglru", "rglru"),
                      ("slstm", "slstm_scan")):
        orig = getattr(ops, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            out = _orig(*a, **kw)
            got[_key].append(out[0] if isinstance(out, tuple) else out)
            return out

        monkeypatch.setattr(ops, name, spy)
    for arch, over in (("recurrentgemma-2b", dict(rnn_width=256, attn_window=96)),
                       ("xlstm-125m", {})):
        cfg = dataclasses.replace(get_config(arch, smoke=True), use_kernels=True,
                                  remat=False, **over)
        params = TM.init_params(cfg, 0, device="cpu")
        toks = torch.randint(2, cfg.vocab, (1, 256), generator=torch.Generator().manual_seed(1))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        lse_asked.clear()
        with torch.no_grad():
            TM.forward(params, cfg, toks)
        n_plain = len(lse_asked)
        assert not any(lse_asked)
        TM.forward(params, cfg, toks)
        assert all(lse_asked[n_plain:])
    names = {k: {type(o.grad_fn).__name__ for o in v if o.grad_fn is not None}
             for k, v in got.items()}
    assert names == {"flash": {"FlashFnBackward"}, "rglru": {"RglruFnBackward"},
                     "slstm": {"SlstmFnBackward"}}
    assert all(o.grad_fn is None for v in got.values() for o in v[:1])


@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_slstm_step_vjp_is_autograds(r_dtype):
    """The written-out step VJP of ``slstm_bwd`` against
    ``torch.autograd.grad`` of ``slstm_step`` over 3 steps, from a zero
    carry (m = -inf, and n_new == 1 at step 0: a tie of the max) and from
    a random one: dpre and dcarry0, and dR with f32 R (with bf16 R autograd
    rounds each step's dR to bf16 before summing them, the reference sums
    in f32 once)."""
    rng = np.random.RandomState(6)
    B, T, d, H = 2, 3, 32, 2
    hd = d // H
    tdt = getattr(torch, r_dtype)
    r = {g: torch.tensor(rng.randn(H, hd, hd) * 0.3, dtype=torch.float32).to(tdt)
         for g in "ifzo"}
    pre = torch.tensor(rng.randn(B, T, 4, d), dtype=torch.float32)
    dhs = torch.tensor(rng.randn(B, T, d), dtype=torch.float32)
    dfin = tuple(torch.tensor(rng.randn(B, d), dtype=torch.float32) for _ in range(4))
    z = torch.zeros(B, d)
    random = tuple(torch.tensor(x, dtype=torch.float32) for x in (
        rng.randn(B, d), rng.uniform(1, 3, (B, d)), rng.randn(B, d), rng.randn(B, d)))
    for carry0 in ((z, z, z, torch.full((B, d), -np.inf)), random):
        hs, seqs, fin = sl.slstm_scan_ref(r, pre, carry0)
        dr, dpre, dc0 = ops.slstm_bwd(r, pre, carry0, (hs, *seqs), dhs, dfin)
        # autograd through the steps, R a leaf too
        rl = {g: x.clone().requires_grad_(True) for g, x in r.items()}
        pl = pre.clone().requires_grad_(True)
        cl = tuple(x.clone().requires_grad_(True) for x in carry0)
        carry, outs = cl, []
        for t in range(T):
            carry = ops.slstm_step(rl, carry, pl[:, t])
            outs.append(carry[2])
        loss = (torch.stack(outs, 1) * dhs).sum() + sum((a * b).sum()
                                                        for a, b in zip(carry, dfin))
        want = torch.autograd.grad(loss, [rl[g] for g in "ifzo"] + [pl, *cl])
        got = [dr[g] for g in "ifzo"] + [dpre, *dc0]
        for name, a, b in zip(["dR_i", "dR_f", "dR_z", "dR_o", "dpre", "dc", "dn", "dh",
                               "dm"], got, want):
            assert torch.isfinite(a).all(), name
            if name.startswith("dR") and r_dtype == "bfloat16":
                continue  # autograd sums a bf16 dR a step; the reference sums in f32
            _close(a, b.float().numpy(), *((1e-5, 1e-4) if r_dtype == "float32"
                                           else (1e-2, 1e-2)), name)
