"""The port's MoE, vision-language and audio models against the JAX package
on the CPU: qwen3-moe and llama4-maverick (``attn_moe``, ``models/moe.py``),
qwen2-vl (M-RoPE, the embeddings input) and hubert (the non-causal
encoder).

As in ``tests/test_torch_lm.py``: both packages start from the JAX
``init_params`` weights (carried across by ``convert.lm_params_from_numpy``)
and the same prompts or embeddings, made with numpy from a seed; logits
agree within 1e-4 (f32) and greedy tokens are identical.  MoE routing is
held exactly: the expert indices of every choice are equal, at a capacity
low enough that tokens are dropped, with softmax and sigmoid gates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.registry import ALIASES as J_ALIASES, ARCH_IDS as J_ARCH_IDS
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs.registry import ALIASES, ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy
from repro_torch.core.struct import tree_paths
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from test_torch_lm import close_logits, flatten, plain_calls  # noqa: F401

GEN = 4
BATCH = 2
#: name -> (arch, prompt length, config overrides, plain flash calls of one
#: prefill + GEN decode steps).  The kernel-aligned variants take the
#: flash attention module (its plain version, on the CPU) in the prefill;
#: qwen3-moe's at capacity factor 1.0, so that its prefill drops tokens.
CONFIGS = {
    "qwen3-moe-smoke": ("qwen3-moe-235b-a22b", 32, {}, 0),
    "llama4-smoke": ("llama4-maverick-400b-a17b", 32, {}, 0),
    "qwen2-vl-smoke": ("qwen2-vl-72b", 32, {}, 0),
    "qwen3-moe-kernel": ("qwen3-moe-235b-a22b", 256,
                         dict(use_kernels=True, capacity_factor=1.0), 2),
    "qwen2-vl-kernel": ("qwen2-vl-72b", 256, dict(use_kernels=True), 2),
}
HUBERT = {"hubert-smoke": ({}, 32), "hubert-kernel": (dict(use_kernels=True), 256)}


def replace(cfg, over):
    if cfg.moe is not None and "capacity_factor" in over:
        over = dict(over)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor")))
    return dataclasses.replace(cfg, **over)


def configs(arch, over):
    return (replace(j_get_config(arch, smoke=True), over),
            replace(get_config(arch, smoke=True), over))


def make_inputs(cfg, T: int, seed: int = 1) -> np.ndarray:
    """Token ids (B, T) int32 or, for an embeddings-input config,
    embeddings (B, T, d) f32."""
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "embeddings":
        return rng.randn(BATCH, T, cfg.d_model).astype(np.float32)
    return rng.randint(2, cfg.vocab, (BATCH, T)).astype(np.int32)


def to_torch(inputs: np.ndarray):
    t = torch.tensor(inputs)
    return t.long() if inputs.dtype == np.int32 else t


_JAX_RUNS: dict = {}


def jax_run(name) -> dict:
    """The JAX package's prefill and GEN greedy decode steps (cached per
    config), as in ``tests/test_torch_lm.py``."""
    if name not in _JAX_RUNS:
        arch, T, over, _ = CONFIGS[name]
        jcfg, _ = configs(arch, over)
        params = JM.init_params(jcfg, jax.random.key(0))
        inputs = make_inputs(jcfg, T)
        states, logits = jax.jit(lambda p, x: JM.prefill(p, jcfg, x, T + GEN))(
            params, jnp.asarray(inputs))
        decode = jax.jit(lambda p, s, t, pos: JM.decode_step(p, jcfg, s, t, pos))
        run = {"params": flatten(params), "inputs": inputs,
               "logits": [np.asarray(logits)], "states": [flatten(states)]}
        for i in range(GEN):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            states, logits = decode(params, states, tok, jnp.int32(T + i))
            run["logits"].append(np.asarray(logits))
            run["states"].append(flatten(states))
        run["forward"] = lambda: JM.forward(params, jcfg, jnp.asarray(inputs))
        _JAX_RUNS[name] = run
    return _JAX_RUNS[name]


def assert_states_close(states, want: dict):
    got = {p: x.float().numpy() for p, x in tree_paths(states)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


# ------------------------------------------------------------ (a) serving
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name, plain_calls):
    """Prefill and GEN greedy decode steps from the JAX weights: logits
    within 1e-4 and identical tokens at every step, the states after the
    last step close to JAX's, the flash module taken as the JAX package's
    shape rule says."""
    arch, T, over, flash = CONFIGS[name]
    _, tcfg = configs(arch, over)
    run = jax_run(name)
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    with torch.inference_mode():
        states, logits = TM.prefill(params, tcfg, to_torch(run["inputs"]), T + GEN)
        close_logits(logits, run["logits"][0], "prefill")
        for i in range(GEN):
            tok = logits.argmax(-1)
            states, logits = TM.decode_step(params, tcfg, states, tok, T + i)
            close_logits(logits, run["logits"][i + 1], f"decode step {i + 1}")
    assert_states_close(states, run["states"][-1])
    assert plain_calls["flash"] == flash


@pytest.mark.parametrize("name", ["qwen3-moe-kernel", "qwen2-vl-smoke"])
def test_forward_matches_jax(name):
    """``forward`` returns (logits, moe_aux) as the reference does: every
    position's logits within 1e-4 and the aux loss (0 without MoE layers)."""
    arch, _, over, _ = CONFIGS[name]
    _, tcfg = configs(arch, over)
    run = jax_run(name)
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    with torch.inference_mode():
        logits, aux = TM.forward(params, tcfg, to_torch(run["inputs"]))
    want_logits, want_aux = (np.asarray(a) for a in run["forward"]())
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=1e-4)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(aux.item(), want_aux, rtol=1e-5, atol=1e-6)
    assert (aux.item() > 0) == (tcfg.moe is not None)


def test_moe_decode_from_a_jax_state():
    """qwen3-moe continues a JAX decode from the state after step 2
    (``lm_state_from_numpy``): steps 3 and 4 give JAX's logits."""
    arch, T, over, _ = CONFIGS["qwen3-moe-kernel"]
    _, tcfg = configs(arch, over)
    run = jax_run("qwen3-moe-kernel")
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    states = lm_state_from_numpy(tcfg, run["states"][2], device="cpu")
    with torch.inference_mode():
        for i in (3, 4):
            tok = torch.tensor(run["logits"][i - 1].argmax(-1))
            states, logits = TM.decode_step(params, tcfg, states, tok, T + i - 1)
            close_logits(logits, run["logits"][i], f"decode step {i}")


# ------------------------------------------------------------ (b) hubert
@pytest.mark.parametrize("name", HUBERT)
def test_hubert_forward_and_prefill_match_jax(name, plain_calls):
    """The non-causal encoder over embeddings: ``forward``'s logits and
    aux, and ``prefill``'s last-token logits and KV states, against JAX."""
    over, T = HUBERT[name]
    jcfg, tcfg = configs("hubert-xlarge", over)
    assert not tcfg.causal and tcfg.input_mode == "embeddings"
    jp = JM.init_params(jcfg, jax.random.key(0))
    inputs = make_inputs(jcfg, T)
    want_logits, want_aux = jax.jit(lambda p, x: JM.forward(p, jcfg, x))(
        jp, jnp.asarray(inputs))
    want_states, want_last = jax.jit(lambda p, x: JM.prefill(p, jcfg, x, T))(
        jp, jnp.asarray(inputs))
    params = lm_params_from_numpy(tcfg, flatten(jp), device="cpu")
    with torch.inference_mode():
        logits, aux = TM.forward(params, tcfg, torch.tensor(inputs))
        states, last = TM.prefill(params, tcfg, torch.tensor(inputs), T)
    close_logits(logits, np.asarray(want_logits), "forward")
    assert aux.item() == float(want_aux) == 0.0
    close_logits(last, np.asarray(want_last), "prefill")
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), rtol=0, atol=1e-5)
    assert_states_close(states, flatten(want_states))
    # one flash call a layer in forward and in prefill when kernel-aligned
    assert plain_calls["flash"] == (2 * tcfg.n_layers if tcfg.use_kernels else 0)


# ------------------------------------------------------------ (c) the MoE FFN
MOE_CASES = {
    # the qwen3-moe smoke router: softmax, normalized top-2
    "softmax-top2": ("qwen3-moe-235b-a22b", 0.5),
    # the llama4 smoke router: sigmoid top-1 beside a shared expert
    "sigmoid-top1-shared": ("llama4-maverick-400b-a17b", 0.5),
    # no drops: every choice fits (the capacity of the smoke configs)
    "softmax-top2-roomy": ("qwen3-moe-235b-a22b", 2.0),
}


def moe_case(name, S=64):
    arch, cf = MOE_CASES[name]
    jcfg, tcfg = configs(arch, dict(capacity_factor=cf))
    jp = JMoE.moe_init(jax.random.key(3), jcfg, jnp.float32)
    tp = {k: torch.tensor(v) for k, v in flatten(jp).items()}
    if "shared.wi" in tp:
        tp["shared"] = {k: tp.pop(f"shared.{k}") for k in ("wi", "wg", "wo")}
    x = np.random.RandomState(4).randn(BATCH, S, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def topk_margin(scores: np.ndarray, k: int) -> float:
    """The smallest gap between the k-th and (k+1)-th score of a token."""
    s = -np.sort(-scores, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if k < s.shape[-1] else np.inf


@pytest.mark.parametrize("name", MOE_CASES)
def test_router_and_moe_fwd_match_jax(name):
    """``_router``: expert indices equal, gates and aux within 1e-6;
    ``moe_fwd``: y within 1e-4 and aux equal, the dropped choices (where
    the capacity is low) dropped on both sides."""
    jcfg, tcfg, jp, tp, x = moe_case(name)
    j_idx, j_gates, j_aux = JMoE._router(jp, jcfg.moe, jnp.asarray(x))
    t_idx, t_gates, t_aux = TMoE._router(tp, tcfg.moe, torch.tensor(x))
    if not np.array_equal(t_idx.numpy(), np.asarray(j_idx)):
        logits = x @ flatten(jp)["router"]
        raise AssertionError(f"routing differs; the smallest top-k margin of the "
                             f"router logits is {topk_margin(logits, tcfg.moe.top_k):.3e}")
    np.testing.assert_allclose(t_gates.numpy(), np.asarray(j_gates), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_aux.item(), float(j_aux), rtol=1e-6)

    y_j, aux_j = JMoE.moe_fwd(jp, jcfg, jnp.asarray(x))
    y_t, aux_t = TMoE.moe_fwd(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-4)
    assert aux_t.item() == float(aux_j)

    *_, slot, keep, cap = TMoE.dispatch(tp, tcfg.moe, torch.tensor(x))
    S, k, E = x.shape[1], tcfg.moe.top_k, tcfg.moe.n_experts
    assert cap == max(int(tcfg.moe.capacity_factor * S * k / E), 4)
    # drops, where the capacity is below the busiest expert's load
    load = np.stack([np.bincount(r, minlength=E) for r in t_idx.reshape(BATCH, -1).numpy()])
    n_dropped = int((~keep).sum())
    assert n_dropped == int(np.maximum(load - cap, 0).sum())
    assert (n_dropped > 0) == (tcfg.moe.capacity_factor < 1.0)
    # the kept choices fill distinct real slots, the dropped ones the overflow
    for b in range(BATCH):
        kept = slot[b][keep[b]]
        assert kept.unique().numel() == kept.numel() and (kept < E * cap).all()
    assert (slot[~keep] == E * cap).all()


def test_moe_overflow_row_is_irrelevant():
    """Whatever the overflow slot holds, a kept choice's output is the
    same: its gather reads only real slots and every dropped choice is
    weighted by 0 (on the card the overflow row takes contended atomic
    adds)."""
    _, tcfg, _, tp, x = moe_case("softmax-top2")
    xt = torch.tensor(x)
    y, _ = TMoE.moe_fwd(tp, tcfg, xt)
    orig = torch.Tensor.index_add_

    def poisoned(self, dim, index, source, **kw):
        out = orig(self, dim, index, source, **kw)
        n_slots = self.shape[0] // BATCH
        self[n_slots - 1::n_slots] = 1e30  # each row's overflow slot
        return out

    torch.Tensor.index_add_ = poisoned
    try:
        y_poisoned, _ = TMoE.moe_fwd(tp, tcfg, xt)
    finally:
        torch.Tensor.index_add_ = orig
    assert torch.equal(y, y_poisoned)


# ------------------------------------------------------------ (d) M-RoPE
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mrope_matches_jax(dtype):
    """Three different position streams (t, h, w) against JAX's
    ``apply_mrope``; three equal streams give ``apply_rope``."""
    rng = np.random.RandomState(7)
    B, T, H, D, sections = 2, 16, 3, 16, (2, 3, 3)
    x = rng.randn(B, T, H, D).astype(np.float32)
    pos = rng.randint(0, 4096, (3, B, T)).astype(np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JL.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_mrope(torch.tensor(x).to(td), torch.tensor(pos), 1e6, sections)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5 if td == torch.float32 else 1e-2, atol=1e-4)
    same = torch.tensor(pos[0])
    np.testing.assert_array_equal(
        TL.apply_mrope(torch.tensor(x), same[None].expand(3, B, T), 1e6, sections).numpy(),
        TL.apply_rope(torch.tensor(x), same, 1e6).numpy())


# ------------------------------------------------------------ (e) decode == forward
def test_moe_decode_matches_forward():
    """qwen3-moe: prefill + step-by-step decode reproduces the
    teacher-forced ``forward`` logits, capacity widened so that the
    batched forward drops nothing (``tests/test_models.py``'s check and
    bound)."""
    _, tcfg = configs("qwen3-moe-235b-a22b", dict(capacity_factor=8.0))
    params = TM.init_params(tcfg, 0, device="cpu")
    S = 12
    toks = torch.tensor(np.random.RandomState(1).randint(0, tcfg.vocab, (BATCH, S + 3)))
    with torch.inference_mode():
        full, _ = TM.forward(params, tcfg, toks)
        states, lg = TM.prefill(params, tcfg, toks[:, :S], S + 4)
        err = (lg - full[:, S - 1]).abs().max().item()
        for t in range(2):
            states, lg = TM.decode_step(params, tcfg, states, toks[:, S + t], S + t)
            err = max(err, (lg - full[:, S + t]).abs().max().item())
    assert err < 5e-4, err


# ------------------------------------------------------------ (f) registry
def test_registry_returns_every_arch():
    """Every ``ARCH_IDS`` entry and alias gives the reference's config, at
    both sizes; none raises."""
    assert ARCH_IDS == J_ARCH_IDS and ALIASES == J_ALIASES
    for arch in ARCH_IDS + list(ALIASES):
        for smoke in (False, True):
            mine, ref = get_config(arch, smoke), j_get_config(arch, smoke)
            assert type(mine).__name__ == type(ref).__name__
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch


# ------------------------------------------------------------ weights and serve
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                                  "qwen2-vl-72b"])
def test_bf16_layout_matches_jax(arch):
    """At bf16 the carried-across MoE, M-RoPE and embeddings-input trees
    have the port's own tree, shapes and dtypes (the router f32), and bf16
    values cross exactly."""
    jcfg, tcfg = configs(arch, dict(dtype="bfloat16"))
    flat = flatten(JM.init_params(jcfg, jax.random.key(0)))
    got = lm_params_from_numpy(tcfg, flat, device="cpu")

    def layout(tree):
        return {p: (tuple(x.shape), x.dtype) for p, x in tree_paths(tree)}

    assert layout(got) == layout(TM.init_params(tcfg, 0, device="cpu"))
    for p, x in tree_paths(got):
        want = torch.float32 if p.endswith("router") else torch.bfloat16
        assert x.dtype == want, p
        np.testing.assert_array_equal(x.float().numpy(), flat[p])


def test_truncnorm_draws_large_leaves_in_slices(monkeypatch):
    """A leaf above ``DRAW_LIMIT`` elements is drawn slice by slice along
    its leading dims (each slice as a leaf of its shape would be, from the
    same generator in order); a leaf within it is drawn as before."""
    def draw(shape, scale=0.5):
        return TL.truncnorm(torch.Generator().manual_seed(5), shape, scale,
                            torch.bfloat16, "cpu")

    t = torch.empty((3, 5, 40))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(5))
    assert torch.equal(draw((3, 5, 40)), (t * 0.5).to(torch.bfloat16))
    monkeypatch.setattr(TL, "DRAW_LIMIT", 80)  # one (2, 40) row block a draw
    sliced = draw((3, 5, 40))
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([torch.cat([TL.truncnorm(gen, (n, 40), 0.5, torch.bfloat16, "cpu")
                                   for n in (2, 2, 1)]) for _ in range(3)])
    assert torch.equal(sliced, want)
    assert sliced.dtype == torch.bfloat16 and sliced.abs().max() <= 1.0
    monkeypatch.setattr(TL, "DRAW_LIMIT", 30)  # below a row: one row a draw
    gen = torch.Generator().manual_seed(5)
    rows = torch.stack([torch.stack([TL.truncnorm(gen, (40,), 0.5, torch.bfloat16, "cpu")
                                     for _ in range(5)]) for _ in range(3)])
    assert torch.equal(draw((3, 5, 40)), rows)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_serve_refuses_embeddings_input(arch):
    """``serve`` makes token prompts: an embeddings-input config raises a
    ``ValueError`` naming the model functions (hubert's: encoder-only, as
    in the reference)."""
    match = "encoder-only" if arch == "hubert-xlarge" else "models.model.prefill"
    with pytest.raises(ValueError, match=match):
        serve(arch, smoke=True, batch=1, prompt_len=8, gen=2, device="cpu",
              verbose=False)


def test_serve_moe_on_the_cpu():
    """``serve`` at the smoke size for both MoE archs: (batch, gen) tokens,
    finite logits, the same tokens from the same seed."""
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        a, b = (serve(arch, smoke=True, batch=2, prompt_len=32, gen=4, device="cpu",
                      verbose=False) for _ in range(2))
        assert a["tokens"].shape == (2, 4) and a["finite"]
        assert (a["tokens"] == b["tokens"]).all()
