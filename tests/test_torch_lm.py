"""The port's LM serving path against the JAX package on the CPU.

Both packages start from the JAX ``init_params`` weights (carried across
by ``convert.lm_params_from_numpy``) and the same prompts, then run
``prefill`` and greedy ``decode_step``s: the logits must agree within 1e-4
(f32; they reach ~60 in magnitude, and differ by ~1e-5 from sums taken in
other orders) and the greedy tokens must be identical.  Eight configs: each
recurrent architecture's ``SMOKE`` (no kernel route but the sLSTM's) and a
kernel-aligned variant (``use_kernels``, a 256-token prompt; for
recurrentgemma ``rnn_width`` 256 and a 96-token window, so the ring cache
wraps and the prefill rolls it), whose prefill takes the flash attention
and RG-LRU kernel modules (their plain versions, on the CPU); and the
dense llama3.2-1b (GQA, SwiGLU), gemma-2b (MQA, GeGLU, the embedding
scale), llama3.2-3b and gemma-7b at ``SMOKE``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy
from repro_torch.core.struct import tree_paths
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.launch.serve import serve
from repro_torch.models import model as TM

GEN = 4
BATCH = 2
#: name -> (arch, prompt length, config overrides, plain-version calls
#: (flash, rglru, slstm) of one prefill + GEN decode steps)
CONFIGS = {
    "rg-smoke": ("recurrentgemma-2b", 32, {}, (0, 0, 0)),
    "rg-kernel": ("recurrentgemma-2b", 256,
                  dict(use_kernels=True, rnn_width=256, attn_window=96), (1, 4, 0)),
    "xl-smoke": ("xlstm-125m", 32, {}, (0, 0, 1 + GEN)),
    "xl-kernel": ("xlstm-125m", 256, dict(use_kernels=True), (0, 0, 1 + GEN)),
    "llama-smoke": ("llama3.2-1b", 32, {}, (0, 0, 0)),
    "gemma-smoke": ("gemma-2b", 32, {}, (0, 0, 0)),
    "llama3b-smoke": ("llama3.2-3b", 32, {}, (0, 0, 0)),
    "gemma7b-smoke": ("gemma-7b", 32, {}, (0, 0, 0)),
}


def flatten(tree) -> dict:
    """A JAX pytree as f32 numpy leaves by dotted path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        out[key] = np.asarray(jnp.asarray(leaf, jnp.float32))
    return out


def configs(name):
    arch, T, over, _ = CONFIGS[name]
    return (dataclasses.replace(j_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over), T)


_JAX_RUNS: dict = {}


def jax_run(name) -> dict:
    """The JAX package's prefill and GEN greedy decode steps (cached per
    config): params, prompts, the logits of each call and the states after
    each (index 0: the prefill)."""
    if name not in _JAX_RUNS:
        jcfg, _, T = configs(name)
        params = JM.init_params(jcfg, jax.random.key(0))
        toks = np.random.RandomState(1).randint(2, jcfg.vocab, (BATCH, T)).astype(np.int32)
        states, logits = jax.jit(lambda p, x: JM.prefill(p, jcfg, x, T + GEN))(
            params, jnp.asarray(toks))
        decode = jax.jit(lambda p, s, t, pos: JM.decode_step(p, jcfg, s, t, pos))
        run = {"params": flatten(params), "tokens": toks,
               "logits": [np.asarray(logits)], "states": [flatten(states)]}
        for i in range(GEN):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            states, logits = decode(params, states, tok, jnp.int32(T + i))
            run["logits"].append(np.asarray(logits))
            run["states"].append(flatten(states))
        _JAX_RUNS[name] = run
    return _JAX_RUNS[name]


def close_logits(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4, err_msg=what)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all(), f"{what}: greedy tokens"


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the kernel modules' plain-version calls."""
    calls = {"flash": 0, "rglru": 0, "slstm": 0}
    for key, mod, fn in (("flash", fa, "flash_attention_ref"),
                         ("rglru", rg, "rglru_scan_ref"),
                         ("slstm", sl, "slstm_scan_ref")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    return calls


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name, plain_calls):
    """Prefill and GEN greedy decode steps from the JAX weights: logits
    within 1e-4 and identical tokens at every step; the states after the
    last step close to JAX's; the kernel modules taken as the JAX package's
    shape rules say."""
    _, tcfg, T = configs(name)
    run = jax_run(name)
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    with torch.inference_mode():
        states, logits = TM.prefill(params, tcfg, torch.tensor(run["tokens"]).long(),
                                    T + GEN)
        close_logits(logits, run["logits"][0], "prefill")
        for i in range(GEN):
            tok = logits.argmax(-1)
            states, logits = TM.decode_step(params, tcfg, states, tok, T + i)
            close_logits(logits, run["logits"][i + 1], f"decode step {i + 1}")
    got = {p: x.float().numpy() for p, x in tree_paths(states)}
    want = run["states"][-1]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert tuple(plain_calls.values()) == CONFIGS[name][3]


@pytest.mark.parametrize("name", ["rg-kernel", "xl-smoke"])
def test_decode_from_a_jax_state(name):
    """The port continues a JAX decode from the state after step 2 (carried
    across by ``lm_state_from_numpy``): steps 3 and 4 give JAX's logits."""
    _, tcfg, T = configs(name)
    run = jax_run(name)
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    states = lm_state_from_numpy(tcfg, run["states"][2], device="cpu")
    with torch.inference_mode():
        for i in (3, 4):
            tok = torch.tensor(run["logits"][i - 1].argmax(-1))
            states, logits = TM.decode_step(params, tcfg, states, tok, T + i - 1)
            close_logits(logits, run["logits"][i], f"decode step {i}")


def test_forward_matches_jax():
    """The full-sequence forward (every position's logits) on the
    kernel-aligned recurrentgemma."""
    jcfg, tcfg, T = configs("rg-kernel")
    run = jax_run("rg-kernel")
    want, _ = jax.jit(lambda p, x: JM.forward(p, jcfg, x))(
        JM.init_params(jcfg, jax.random.key(0)), jnp.asarray(run["tokens"]))
    params = lm_params_from_numpy(tcfg, run["params"], device="cpu")
    with torch.inference_mode():
        got, aux = TM.forward(params, tcfg, torch.tensor(run["tokens"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert aux.item() == 0.0  # no MoE layer


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_bf16_layout_matches_jax(arch):
    """At bf16 the carried-across parameters and decode states have the
    port's own tree, shapes and dtypes, and bf16 values cross exactly."""
    over = dict(dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jp = JM.init_params(jcfg, jax.random.key(0))
    flat = flatten(jp)
    got = lm_params_from_numpy(tcfg, flat, device="cpu")
    mine = TM.init_params(tcfg, 0, device="cpu")

    def layout(tree):
        return {p: (tuple(x.shape), x.dtype) for p, x in tree_paths(tree)}

    assert layout(got) == layout(mine)
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(), flat["embed"])
    jstates = flatten(JM.init_decode_state(jcfg, BATCH, 64))
    tstates = lm_state_from_numpy(tcfg, jstates, device="cpu")
    assert layout(tstates) == layout(TM.init_decode_state(tcfg, BATCH, 64, "cpu"))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_serve_on_the_cpu(arch):
    """``serve`` at the smoke size on ``device="cpu"``: ``repro.launch.serve``'s
    keys, (batch, gen) tokens, finite logits, the same tokens from the same
    seed."""
    a = serve(arch, smoke=True, batch=2, prompt_len=32, gen=5, device="cpu",
              verbose=False)
    b = serve(arch, smoke=True, batch=2, prompt_len=32, gen=5, device="cpu",
              verbose=False)
    assert {"tokens", "prefill_s", "tok_per_s"} <= set(a)
    assert a["tokens"].shape == (2, 5) and a["finite"]
    assert (a["tokens"] == b["tokens"]).all()
    assert a["prefill_s"] > 0 and a["tok_per_s"] > 0


def test_registry():
    """``get_config`` and ``ALIASES`` as in JAX for every LM arch, the MoE,
    vision-language and audio ones included; an unknown name raises."""
    for arch in ("recurrentgemma-2b", "recurrentgemma_2b", "xlstm-125m",
                 "llama3.2-1b", "llama3.2-3b", "gemma-2b", "gemma-7b",
                 "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "qwen2-vl-72b", "hubert-xlarge"):
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke))
                    == dataclasses.asdict(j_get_config(arch, smoke)))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_serve_defaults_match_jax():
    """``serve`` takes the JAX driver's defaults (llama3.2-1b at the smoke
    size), with ``device`` beside them."""
    import inspect

    from repro.launch.serve import serve as j_serve

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()}

    mine, ref = defaults(serve), defaults(j_serve)
    assert mine.pop("device") == "cuda"
    assert mine == ref and mine["arch"] == "llama3.2-1b"
