"""The port's training loss and gradients against the JAX package on the
CPU: ``models.model.loss_fn`` (loss, ``nll``, ``z_loss``, ``moe_aux``) and
every parameter's gradient against ``jax.value_and_grad`` of the
reference's ``loss_fn``, from the same weights (``convert.
lm_params_from_numpy``) and the same batch.  This file: the dense,
vision-language and audio archs at their smoke configs (remat on, as
``SMOKE`` has it), and remat against no remat; the MoE and recurrent archs
and the kernel-aligned variants are in ``test_torch_train_grads_rec.py``
and ``test_torch_train_grads_kernels.py``.

Tolerances: the loss and its parts within 1e-5 relative; each gradient
within rtol 1e-4 plus an absolute 1e-5 of the model's largest gradient
(a leaf whose gradient cancels to ~1e-10, such as the sLSTM's input-gate
bias, carries the rounding of the terms that cancelled there).
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
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.struct import tree_paths
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model as TM

B, S = 2, 32


def flatten(tree) -> dict:
    """A JAX pytree as f32 numpy leaves by dotted path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        out[key] = np.asarray(jnp.asarray(leaf, jnp.float32))
    return out


def make_batch(cfg, T: int = S, batch: int = B, seed: int = 1) -> dict:
    """Token ids (or embeddings) and labels, from a numpy seed."""
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.randn(batch, T, cfg.d_model).astype(np.float32)
    else:
        inputs = rng.randint(2, cfg.vocab, (batch, T)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (batch, T)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def configs(arch: str, over: dict | None = None):
    over = over or {}
    return (dataclasses.replace(j_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def jax_value_and_grad(jcfg, batch: dict):
    """The reference's weights from key 0, and ``jax.value_and_grad`` of its
    ``loss_fn`` on ``batch``: (params, loss, metrics, grads), leaves by
    dotted path."""
    params = JM.init_params(jcfg, jax.random.key(0))
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return (flatten(params), float(loss), {k: float(v) for k, v in metrics.items()},
            flatten(grads))


def port_value_and_grad(tcfg, params: dict, batch: dict):
    tp = lm_params_from_numpy(tcfg, params, device="cpu")
    (loss, metrics), grads = value_and_grad(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, dict(tree_paths(grads))


def check_against_jax(arch: str, over: dict | None = None, T: int = S) -> dict:
    """The port's loss, metrics and gradients against JAX's for ``arch``'s
    smoke config with ``over``; returns the port's gradients."""
    jcfg, tcfg = configs(arch, over)
    batch = make_batch(jcfg, T)
    params, j_loss, j_metrics, j_grads = jax_value_and_grad(jcfg, batch)
    t_loss, t_metrics, t_grads = port_value_and_grad(tcfg, params, batch)
    assert t_loss == pytest.approx(j_loss, rel=1e-5)
    assert set(t_metrics) == set(j_metrics) == {"nll", "z_loss", "moe_aux"}
    for k in j_metrics:
        assert t_metrics[k] == pytest.approx(j_metrics[k], rel=1e-5, abs=1e-7), k
    assert set(t_grads) == set(j_grads)
    gmax = max(np.abs(g).max() for g in j_grads.values())
    for path, want in j_grads.items():
        got = t_grads[path].float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=f"{arch}: d{path}")
    return t_grads


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-3b", "gemma-7b", "gemma-2b",
                                  "qwen2-vl-72b", "hubert-xlarge"])
def test_loss_and_grads_match_jax(arch):
    check_against_jax(arch)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-72b"])
def test_remat_gives_the_same_grads(arch, monkeypatch):
    """Each stage under ``torch.utils.checkpoint`` (``cfg.remat``) against
    no remat: the same loss and gradients, the stage recomputed."""
    _, tcfg = configs(arch)
    params = lm_params_from_numpy(tcfg, flatten(JM.init_params(
        j_get_config(arch, smoke=True), jax.random.key(0))), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg).items()}
    calls = []
    orig = TM._stage_fwd
    monkeypatch.setattr(TM, "_stage_fwd", lambda *a: calls.append(1) or orig(*a))
    out = {}
    for remat in (True, False):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        (loss, _), grads = value_and_grad(cfg, params, batch)
        out[remat] = (loss, dict(tree_paths(grads)), len(calls))
    assert out[True][2] == 2 * out[False][2] == 2 * sum(n for _, n in TM.segments_of(tcfg))
    assert torch.equal(out[True][0], out[False][0])
    for path, g in out[False][1].items():
        assert torch.equal(out[True][1][path], g), path
