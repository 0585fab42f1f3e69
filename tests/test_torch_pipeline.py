"""``core.pipeline.Pipeline`` on the CPU: the GPipe fill/drain wavefront
over 1-4 stage shards (each a ``torch.device`` of the single controller)
against the unpipelined stages, forward and gradients, and the
single-stage case against the JAX package's ``Pipeline`` on a one-device
mesh (``tests/test_pipeline.py::test_pipeline_single_stage_identity``;
its multi-device case needs the reference's Auto-axis mesh, R2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat import make_mesh
from repro.core.pipeline import Pipeline as JPipeline
from repro_torch.core.mesh import ShardedState
from repro_torch.core.pipeline import Pipeline, stage_shardings


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _reference(params, x):
    h = x
    for s in range(params["w"].shape[0]):
        h = _stage_fn({k: v[s] for k, v in params.items()}, h)
    return h


def _params(S, d, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": torch.tensor((rng.randn(S, d, d) / np.sqrt(d)).astype(np.float32)),
            "b": torch.tensor((rng.randn(S, d) * 0.1).astype(np.float32))}


def test_pipeline_single_stage_identity():
    d, M, mb = 8, 3, 4
    rng = np.random.RandomState(1)
    p_np = {"w": (rng.randn(1, d, d) / np.sqrt(d)).astype(np.float32),
            "b": np.zeros((1, d), np.float32)}
    x = rng.randn(M, mb, d).astype(np.float32)
    jpipe = JPipeline(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                      make_mesh((1,), ("stage",)), axis="stage")
    want = np.asarray(jpipe(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x)))
    pipe = Pipeline(_stage_fn, {"stage": 1}, device="cpu")
    got = pipe({k: torch.tensor(v) for k, v in p_np.items()}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,M", [(2, 5), (3, 3), (4, 6), (4, 2)])
def test_pipeline_fwd_and_grad_match_unpipelined(S, M):
    d, mb = 16, 8
    params = _params(S, d)
    x = torch.tensor(np.random.RandomState(2).randn(M, mb, d).astype(np.float32))
    tgt = torch.tensor(np.random.RandomState(3).randn(M, mb, d).astype(np.float32))
    pipe = Pipeline(_stage_fn, {"stage": S}, device="cpu")
    assert pipe.devices == (torch.device("cpu"),) * S
    calls = []
    counted = Pipeline(lambda p, h: calls.append(1) or _stage_fn(p, h), {"stage": S},
                       device="cpu")
    counted(params, x)
    assert len(calls) == S * M  # a stage computes only where a microbatch is

    pp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pr = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out_p, out_r = pipe(pp, x), _reference(pr, x)
    np.testing.assert_allclose(out_p.detach().numpy(), out_r.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    gp = torch.autograd.grad(((out_p - tgt) ** 2).sum(), list(pp.values()))
    gr = torch.autograd.grad(((out_r - tgt) ** 2).sum(), list(pr.values()))
    for a, b in zip(gp, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)

    placed = pipe.place(params)
    assert isinstance(placed, ShardedState) and len(placed.shards) == S
    np.testing.assert_allclose(pipe(placed, x).numpy(), out_r.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    sh = stage_shardings(pipe.devices, params)
    assert sh["w"] == pipe.devices
