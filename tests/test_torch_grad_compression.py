"""``optim.grad_compression`` against the JAX package on the CPU: the int8
block quantizer (``tests/test_substrates.py``'s round trip, and q and the
scales equal to the reference's), ``quantized_psum`` over per-shard tensors
against the reference's ``psum``/``pmax`` (run under ``jax.vmap`` with a
named axis, one entry a shard, so no mesh is needed), and
``TopKCompressor``'s error feedback."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as J
from repro_torch.optim.grad_compression import (TopKCompressor, _dequantize_int8,
                                                _quantize_int8, quantized_psum)


def test_int8_quantize_roundtrip():
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1000).astype(np.float32) * 5)
    q, scale = _quantize_int8(x)
    back = _dequantize_int8(q, scale, x.shape, x.dtype)
    rel = float((back - x).abs().max() / x.abs().max())
    assert rel < 0.02  # int8 block quantization: <2% max error


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 5, 11)])
def test_quantize_matches_jax(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3
    q, scale = _quantize_int8(torch.tensor(x))
    jq, jscale = J._quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        _dequantize_int8(q, scale, shape, torch.float32).numpy(),
        np.asarray(J._dequantize_int8(jq, jscale, shape, jnp.float32)))


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_quantized_psum_matches_jax(n_shards):
    """Every shard gets the reference's result: the int32 sum of the int8
    payloads times the largest scale of each block."""
    xs = np.random.RandomState(n_shards).randn(n_shards, 5, 300).astype(np.float32)
    want = jax.vmap(lambda x: J.quantized_psum(x, "pod"), axis_name="pod")(jnp.asarray(xs))
    got = quantized_psum([torch.tensor(x) for x in xs])
    assert len(got) == n_shards
    for g, w in zip(got, np.asarray(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    # shards that hold one tensor share its scales: n times its round trip
    x0 = torch.tensor(xs[0])
    same = quantized_psum([x0] * n_shards)
    q, scale = _quantize_int8(x0)
    np.testing.assert_allclose(same[0].numpy(), n_shards * _dequantize_int8(
        q, scale, x0.shape, torch.float32).numpy(), rtol=1e-6)


def test_topk_error_feedback_preserves_signal():
    """Sum of sent values over rounds plus the residual is the true
    gradient sum (nothing lost); the sent values are the reference's."""
    comp = TopKCompressor(ratio=0.25)
    gw = np.random.RandomState(1).randn(64).astype(np.float32)
    g = {"w": torch.tensor(gw)}
    residual = comp.init(g)
    jcomp = J.TopKCompressor(ratio=0.25)
    jg = {"w": jnp.asarray(gw)}
    jres = jcomp.init(jg)
    sent_total = torch.zeros(64)
    for _ in range(8):
        compressed, residual = comp.compress(g, residual)
        jc, jres = jcomp.compress(jg, jres)
        sent = comp.decompress(compressed, g)["w"]
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jcomp.decompress(jc, jg)["w"]))
        sent_total = sent_total + sent
    want = g["w"] * 8
    np.testing.assert_allclose((sent_total + residual["w"]).numpy(), want.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(residual["w"].numpy(), np.asarray(jres["w"]))
    assert float((sent_total - want).abs().max()) <= float(g["w"].abs().max()) / 0.25
