"""Real mesh axes on the card: every shard on the one CUDA device, each
launching its own kernels, against the same sharded engine run on the CPU
(the kernels' plain versions) and against the one-shard run of the same
granules stacked on the batch axis; the device loop against the host
loop.  ``tests/test_torch_mesh.py`` holds the same engines against the
JAX package's meshes on the CPU (this file imports no JAX, so that it runs
where JAX is absent).

The tests here need a CUDA device and skip without one; run them there
with ``python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py``.
Tolerance is bit-exact; the one-shard comparison leaves the credit
columns out, as the class layout of a real axis is its own.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import fused_state_to_numpy, register_state_to_numpy
from repro_torch.core import ChannelGraph, tiered_grid_partition
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.core.mesh import ShardedState
from repro_torch.core.struct import tree_map
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
from repro_torch.kernels import granule_step, systolic_step

pytestmark = pytest.mark.cuda

LAYOUTS = {
    "pods": dict(mesh={"pod": 2}, batch_axes={"gr": 2, "gc": 2}),
    "mesh8": dict(mesh={"pod": 2, "gr": 2, "gc": 2}),
    "one-shard": dict(batch_axes={"pod": 2, "gr": 2, "gc": 2}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def wafer(cls, layout, device, overlap=False, R=16):
    vals = ((np.arange(R * R) % 8) + 1).astype(np.float32).reshape(R, R)
    g = ChannelGraph.torus(ManycoreCell(R, R), R, R, params=make_core_params(vals),
                           capacity=4)
    return cls(g, tiered_grid_partition(R, R, [(2, 1), (2, 2)]),
               tiers=[(("pod",), 2), (("gr", "gc"), 4)], overlap=overlap,
               device=device, **LAYOUTS[layout])


def to_cpu(state):
    return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)


def same(a: dict, b: dict, skip=()):
    keys = [k for k in a if not k.startswith(tuple(skip))]
    assert sorted(keys) == sorted(k for k in b if not k.startswith(tuple(skip)))
    for k in keys:
        assert np.array_equal(a[k].reshape(-1), b[k].reshape(-1)), k


def done(s):
    return allreduce_done(s.block_states[0], s.tables.active[0])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("layout", ["pods", "mesh8"])
@pytest.mark.parametrize("cls", [FusedEngine, GraphEngine])
def test_wafer_shards_on_the_card(card, cls, layout, overlap):
    eng = wafer(cls, layout, card, overlap)
    one = wafer(cls, "one-shard", card, overlap)
    gpu = eng.init(0)
    assert isinstance(gpu, ShardedState)
    assert all(s.cycle.device.type == torch.device(card).type for s in gpu.shards)
    cpu, ref = to_cpu(gpu), one.init(0)
    for ep in range(6):
        n0 = granule_step.launches
        gpu = eng.run_epochs(gpu, 1)
        if cls is FusedEngine:  # one program a shard a round of the outer tier
            assert granule_step.launches - n0 >= eng.G_real
        cpu, ref = eng.run_epochs(cpu, 1), one.run_epochs(ref, 1)
        torch.cuda.synchronize()
        got = fused_state_to_numpy(gpu)
        same(got, fused_state_to_numpy(cpu))
        same(got, fused_state_to_numpy(ref), skip=("credits",))
    dev = eng.run_until(eng.init(0), done, 1000)
    host = eng.run_until_host(eng.init(0), done, 1000)
    want = one.run_until(one.init(0), done, 1000)
    torch.cuda.synchronize()
    same(fused_state_to_numpy(dev), fused_state_to_numpy(host))
    same(fused_state_to_numpy(dev), fused_state_to_numpy(want), skip=("credits",))
    assert (eng.gather_group(dev, 0).phase == 2).all()


def test_register_mesh_on_the_card(card):
    rng = np.random.RandomState(1)
    M, R, C, K = 12, 8, 8, 7
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    mesh = RegisterGridEngine(R, C, K=K, m_stream=M, mesh={"gr": 2, "gc": 2}, device=card)
    stacked = RegisterGridEngine(R, C, K=K, m_stream=M, tiles=(2, 2), device=card)
    gpu, ref = mesh.init(A, B), stacked.init(A, B)
    cpu = to_cpu(gpu)
    for ep in range(5):
        n0 = systolic_step.launches
        gpu = mesh.run_epochs(gpu, 1)
        assert systolic_step.launches - n0 == 4  # one launch a shard
        cpu, ref = mesh.run_epochs(cpu, 1), stacked.run_epochs(ref, 1)
        got = register_state_to_numpy(gpu)
        same(got, register_state_to_numpy(cpu))
        same(got, register_state_to_numpy(ref))
    dev = mesh.run_until_done(mesh.init(A, B), 1000)
    host = mesh.run_until_host(mesh.init(A, B), mesh.y_done, 1000)
    same(register_state_to_numpy(dev), register_state_to_numpy(host))
    np.testing.assert_allclose(mesh.result(dev), A @ B, rtol=1e-5)


def test_shards_on_several_cards_refuse_the_device_loop(card):
    """A device sequence names one card a shard.  With one card: naming
    ``cuda:0`` twice puts both shards there, and naming an absent card
    raises.  With two or more: the shards land on their cards, ``run_epochs``
    runs them with peer copies between, and ``run_until`` refuses (one
    CUDA graph holds one card's work) naming ROADMAP."""
    if torch.cuda.device_count() < 2:
        eng = wafer(FusedEngine, "pods", ["cuda:0", "cuda:0"])
        assert eng.shardings() == (torch.device("cuda", 0),) * 2
        with pytest.raises(RuntimeError, match="not present"):
            wafer(FusedEngine, "pods", ["cuda:0", "cuda:1"])
        return
    eng = wafer(FusedEngine, "pods", ["cuda:0", "cuda:1"])
    st = eng.run_epochs(eng.init(0), 2)
    assert [s.cycle.device.index for s in st.shards] == [0, 1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run_until(st, done, 10)
