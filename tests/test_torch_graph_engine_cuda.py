"""The queue-interpreter ``GraphEngine`` on the card: its in-place path
against the functional one on a CPU copy, the device loop against the
host loop, and the engine against ``FusedEngine`` at capacity 2 (this file
imports no JAX, so that it runs where JAX is absent;
``tests/test_torch_graph_engine.py`` holds the engine against the JAX
package on the CPU).

The tests here need a CUDA device and skip without one; run them there
with ``python -m pytest -q -m cuda tests/test_torch_graph_engine_cuda.py``.
Tolerance is bit-exact: every state leaf, the stop cycle and epoch, and
the epoch counters.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import graph_state_to_numpy
from repro_torch.core import ChannelGraph, device_loop, tiered_grid_partition
from repro_torch.core import queue as qmod
from repro_torch.core.distributed import GraphEngine, GridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.core.struct import tree_map
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.systolic import SystolicCell, make_cell_params
from repro_torch.kernels import granule_step, systolic_step
from repro_torch.obs.registry import REGISTRY

TIERS = [(("pod",), 2), (("g",), 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the in-place path and the graph replay "
                    "run only there")
    return torch.device("cuda")


def wafer(device, R=8, C=8, cap=4, overlap=False):
    vals = ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C, params=make_core_params(vals),
                               capacity=cap)
    return GraphEngine(graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
                       tiers=TIERS, batch_axes={"pod": 2, "g": 4}, overlap=overlap,
                       device=device)


def done(s):
    return allreduce_done(s.block_states[0], s.tables.active[0])


def to_cpu(state):
    return tree_map(lambda x: x.cpu(), state)


def assert_same(want: dict, got: dict, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (where, k)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_card_matches_cpu_copy(cuda, overlap):
    """Every leaf of the card's in-place run equals the same engine's
    functional run on a CPU copy after every epoch, to the allreduce's
    end."""
    eng = wafer(cuda, overlap=overlap)
    gpu = eng.init(0)
    cpu = to_cpu(gpu)
    for ep in range(100):
        gpu, cpu = eng.run_epochs(gpu, 1), eng.run_epochs(cpu, 1)
        assert_same(graph_state_to_numpy(cpu), graph_state_to_numpy(gpu), ep)
        if bool(done(eng._local_view(cpu))):
            break
    assert (eng.gather_group(gpu, 0).total == 8 * 36).all()


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, 3, 8])
def test_device_loop_matches_host_loop(cuda, span, monkeypatch):
    """The graph replay stops where the host loop does with its state bit
    for bit at every budget, counts the same epochs, and launches neither
    hand-written kernel (the queue interpreter is plain PyTorch)."""
    monkeypatch.setattr(device_loop, "SPAN", span)
    for b in (0, 1, 3, 100):
        eng = wafer(cuda)
        n0 = (granule_step.launches, systolic_step.launches)
        c0 = REGISTRY.counters().get("until.epochs", 0)
        want = graph_state_to_numpy(eng.run_until_host(eng.init(0), done, b))
        c1 = REGISTRY.counters().get("until.epochs", 0)
        got = eng.run_until(eng.init(0), done, b, cache_key="done")
        c2 = REGISTRY.counters().get("until.epochs", 0)
        assert_same(want, graph_state_to_numpy(got), (span, b))
        epochs = int(got.epoch.reshape(-1)[0])
        assert c1 - c0 == c2 - c1 == epochs
        assert (granule_step.launches, systolic_step.launches) == n0


@pytest.mark.cuda
def test_capacity2_matches_fused_engine(cuda):
    """At capacity 2 and K = (1, 1) the queue interpreter is cycle-identical
    to the fused engine (the ``granule_step`` kernel): every block state
    equal after every epoch."""
    vals = np.random.RandomState(3).randint(1, 20, size=(4, 4)).astype(np.float32)

    def graph():
        return ChannelGraph.torus(ManycoreCell(4, 4), 4, 4,
                                  params=make_core_params(vals), capacity=2)

    kw = dict(tiers=[(("g",), 1)], batch_axes={"g": 4}, device=cuda)
    eng = GraphEngine(graph(), np.arange(16) % 4, None, **kw)
    fused = FusedEngine(graph(), np.arange(16) % 4, None, **kw)
    gs, fs = eng.init(0), fused.init(0)
    for t in range(40):
        gs, fs = eng.run_epochs(gs, 1), fused.run_epochs(fs, 1)
        a, b = eng.gather_group(gs, 0), fused.gather_group(fs, 0)
        for name in ("own", "acc", "total", "phase", "sent", "rcvd", "fwd", "fwd_v",
                     "fires"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), (t, name)
    assert (eng.gather_group(gs, 0).total == vals.sum()).all()


@pytest.mark.cuda
def test_inplace_queue_ops_match_functional(cuda):
    """``cycle_``, ``stage_drain_`` and ``stage_fill_`` on the card write
    the bits the functional forms return, into the queue's own tensors."""
    n, cap, W = 4096, 8, 2
    g = torch.Generator(device=cuda).manual_seed(0)
    q = qmod.QueueArray(
        buf=torch.randn((n, cap, W), generator=g, device=cuda),
        head=torch.randint(0, cap, (n,), generator=g, device=cuda, dtype=torch.int32),
        tail=torch.randint(0, cap, (n,), generator=g, device=cuda, dtype=torch.int32),
        capacity=cap)
    clone = lambda q: q.replace(buf=q.buf.clone(), head=q.head.clone(),  # noqa: E731
                                tail=q.tail.clone())
    same = lambda a, b: all(torch.equal(getattr(a, f), getattr(b, f))  # noqa: E731
                            for f in ("buf", "head", "tail"))
    pay = torch.randn((n, W), generator=g, device=cuda)
    pv = torch.rand(n, generator=g, device=cuda) < 0.5
    pr = torch.rand(n, generator=g, device=cuda) < 0.5
    want = qmod.cycle(q, pay, pv, pr)[0]
    got = clone(q)
    ptr = got.buf.data_ptr()
    assert same(want, qmod.cycle_(got, pay, pv, pr)[0]) and got.buf.data_ptr() == ptr
    # real rows once each, padding repeated on scratch row 0 (limit 0)
    idx = torch.tensor([5, 0, 9, 0, 17, 0, 300, 0, 1200, 4000], dtype=torch.int32,
                       device=cuda)
    limit = torch.where(idx > 0, 3, 0).to(torch.int32)
    a, sa, ca = qmod.stage_drain(q, idx, cap - 1, limit=limit)
    b, sb, cb = qmod.stage_drain_(clone(q), idx, cap - 1, limit=limit)
    assert same(a, b) and torch.equal(sa, sb) and torch.equal(ca, cb)
    payloads = torch.randn((idx.numel(), cap - 1, W), generator=g, device=cuda)
    assert same(qmod.stage_fill(q, idx, payloads, limit),
                qmod.stage_fill_(clone(q), idx, payloads, limit))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
def test_grid_engine_card_matches_cpu(cuda, tiles):
    """``GridEngine`` of SystolicCells (``step_`` writes y_buf in place on
    the card) ends in the CPU copy's state and ``Y``."""
    M, R, C, K = 12, 8, 8, 4
    rng = np.random.RandomState(7)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    batch = {"gr": tiles[0], "gc": tiles[1]} if tiles != (1, 1) else None
    pred = lambda c: ((~c.is_south) | (c.y_idx >= M)).all()  # noqa: E731
    out = []
    for dev in (cuda, "cpu"):
        eng = GridEngine(SystolicCell(M), R, C, K=K, batch_axes=batch, device=dev)
        st = eng.run_until(eng.init(0, make_cell_params(A, B)), pred, 1000)
        out.append(graph_state_to_numpy(st))
    assert_same(out[1], out[0], tiles)
    Y = eng.gather_cells(st).y_buf[R - 1].T
    assert np.abs(Y - A.astype(np.float64) @ B).max() < 1e-4


@pytest.mark.cuda
def test_syncing_predicate_raises(cuda):
    eng = wafer(cuda)
    with pytest.raises(device_loop.HostSyncError, match="without reading it back"):
        eng.run_until(eng.init(0), lambda s: bool(done(s)), 100)
