"""``run_until`` on the card: the device loop's graph replay against the
plain host loop (``run_until_host``), and the configurations that
``tests/test_torch_until_loop.py`` holds against the JAX engines on the
CPU (this file imports no JAX, so that it runs where JAX is absent).

The tests here need a CUDA device and skip without one; run them there
with ``python -m pytest -q -m cuda tests/test_torch_until_loop_cuda.py``.
Tolerance is bit-exact: every state leaf, the stop cycle and epoch, and
the epoch counters; the launch counters equal what each loop launches.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.convert import fused_state_to_numpy, register_state_to_numpy
from repro_torch.core import ChannelGraph as TGraph
from repro_torch.core import device_loop
from repro_torch.core import tiered_grid_partition as t_tgp
from repro_torch.core.fastgrid import RegisterGridEngine as TReg
from repro_torch.core.fused import FusedEngine as TFused
from repro_torch.core.struct import tree_leaves
from repro_torch.hw.manycore import ManycoreCell as TCore
from repro_torch.hw.manycore import allreduce_done
from repro_torch.hw.manycore import make_core_params as t_core_params
from repro_torch.hw.systolic import SystolicCell as TCell
from repro_torch.hw.systolic import make_cell_params as t_cell_params
from repro_torch.kernels import fused_checks as fc
from repro_torch.kernels import granule_step, systolic_step
from repro_torch.obs.registry import REGISTRY

WAFER_TIERS = [(("pod",), 2), (("g",), 4)]
M, R, C, K = 12, 8, 8, 4
SPANS = (1, 3, 8)
BUDGETS = (0, 1, 3, 100)
CONFIGS = ("wafer", "grid", "grid-2x2", "grid-2x2-overlap", "register",
           "register-2x2")


def _operands():
    rng = np.random.RandomState(7)
    return rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)


def _t_done(config):
    """The port's predicate of a configuration (on the run_until view)."""
    if config == "wafer":
        return lambda s: allreduce_done(s.block_states[0])
    if config.startswith("grid"):
        return lambda s: fc.south_done(s.block_states[0], M)
    return lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all()


def port_engine(config, device="cpu"):
    """The port's engine of a configuration on ``device``, and its
    initial state."""
    if config == "wafer":
        vals = fc.torus_values(8, 8)
        graph = TGraph.torus(TCore(8, 8), 8, 8, params=t_core_params(vals),
                             capacity=8)
        eng = TFused(graph, t_tgp(8, 8, [(2, 1), (2, 2)]), None,
                     tiers=WAFER_TIERS, batch_axes={"pod": 2, "g": 4},
                     device=device)
        return eng, eng.init(0)
    A, B = _operands()
    if config.startswith("grid"):
        batch = {"gr": 2, "gc": 2} if "2x2" in config else None
        eng = TFused.grid(TCell(m_stream=M), R, C, K=K, params=t_cell_params(A, B),
                          batch_axes=batch, overlap=config.endswith("overlap"),
                          device=device)
        return eng, eng.init(0)
    tiles = (2, 2) if config.endswith("2x2") else (1, 1)
    graph = TGraph.grid(TCell(m_stream=M), R, C, params=t_cell_params(A, B))
    eng = TReg.from_graph(graph, K=K, tiles=tiles, device=device)
    return eng, eng.init()


def to_numpy(state) -> dict:
    if hasattr(state, "cell"):
        return register_state_to_numpy(state)
    return fused_state_to_numpy(state)


def assert_same(want: dict, got: dict, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        assert np.array_equal(got[k], want[k]), (where, k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop's graph replay runs only there")
    return torch.device("cuda")


def _counts() -> dict:
    return dict(REGISTRY.counters(), granule_step=granule_step.launches,
                systolic_step=systolic_step.launches)


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("config", CONFIGS)
def test_replay_matches_host_loop_on_card(cuda, config, span, monkeypatch):
    """The graph replay stops where the host loop does with its state bit
    for bit, at every budget, and counts the same epochs.  Launches are
    counted where they happen: the host loop launches its kernel once an
    epoch; the device loop once an epoch of the warm-up (a span with
    ``stop`` set) and, each time the graph replays, once for each call
    its capture recorded (one an epoch of the span, no-op epochs too)."""
    monkeypatch.setattr(device_loop, "SPAN", span)
    kernel = "systolic_step" if config.startswith("register") else "granule_step"
    for b in BUDGETS:
        eng, st = port_engine(config, cuda)
        c0 = _counts()
        want = to_numpy(eng.run_until_host(st, _t_done(config), b, donate=False))
        c1 = _counts()
        got = eng.run_until(st, _t_done(config), b, cache_key="done")
        c2 = _counts()
        assert_same(want, to_numpy(got), (config, span, b))
        host, dev = _delta(c0, c1), _delta(c1, c2)
        epochs = int(got.epoch.reshape(-1)[0])
        assert host["until.epochs"] == dev["until.epochs"] == epochs
        assert host[kernel] == epochs
        assert dev["until.captures"] == 1
        assert dev[kernel] == span * (dev["until.spans"] + dev["until.captures"])
        assert dev["until.spans"] == max(1, -(-epochs // span))


def _assign(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into ``dst``'s, in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s)


def _y_done_at(config, limit):
    """Every south cell collected ``limit`` outputs (a device tensor)."""
    if config.startswith("grid"):
        return lambda s: ((~s.block_states[0].is_south)
                          | (s.block_states[0].y_idx >= limit)).all()
    return lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= limit)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["grid-2x2", "register"])
def test_cached_predicate_keeps_what_it_reads(cuda, config):
    """A replay under a reused ``cache_key`` runs the predicate it
    captured, as the reference's jit runs the first one it traced, and
    the tensors that predicate reads live as long as the graph: a fresh
    lambda over a fresh device tensor changes nothing, even after the
    first one's tensor was dropped and its memory handed out again."""
    eng, st = port_engine(config, cuda)
    start = fc.clone(st)
    half = lambda: torch.tensor(M // 2, dtype=torch.int32, device=cuda)  # noqa: E731
    want = to_numpy(eng.run_until_host(fc.clone(start), _y_done_at(config, half()),
                                       100))
    st = eng.run_until(st, _y_done_at(config, half()), 100, cache_key="k")
    assert_same(want, to_numpy(st), "first call")
    gc.collect()
    # the freed () int32 block goes to the next such tensors, at a limit
    # no cell reaches
    junk = [torch.full((), 10 ** 6, dtype=torch.int32, device=cuda) for _ in range(64)]
    _assign(st, start)
    caps = REGISTRY.counters().get("until.captures", 0)
    full = torch.tensor(M, dtype=torch.int32, device=cuda)
    st = eng.run_until(st, _y_done_at(config, full), 100, cache_key="k")
    assert REGISTRY.counters().get("until.captures", 0) == caps
    assert_same(want, to_numpy(st), "replay under the same key")
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["wafer", "grid-2x2-overlap", "register"])
def test_reentry_replays_without_capture(cuda, config):
    """A second call with the same ``cache_key`` on the same state captures
    nothing new, and a done state replays zero epochs."""
    eng, st = port_engine(config, cuda)
    done = _t_done(config)
    caps = lambda: REGISTRY.counters().get("until.captures", 0)  # noqa: E731
    c0 = caps()
    st = eng.run_until(st, done, 2, cache_key="k")
    st = eng.run_until(st, done, 2, cache_key="k")
    assert caps() - c0 == 1 and int(st.epoch.reshape(-1)[0]) == 4
    st = eng.run_until(st, done, 100, cache_key="k100")
    before = to_numpy(st)
    spans = REGISTRY.counters().get("until.spans", 0)
    st = eng.run_until(st, done, 100, cache_key="k100")
    assert_same(before, to_numpy(st), "re-entered")
    assert REGISTRY.counters().get("until.spans", 0) - spans == 1
    assert caps() - c0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["wafer", "register"])
def test_syncing_predicate_raises(cuda, config):
    """A predicate that reads its result back to the host raises instead
    of falling back to a host loop."""
    eng, st = port_engine(config, cuda)
    inner = _t_done(config)
    with pytest.raises(device_loop.HostSyncError, match="without reading it back"):
        eng.run_until(st, lambda v: bool(inner(v)), 100)
    with pytest.raises(device_loop.HostSyncError, match="without reading it back"):
        eng.run_until(st, lambda v: True, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["wafer", "grid", "register"])
def test_capture_cause_after_reset(cuda, config):
    """Through the session: the first run under a predicate captures with
    cause ``first``; a reset builds its state at new addresses, so the run
    after it captures with cause ``moved``; a rerun on the same state
    captures nothing.  The causes add up to ``until.captures``, and the
    traced ``until.capture`` span names the cause."""
    from repro_torch.core import Simulation
    from repro_torch.obs import trace as obs_trace

    eng, _ = port_engine(config, cuda)
    done = _t_done(config)
    sim = Simulation(eng)
    names = ("until.captures", "until.captures.first", "until.captures.moved")
    counts = lambda: [REGISTRY.counters().get(n, 0) for n in names]  # noqa: E731
    rec = obs_trace.recorder()
    rec.clear()
    rec.enable()
    try:
        c0 = counts()
        sim.reset(0)
        sim.run(until=done, max_epochs=1000)
        c1 = counts()
        sim.reset(0)
        sim.run(until=done, max_epochs=1000)
        c2 = counts()
        sim.run(until=done, max_epochs=1000)
        c3 = counts()
        caps = [e for e in rec.events if e["name"] == "until.capture"]
    finally:
        rec.disable()
        rec.clear()
    assert [b - a for a, b in zip(c0, c1)] == [1, 1, 0]
    assert [b - a for a, b in zip(c1, c2)] == [1, 0, 1]
    assert c3 == c2
    assert [e["args"]["cause"] for e in caps] == ["first", "moved"]
    assert [e["args"]["run"] for e in caps] == [rec.run - 1, rec.run]
