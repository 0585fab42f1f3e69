"""``Simulation.reset`` in place: a reset of a session that holds a state
writes the new initial state into the live tensors, so the state keeps
its addresses and a captured until-loop replays (``core.session``).

On the CPU, at small sizes: the 6x4 @ 4x4 systolic network on the single,
graph, fused and register engines (new operands a reset), and the 8x8
``ManycoreCell`` wafer of 2 pods x 4 granules on the graph and fused
engines (new values a reset), as the benchmark drives them, and on the
fused engine with the pods as real shards (a ``ShardedState``).
Tolerance is bit-exact: every state leaf against a fresh ``engine.init``,
every result and stop cycle against a new session.  No JAX: the yardstick
is the port's own fresh state.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ChannelGraph, Network, Simulation, tiered_grid_partition
from repro_torch.core.block import Block
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.core.session import _write_into
from repro_torch.core.struct import tensor_dataclass, tree_leaves, tree_map, tree_paths
from repro_torch.hw.manycore import CoreParams, ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.systolic import make_cell_params, make_systolic_network
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.registry import REGISTRY

M, R, C = 6, 4, 4
CONFIGS = ("single", "graph", "fused", "register", "wafer-graph", "wafer-fused",
           "wafer-mesh-fused")


def _operands(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)


def _wafer_values(seed):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randint(-8, 9, size=64).astype(np.float32))


def build(config) -> Simulation:
    """A new session of ``config`` on the CPU."""
    if config.startswith("wafer"):
        graph = ChannelGraph.torus(ManycoreCell(8, 8), 8, 8,
                                   params=make_core_params(np.ones((8, 8), np.float32)),
                                   capacity=8)
        cls = FusedEngine if config.endswith("fused") else GraphEngine
        # "mesh": the pods are real shards, so the state is a ShardedState
        axes = ({"mesh": {"pod": 2}, "batch_axes": {"g": 4}} if "mesh" in config
                else {"mesh": None, "batch_axes": {"pod": 2, "g": 4}})
        eng = cls(graph, tiered_grid_partition(8, 8, [(2, 1), (2, 2)]),
                  tiers=[(("pod",), 2), (("g",), 4)], device="cpu", **axes)
        return Simulation(eng)
    net, _ = make_systolic_network(*_operands(0))
    if config == "single":
        return net.build(device="cpu")
    return net.build(engine=config, device="cpu", K=4)


def init_kw(config, seed) -> dict:
    """The arguments of the reset of run ``seed``: new operands or values
    (the single engine's ``init`` takes none, so its resets repeat)."""
    if config.startswith("wafer"):
        return {"group_params": {0: CoreParams(value=_wafer_values(seed))}}
    if config == "single":
        return {}
    A, B = _operands(seed)
    if config == "register":
        return {"A": A, "B": B}
    p = make_cell_params(A, B)
    return {"group_params": {0: tree_map(lambda x: torch.as_tensor(x).reshape(
        (R * C,) + x.shape[2:]), p)}}


def reset(sim, config, seed):
    return sim.reset(0, **init_kw(config, seed))


def fresh_init(sim, config, seed):
    kw = init_kw(config, seed)
    return sim.engine.init(**kw) if config == "register" else sim.engine.init(0, **kw)


def done_of(sim):
    if sim.kind == "register":
        return lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all()
    if isinstance(sim.engine.graph.groups[0].block, ManycoreCell):
        return lambda s: allreduce_done(s.block_states[0], s.tables.active[0])
    return lambda s: ((~s.block_states[0].is_south) | (s.block_states[0].y_idx >= M)).all()


def run_to_end(sim):
    sim.run(until=done_of(sim), max_epochs=10_000)


def result(sim) -> np.ndarray:
    if sim.kind == "register":
        return np.asarray(sim.engine.result(sim.state))
    if isinstance(sim.engine.graph.groups[0].block, ManycoreCell):
        return np.asarray(sim.engine.gather_group(sim.state, 0).total)
    cols = [sim.probe((R - 1) * C + c) for c in range(C)]
    return np.stack([np.asarray(c.y_buf) for c in cols], axis=1)


def ptrs(state) -> list:
    return [(p, x.data_ptr(), tuple(x.shape), x.dtype) for p, x in tree_paths(state)]


def assert_same_leaves(want, got, where):
    pw, pg = tree_paths(want), tree_paths(got)
    assert [p for p, _ in pw] == [p for p, _ in pg], where
    for (p, w), (_, g) in zip(pw, pg):
        assert g.dtype == w.dtype and g.shape == w.shape, (where, p)
        assert torch.equal(g, w), (where, p)


def resets() -> dict:
    c = REGISTRY.counters()
    return {m: c.get(f"session.reset.{m}", 0) for m in ("in_place", "rebuilt")}


@pytest.mark.parametrize("config", CONFIGS)
def test_reset_after_run_keeps_addresses(config):
    """reset -> run to the end -> reset leaves every leaf at its address,
    equal bit for bit to a fresh ``engine.init`` with the same key and
    arguments, and counts ``session.reset.in_place``; the traced span
    names the mode."""
    sim = build(config)
    rec = obs_trace.recorder()
    rec.clear()
    rec.enable()
    try:
        c0 = resets()
        reset(sim, config, 1)
        run_to_end(sim)
        assert sim.cycle > 0
        before = ptrs(sim.state)
        c1 = resets()
        reset(sim, config, 2)
        c2 = resets()
        modes = [e["args"]["mode"] for e in rec.events if e["name"] == "session.reset"]
    finally:
        rec.disable()
        rec.clear()
    assert modes == ["rebuilt", "in_place"]
    assert c1["rebuilt"] - c0["rebuilt"] == 1 and c1["in_place"] == c0["in_place"]
    assert c2["in_place"] - c1["in_place"] == 1 and c2["rebuilt"] == c1["rebuilt"]
    assert ptrs(sim.state) == before
    assert_same_leaves(fresh_init(sim, config, 2), sim.state, config)
    assert sim.cycle == 0


@pytest.mark.parametrize("config", CONFIGS)
def test_run_after_inplace_reset_matches_new_session(config):
    """A run after an in-place reset gives the result and stop cycle of the
    same run in a new session, and so does the run after the next one."""
    sim = build(config)
    reset(sim, config, 1)
    run_to_end(sim)
    got = []
    for seed in (2, 3):
        reset(sim, config, seed)
        run_to_end(sim)
        got.append((result(sim), sim.cycle))
    for seed, (out, cycle) in zip((2, 3), got):
        new = build(config)
        reset(new, config, seed)
        run_to_end(new)
        np.testing.assert_array_equal(out, result(new), err_msg=f"{config} run {seed}")
        assert cycle == new.cycle > 0


def _constants(sim) -> list:
    """Copies of what a reset reads and must never write: the engine's host
    tables, the IR's params, the register engine's operands."""
    eng = sim.engine
    out = [np.array(x, copy=True) for x in tree_leaves(getattr(eng, "_graph_ab", ()))]
    for name in ("_rx_flat", "_tx_flat", "_inv_tx_flat", "_inv_rx_flat", "_rx_tables",
                 "_tx_tables", "_act_tables", "_send_idx", "_recv_idx"):
        out += [np.array(x, copy=True) for x in getattr(eng, name, ())]
    graph = getattr(eng, "graph", None)
    if graph is not None:
        out += [np.array(torch.as_tensor(x), copy=True)
                for g in graph.groups for x in tree_leaves(g.params)]
    return out


@pytest.mark.parametrize("config", CONFIGS)
def test_runs_leave_callers_and_engine_constants_alone(config):
    """The caller's ``group_params`` tensors (or operands), the engine's
    tables and the IR's params are not changed by in-place resets and the
    runs after them, and no two live leaves share memory."""
    sim = build(config)
    kws = [init_kw(config, seed) for seed in (1, 2, 3)]
    kept = [[np.array(torch.as_tensor(x), copy=True) for x in tree_leaves(kw)] for kw in kws]
    consts = _constants(sim)
    for kw in kws:
        if config == "register":
            sim.reset(**kw)
        else:
            sim.reset(0, **kw)
        run_to_end(sim)
        leaves = [x for x in tree_leaves(sim.state) if x.numel()]
        starts = [x.untyped_storage().data_ptr() for x in leaves]
        assert len(set(starts)) == len(starts), config
    for kw, want in zip(kws, kept):
        for x, w in zip(tree_leaves(kw), want):
            np.testing.assert_array_equal(np.asarray(torch.as_tensor(x)), w)
    for x, w in zip(_constants(sim), consts):
        np.testing.assert_array_equal(x, w)


# ------------------------------------------------------------ rebuild paths
@tensor_dataclass
class _BufParams:
    buf: torch.Tensor  # (n, width)


@tensor_dataclass
class _BufState:
    count: torch.Tensor
    buf: torch.Tensor  # (n, width): its width is the params'


class _BufStage(Block):
    """A forwarding stage whose state holds a buffer as wide as its
    params say: a reset with wider params gives a state of other shapes."""

    in_ports = ("in",)
    out_ports = ("out",)
    payload_words = 2

    def init_state(self, n, params=None, *, generator=None, device=None):
        buf = torch.as_tensor(params.buf, dtype=torch.float32, device=device)
        return _BufState(count=torch.zeros((n,), dtype=torch.int32, device=device),
                         buf=buf.reshape(n, -1).clone())

    def step(self, state, rx, tx_ready):
        pay, valid = rx["in"]
        fire = valid & tx_ready["out"]
        return (state.replace(count=state.count + fire.to(torch.int32)),
                {"in": fire}, {"out": (pay, fire)})


def _buf_ring(engine, n=4, width=3):
    net = Network(payload_words=2, capacity=4)
    blk = _BufStage()
    insts = [net.instantiate(blk, name=f"s{i}",
                             params=_BufParams(buf=np.full((width,), i, np.float32)))
             for i in range(n)]
    for i in range(n):
        net.connect(insts[i]["out"], insts[(i + 1) % n]["in"])
    return net.build(engine=engine, device="cpu", K=2)


@pytest.mark.parametrize("engine", ("graph", "fused"))
def test_reset_to_other_shapes_rebuilds(engine):
    """A reset whose new state has other shapes (wider params) builds a new
    state, counted ``session.reset.rebuilt``, equal to a fresh init; a
    reset back to the first width is in place again."""
    sim = _buf_ring(engine)
    wide = {0: _BufParams(buf=torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5))}
    sim.reset(0)
    sim.run(cycles=4)
    c0 = resets()
    sim.reset(0, group_params=wide)
    c1 = resets()
    assert c1["rebuilt"] - c0["rebuilt"] == 1 and c1["in_place"] == c0["in_place"]
    assert_same_leaves(sim.engine.init(0, group_params=wide), sim.state, engine)
    assert sim.probe(3).buf.shape == (5,)
    sim.run(cycles=4)
    before = ptrs(sim.state)
    sim.reset(0, group_params=wide)
    assert resets()["in_place"] - c1["in_place"] == 1
    assert ptrs(sim.state) == before


@pytest.mark.parametrize("config", ("single", "graph", "fused", "register"))
def test_poisoned_state_rebuilds(config):
    """A state a legacy shim donated and poisoned is never written: the
    reset after it builds a new state, counted ``session.reset.rebuilt``,
    and the session runs on as a new one does."""
    sim = build(config)
    reset(sim, config, 1)
    never = ((lambda c: c["y_idx"] < 0) if config == "register"
             else (lambda s: s.block_states[0].y_idx < 0))
    with pytest.warns(DeprecationWarning):
        sim.run_until(sim.state, lambda v: never(v).all(), 1)
    with pytest.raises(Exception, match="donated"):
        sim.cycle
    c0 = resets()
    reset(sim, config, 2)
    c1 = resets()
    assert c1["rebuilt"] - c0["rebuilt"] == 1 and c1["in_place"] == c0["in_place"]
    assert_same_leaves(fresh_init(sim, config, 2), sim.state, config)
    run_to_end(sim)
    new = build(config)
    reset(new, config, 2)
    run_to_end(new)
    np.testing.assert_array_equal(result(sim), result(new))


@pytest.mark.parametrize("config", ("single", "graph", "fused", "register"))
def test_write_into_refuses_other_trees(config):
    """``_write_into`` copies nothing and returns False where one leaf of
    the new state has another shape or dtype, or the trees differ."""
    sim = build(config)
    reset(sim, config, 1)
    live = sim.state
    snap = [x.clone() for x in tree_leaves(live)]
    fresh = fresh_init(sim, config, 2)
    paths = [p for p, _ in tree_paths(fresh)]
    for bad in (lambda x: x.reshape(-1)[:1], lambda x: x.to(torch.float64)):
        hit = iter([True])
        odd = tree_map(lambda x: bad(x) if next(hit, False) else x, fresh)
        assert not _write_into(live, odd), (config, paths[0])
    assert not _write_into(live, tree_leaves(fresh))
    for x, w in zip(tree_leaves(live), snap):
        assert torch.equal(x, w)
    assert _write_into(live, fresh)
    assert_same_leaves(fresh, live, config)
