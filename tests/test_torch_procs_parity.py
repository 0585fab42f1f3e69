"""The procs fleet's schedule options against the in-process engine and the
JAX package's fleet, on the CPU:

  * ``batch_signatures`` and ``overlap`` (each alone and both): after each
    of three epochs every granule's queues and blocks equal the plain
    fleet's and the port's ``GraphEngine``'s on the same ``PartitionTree``
    (the same lowering, so the same per-granule layout), and
    ``run(until=allreduce_done)`` stops at the same cycle with the same
    blocks;
  * one fleet against the JAX ``ProcsEngine``: a 3-worker chain after the
    same host script has the same ``gather_state`` — the same leaves in
    the same order, with the same shapes, dtypes and values (the JAX tree
    flattened by key path, the port's by ``tree_paths``) — and the same Rx
    traffic.  A JAX fleet costs seconds to start, so this is one test.

Tolerance: bit-exact.
"""
import jax
import numpy as np
import pytest

from repro.hw.pipestage import make_chain as j_chain
from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.graph import PartitionTree, Tier
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params
from repro_torch.hw.pipestage import make_chain
from repro_torch.runtime import ProcsEngine

from test_torch_session_surface import io_script

R = C = 8


def wafer_tree():
    """8x8 torus on 2 pods x 2 granules (row strips), tiers pod K=2 and
    g K=4, capacity 4: the reference example's procs layout, shrunk."""
    vals = ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C,
                               params=make_core_params(vals), capacity=4)
    ptree = PartitionTree(tiered_grid_partition(R, C, [(2, 1), (2, 1)]),
                          (Tier(axes=("pod",), K=2), Tier(axes=("g",), K=4)),
                          {"pod": 2, "g": 2})
    return graph, ptree


def done(s):
    return allreduce_done(s.block_states[0], s.tables.active[0])


def graph_granules(eng, state) -> list:
    """Every granule's (queues, blocks) from a GraphEngine state, numpy."""
    local = eng._local_view(state)  # every granule on one (G,) batch axis
    return [{p: x[g].numpy() for p, x in tree_paths(
        {"queues": local.queues, "block_states": local.block_states})}
        for g in range(eng.G)]


def fleet_granules(eng, state) -> list:
    tree = eng.gather_state(state)["workers"]
    return [{p: np.asarray(x) for p, x in tree_paths(
        {"queues": tree[f"g{g}"].queues, "block_states": tree[f"g{g}"].block_states})}
        for g in range(eng.G)]


def assert_granules(want: list, got: list, where):
    assert len(want) == len(got)
    for g, (a, b) in enumerate(zip(want, got)):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (where, g, k)


@pytest.mark.parametrize("batch,overlap", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_fleet_options_match_graph_engine(batch, overlap):
    graph, ptree = wafer_tree()
    ref = GraphEngine(graph, ptree, batch_axes={"pod": 2, "g": 2}, overlap=overlap,
                      device="cpu")
    eng = ProcsEngine(graph, ptree, batch_signatures=batch, overlap=overlap,
                      timeout=60.0, device="cpu")
    try:
        if batch:  # strips 0/2 and 1/3 share a shape: two workers of two
            assert eng.NW == 2 and eng.build_stats["n_signatures"] == 2
            assert eng._worker_members == [(0, 2), (1, 3)]
        rst = ref.init(0)
        st = eng.init(0)
        assert_granules(graph_granules(ref, rst), fleet_granules(eng, st), "init")
        for e in range(3):
            rst = ref.run_epochs(rst, 1)
            st = eng.run_epochs(st, 1)
            assert_granules(graph_granules(ref, rst), fleet_granules(eng, st), e)
        rsim, sim = Simulation(ref), Simulation(eng)
        rsim._state, sim._state = rst, st
        rsim.run(until=done, max_epochs=500)
        sim.run(until=done, max_epochs=500)
        assert sim.cycle == rsim.cycle and sim.epoch == rsim.epoch > 3
        got = eng.gather_group(sim.state, 0)
        want = ref.gather_group(rsim.state, 0)
        for (p, a), (_, b) in zip(tree_paths(want), tree_paths(got)):
            assert np.array_equal(a, b), p
        assert np.all(got.total == float(((np.arange(R * C) % 8) + 1).sum()))
    finally:
        eng.close()


def _jax_leaves(tree) -> list:
    """(dotted path, numpy leaf) of a JAX tree in flatten order."""
    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(name(k) for k in path), np.asarray(x)) for path, x in flat]


def test_gather_state_matches_jax_procs():
    """The JAX fleet and the port's, the same 3-worker chain (K = 2,
    capacity 4) and host script: Rx traffic equal, and ``gather_state``
    equal leaf for leaf in flatten order (paths, shapes, dtypes, values:
    block states, queues, counters, tables, resting credits, external
    rings with their seq counters)."""
    from repro.runtime.launcher import ProcsEngine as JProcs

    jsim = j_chain(3, capacity=4).build(engine="procs", n_workers=3,
                                        partition=[0, 1, 2], K=2, timeout=60.0)
    tsim = make_chain(3, capacity=4).build(engine="procs", n_workers=3,
                                           partition=[0, 1, 2], K=2, timeout=60.0,
                                           device="cpu")
    assert isinstance(jsim.engine, JProcs)
    try:
        traffic = {}
        for tag, sim in (("jax", jsim), ("port", tsim)):
            sim.reset(0)
            traffic[tag] = io_script(sim, n_steps=6)
            sim.tx("tx").send_many([[7.0, 1.0], [8.0, 2.0]])  # left resident
        for a, b in zip(traffic["jax"], traffic["port"]):
            np.testing.assert_array_equal(a, b)
        want = _jax_leaves(jsim.engine.gather_state(jsim.state))
        got = [(p, np.asarray(x)) for p, x in
               tree_paths(tsim.engine.gather_state(tsim.state))]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(want, got):
            assert a.shape == b.shape and a.dtype == b.dtype, (p, a.shape, b.shape,
                                                               a.dtype, b.dtype)
            assert np.array_equal(a, b), p
        assert any(p.startswith("ext.tx") for p, _ in got)
    finally:
        jsim.engine.close()
        tsim.engine.close()
