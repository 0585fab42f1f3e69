"""The port's real mesh axes against the JAX package's forced-device meshes,
continued (``test_torch_mesh.py`` has the tori): systolic networks on
``GraphEngine``/``GridEngine``, the register engine, and the session's
host I/O on a nonzero-home shard.

One JAX subprocess (8 forced CPU devices, Auto axes) dumps the reference
trajectories; the port runs the same systems with every shard on the CPU.
The cases mirror ``tests/test_graph.py:245`` (any partition of a systolic
network over 4 granules), ``tests/test_distributed.py:30`` (the same
matmul on 2x2, 4x1 and 1x4 device grids) and ``:58`` (credit
back-pressure: capacity 4 under K = 32), ``tests/test_fastgrid.py:48``
(the register engine on a 2x2 mesh, K = 7 and 16) and
``tests/test_session.py:166`` (the chain reversed over a 4-granule mesh:
its ext-in port homes on granule 3, ext-out on granule 1).  Also, in the
port alone: a sharded session's save/load (the checkpoint holds the
global layout), monitors, ``stats()`` and ``probe`` against the one-shard
run.  Tolerance: bit-exact.
"""
import json

import numpy as np
import pytest

from repro_torch.convert import register_state_to_numpy
from repro_torch.core import Network
from repro_torch.core.distributed import GridEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.mesh import ShardedState
from repro_torch.hw.systolic import SystolicCell, make_cell_params, make_systolic_network

from test_torch_mesh import assert_same, check_trajectory, run_reference
from test_torch_network import TIncrement, chain
from test_torch_session_surface import io_script

REFERENCE = '''
from repro.core.distributed import GridEngine
from repro.core.fastgrid import RegisterGridEngine
from repro.hw.systolic import SystolicCell, make_cell_params, make_systolic_network

rng = np.random.RandomState(5)
M, K, N = 6, 5, 4
A = rng.randn(M, K).astype(np.float32)
B = rng.randn(K, N).astype(np.float32)
sys_done = lambda s: ((~s.block_states[0].is_south) | (s.block_states[0].y_idx >= M)).all()
for seed in (0, 1):
    part = np.random.RandomState(seed).randint(0, 4, size=K * N)
    net, _ = make_systolic_network(A, B)
    eng = net.build(engine="graph", mesh=mesh((4,), ("gx",)), K=3, partition=part,
                    session=False)
    traj(f"sysrand{seed}", eng, eng.place(eng.init(jax.random.key(0))), 2, sys_done)

rng = np.random.RandomState(3)
A8 = rng.randn(8, 8).astype(np.float32)
B8 = rng.randn(8, 8).astype(np.float32)
done8 = lambda s: ((~s.block_states[0].is_south) | (s.block_states[0].y_idx >= 8)).all()
for shape in ((2, 2), (4, 1), (1, 4)):
    eng = GridEngine(SystolicCell(m_stream=8), 8, 8, mesh(shape, ("gr", "gc")), K=5, capacity=8)
    traj(f"grid{shape[0]}{shape[1]}", eng,
         eng.place(eng.init(jax.random.key(0), make_cell_params(A8, B8))), 1, done8)
rng = np.random.RandomState(4)
A16 = rng.randn(16, 4).astype(np.float32)
B4 = rng.randn(4, 4).astype(np.float32)
eng = GridEngine(SystolicCell(m_stream=16), 4, 4, mesh((2, 2), ("gr", "gc")), K=32, capacity=4)
done16 = lambda s: ((~s.block_states[0].is_south) | (s.block_states[0].y_idx >= 16)).all()
traj("backpressure", eng, eng.place(eng.init(jax.random.key(0), make_cell_params(A16, B4))),
     2, done16)

rng = np.random.RandomState(1)
A12 = rng.randn(12, 8).astype(np.float32)
B88 = rng.randn(8, 8).astype(np.float32)
reg_done = lambda s: np.all(~s.cell["is_south"] | (s.cell["y_idx"] >= 12))
for Kr in (7, 16):
    eng = RegisterGridEngine(8, 8, mesh((2, 2), ("gr", "gc")), K=Kr, m_stream=12)
    traj(f"reg{Kr}", eng, eng.place(eng.init(A12, B88)), 3, reg_done)

sys.path.insert(0, TESTS)
from test_session import build_chain, io_script

part = {"b0": 3, "b1": 2, "b2": 2, "b3": 1}
for engine in ("graph", "fused"):
    sim = build_chain(4, capacity=2).build(engine=engine, mesh=mesh((4,), ("gx",)),
                                           partition=part, K=1)
    assert sim.engine._chan_owner[sim.engine.graph.ext_in["tx"]] == 3
    sim.reset(0)
    for i, got in enumerate(io_script(sim, n_steps=16)):
        out[f"io_{engine}/trace/{i}"] = np.asarray(got, np.float32).reshape(-1, 2)
    put(f"io_{engine}", "final", sim.state)
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, tmp_path_factory.mktemp("mesh_grid") / "ref.npz")


def _south_done(M):
    return lambda s: ((~s.block_states[0].is_south) | (s.block_states[0].y_idx >= M)).all()


def _cells_done(M):
    """``GridEngine``'s predicate: it sees the granule-local cell states."""
    return lambda c: ((~c.is_south) | (c.y_idx >= M)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_systolic_random_partitions_match_jax_mesh(ref, seed):
    rng = np.random.RandomState(5)
    M, K, N = 6, 5, 4
    A, B = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(np.float32)
    part = np.random.RandomState(seed).randint(0, 4, size=K * N)
    net, _ = make_systolic_network(A, B)
    eng = net.build(engine="graph", mesh={"gx": 4}, K=3, partition=part, device="cpu",
                    session=False)
    st = check_trajectory(ref[f"sysrand{seed}"], eng, _south_done(M), 2, seed)
    flat = eng.gather_group(st, 0)
    Y = np.stack([flat.y_buf[(K - 1) * N + c] for c in range(N)], axis=1)
    np.testing.assert_allclose(Y, A @ B, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_grid_partition_invariance_matches_jax_mesh(ref, shape):
    rng = np.random.RandomState(3)
    A, B = rng.randn(8, 8).astype(np.float32), rng.randn(8, 8).astype(np.float32)
    eng = GridEngine(SystolicCell(m_stream=8), 8, 8, {"gr": shape[0], "gc": shape[1]},
                     K=5, capacity=8, device="cpu")
    st = check_trajectory(ref[f"grid{shape[0]}{shape[1]}"], eng, _cells_done(8), 1, shape,
                          st=eng.init(0, make_cell_params(A, B)))
    np.testing.assert_allclose(eng.gather_cells(st).y_buf[7].T, A @ B, rtol=1e-5)


def test_credit_backpressure_across_shards_matches_jax_mesh(ref):
    rng = np.random.RandomState(4)
    A, B = rng.randn(16, 4).astype(np.float32), rng.randn(4, 4).astype(np.float32)
    eng = GridEngine(SystolicCell(m_stream=16), 4, 4, {"gr": 2, "gc": 2}, K=32,
                     capacity=4, device="cpu")
    st = check_trajectory(ref["backpressure"], eng, _cells_done(16), 2, "bp",
                          st=eng.init(0, make_cell_params(A, B)))
    cells = eng.gather_cells(st)
    assert (cells.y_idx[3] == 16).all()  # exactly M outputs, no loss or duplicate
    np.testing.assert_allclose(cells.y_buf[3].T, A @ B, rtol=1e-5)


@pytest.mark.parametrize("K", [7, 16])
def test_register_engine_mesh_matches_jax_mesh(ref, K):
    """One ``systolic_step`` a shard an epoch and the east/south/credit
    copies between the four shards; the edge shards get zeros."""
    rng = np.random.RandomState(1)
    A, B = rng.randn(12, 8).astype(np.float32), rng.randn(8, 8).astype(np.float32)
    eng = RegisterGridEngine(8, 8, K=K, m_stream=12, mesh={"gr": 2, "gc": 2}, device="cpu")
    st = eng.init(A, B)
    assert isinstance(st, ShardedState) and len(st.shards) == 4
    st = check_trajectory(ref[f"reg{K}"], eng, eng.y_done, 3, K, st=st,
                          to_numpy=register_state_to_numpy)
    np.testing.assert_allclose(eng.result(st), A @ B, rtol=1e-5)
    assert eng.group_state(st, 8 * 8 - 1)["y_idx"] == 12
    # a mid-run reference state crosses into the shards and continues
    from repro_torch.convert import register_state_from_numpy
    st = register_state_from_numpy(eng, ref[f"reg{K}"]["1"])
    assert isinstance(st, ShardedState)
    st = eng.run_epochs(st, 2)
    assert_same(ref[f"reg{K}"]["3"], register_state_to_numpy(st), (K, "carried"))


@pytest.mark.parametrize("engine", ["graph", "fused"])
def test_host_io_on_nonzero_home_shards_matches_jax_mesh(ref, engine):
    part = {"b0": 3, "b1": 2, "b2": 2, "b3": 1}
    sim = chain(Network, TIncrement(), 4, 2).build(
        engine=engine, mesh={"gx": 4}, partition=part, K=1, device="cpu")
    assert sim.engine._chan_owner[sim.engine.graph.ext_in["tx"]] == 3
    assert sim.engine._ext_at(sim.engine.graph.ext_in, "tx")[0] == 3
    assert sim.engine._ext_at(sim.engine.graph.ext_out, "rx")[0] == 1
    sim.reset(0)
    trace = io_script(sim, n_steps=16)
    want = ref[f"io_{engine}"]
    assert len(trace) == len(want["trace"])
    for i, got in enumerate(trace):
        np.testing.assert_array_equal(np.asarray(got, np.float32).reshape(-1, 2),
                                      want["trace"][str(i)], err_msg=str(i))
    from repro_torch.convert import fused_state_to_numpy
    assert_same(want["final"], fused_state_to_numpy(sim.state), "final")


@pytest.mark.parametrize("engine", ["graph", "fused"])
def test_sharded_session_surface(engine, tmp_path):
    """A session over four shards against the same granules batched on one:
    host traffic, monitor samples, ``stats()``, ``probe``; a checkpoint
    written mid-run holds the global layout, and a fresh sharded session
    loaded from it resumes to the uninterrupted run's state."""
    from repro_torch.convert import fused_state_to_numpy

    part = {"b0": 3, "b1": 2, "b2": 2, "b3": 1}

    def build(sharded):
        kw = {"mesh": {"gx": 4}} if sharded else {"batch_axes": {"gx": 4}}
        return chain(Network, TIncrement(), 4, 2).build(
            engine=engine, partition=part, K=1, device="cpu", **kw)

    def drain_all(sim):  # the capacity-2 rx queue back-pressures the chain
        got = []
        for _ in range(8):
            sim.run(cycles=6)
            got.extend(sim.rx("rx").drain())
        return np.asarray(got)

    runs = {}
    for sharded in (True, False):
        sim = build(sharded).reset(0)
        seen = []
        sim.add_monitor(lambda s: seen.append((s.cycle, s.stats()["ports"]["tx"]["tx"]["occupancy"])),
                        every=3)
        sim.tx("tx").send_many([[float(v), 0.0] for v in range(5)])
        sim.run(cycles=7)
        sent = sim.tx("tx").sent
        if sharded:
            sim.save(str(tmp_path / "ck"))
        runs[sharded] = (seen, drain_all(sim), sim.stats()["ports"],
                         [int(sim.probe(i).count) for i in range(4)],
                         fused_state_to_numpy(sim.state), sim.cycle)
    a, b = runs[True], runs[False]
    assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3] and a[5] == b[5]
    np.testing.assert_array_equal(a[1], b[1])
    assert len(a[1]) == 5 and a[3] == [5, 5, 5, 5]
    with open(next((tmp_path / "ck").glob("step_*")) / "tree.json") as f:
        paths = json.load(f)["paths"]
    assert "queues.buf" in paths and not any(p.startswith("shards") for p in paths)

    sim = build(True).reset(0)
    sim.load(str(tmp_path / "ck"))
    assert isinstance(sim.state, ShardedState) and sim.cycle == 7
    assert sim.tx("tx").sent == sent and sim.tx("tx").pending == 5 - sent
    np.testing.assert_array_equal(drain_all(sim), a[1])
    got = fused_state_to_numpy(sim.state)
    for k, w in a[4].items():
        assert np.array_equal(got[k], w), k
