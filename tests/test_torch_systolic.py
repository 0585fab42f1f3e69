"""The port's systolic path against ``repro``: the MAC, the plain
``systolic_step_ref``, ``SystolicCell`` on ``NetworkSim``, the
``RegisterGridEngine`` epoch by epoch (one tile, and 2x2 tiles against a
JAX 2x2 mesh), ``convert`` mid-run, and the session scenario.

Tolerance is bit-exact throughout (``np.array_equal``): the handshakes are
integer logic and the arithmetic is one fused multiply-add a MAC, which
XLA contracts ``p + a*b`` into and ``hw.systolic.mac`` computes.  The
Pallas kernel runs as the JAX package's own tests run it on the CPU
(interpret mode, under jit).  JAX reference meshes use Auto axes (ROADMAP
Queue 3, R1).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core.fastgrid import RegisterGridEngine as JEngine
from repro.core import NetworkSim as JSim
from repro.hw.systolic import make_systolic_network as j_network
from repro.kernels import ops as jops
from repro.kernels.ref import systolic_step_ref as j_ref
from repro_torch.convert import register_state_from_numpy, register_state_to_numpy
from repro_torch.core import Simulation
from repro_torch.core.fastgrid import RegisterGridEngine as TEngine
from repro_torch.hw.systolic import (
    collect_result, cycles_needed, make_systolic_network, mac, matmul_error_bound,
)
from repro_torch.kernels.systolic_step import (
    CELL_OUT, EDGE_OUT, systolic_step, systolic_step_ref,
)

from test_torch_graph import auto_mesh
from test_torch_network import assert_same

OUT_KEYS = CELL_OUT + EDGE_OUT


def _operands(seed, M, R, C):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32))


def _jax_state_dict(state) -> dict:
    """A JAX ``RegGridState`` as {dotted path: numpy} — the keys of
    ``repro_torch.convert.register_state_to_numpy``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]:
        out[".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path)] = (
            np.asarray(leaf))
    return out


def _assert_same(want: dict, got: dict, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (where, k)


def assert_within_bound(Y, A, B):
    """Y against the f64 product, within the rounding bound of the grid's
    in-order FMA sums (``hw.systolic.matmul_error_bound``)."""
    err = np.abs(np.asarray(Y, np.float64) - A.astype(np.float64) @ B.astype(np.float64))
    assert (err <= matmul_error_bound(A, B)).all(), err.max()


# ------------------------------------------------------------------ the MAC
def test_mac_is_the_references_fma():
    """``mac`` equals jitted JAX ``p + a*b`` bit for bit on 10^5 seeded
    triples; the two-rounding form (multiply, then add) does not."""
    rng = np.random.RandomState(5)
    p, a, b = (rng.randn(100_000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda p, a, b: p + a * b)(p, a, b))
    tp, ta, tb = (torch.from_numpy(x) for x in (p, a, b))
    assert np.array_equal(mac(tp, ta, tb).numpy(), want)
    assert (((tp + ta * tb).numpy()) != want).any()


# ---------------------------------------------------- the plain kernel version
def _tile_state(seed, M, R, C, K):
    A, B = _operands(seed, M, R, C)
    rr, cc = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    a_buf = np.zeros((R, C, M), np.float32)
    a_buf[:, 0, :] = A.T
    zf = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    zi = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    return dict(
        b=B, a_reg=zf(R, C), a_v=np.zeros((R, C), bool), p_reg=zf(R, C),
        p_v=np.zeros((R, C), bool), a_idx=zi(R, C), y_idx=zi(R, C),
        a_buf=a_buf, y_buf=zf(R, C, M), is_west=cc == 0, is_north=rr == 0,
        is_south=rr == R - 1, is_east=cc == C - 1,
        west_slab=zf(R, K), west_cnt=zi(R), north_slab=zf(C, K), north_cnt=zi(C),
    )


def _interior(state, R, C, K, cnt, limit=None):
    """An interior tile: no edge flags, fed only through its slabs."""
    z = np.zeros((R, C), bool)
    rng = np.random.RandomState(cnt)
    state.update(
        is_west=z, is_north=z, is_south=z, is_east=z,
        west_slab=rng.randn(R, K).astype(np.float32), west_cnt=np.full(R, cnt, np.int32),
        north_slab=rng.randn(C, K).astype(np.float32), north_cnt=np.full(C, cnt, np.int32),
    )
    if limit is not None:
        state.update(east_limit=np.full(R, limit, np.int32),
                     south_limit=np.full(C, limit, np.int32))
    return state


_KERNEL_CASES = {
    "4x3x3_k4": (4, 3, 3, 4, None),
    "6x4x5_k8": (6, 4, 5, 8, None),
    "8x2x2_k16": (8, 2, 2, 16, None),
    "slabs": (4, 2, 2, 8, (3, None)),
    "limits": (5, 3, 4, 8, (6, 2)),
}


@pytest.mark.parametrize("case", list(_KERNEL_CASES))
def test_plain_version_matches_pallas_kernel_and_ref(case):
    """``systolic_step_ref`` against the Pallas kernel (interpret mode) and
    against ``ref.systolic_step_ref``, every output key, call by call."""
    M, R, C, K, interior = _KERNEL_CASES[case]
    st = _tile_state(M * 100 + R * 10 + C, M, R, C, K)
    if interior is not None:
        st = _interior(st, R, C, K, *interior)
    kern = jax.jit(lambda s: jops.systolic_step(s, K))
    ref = jax.jit(lambda s: j_ref(s, K))
    fresh = dict(widx=np.zeros(R, np.int32), nidx=np.zeros(C, np.int32),
                 east_slab=np.zeros((R, K), np.float32), east_cnt=np.zeros(R, np.int32),
                 south_slab=np.zeros((C, K), np.float32), south_cnt=np.zeros(C, np.int32))
    for call in range(4 if interior else (M + R + C) // K + 3):
        t_out = systolic_step_ref({k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}, K)
        got = {k: t_out[k].numpy() for k in OUT_KEYS}
        want_k = {k: np.asarray(v) for k, v in kern(st).items() if k in OUT_KEYS}
        want_r = {k: np.asarray(v) for k, v in ref(dict(st, **fresh)).items() if k in OUT_KEYS}
        _assert_same(want_k, got, (case, call, "pallas"))
        _assert_same(want_r, got, (case, call, "ref"))
        st = dict(st, **{k: got[k] for k in CELL_OUT})
    if interior is None:
        A, B = _operands(M * 100 + R * 10 + C, M, R, C)
        assert (st["y_idx"][R - 1] == M).all()
        assert_within_bound(st["y_buf"][R - 1].T, A, B)
    else:
        assert got["east_cnt"].sum() > 0 and got["south_cnt"].sum() > 0


def test_systolic_step_dispatches_by_device():
    st = {k: torch.from_numpy(np.asarray(v)) for k, v in _tile_state(0, 3, 2, 2, 4).items()}
    out = systolic_step(st, 4)
    assert all(out[k].device.type == "cpu" for k in OUT_KEYS)
    assert st["a_idx"].sum() == 0  # the plain version leaves its input alone
    with pytest.raises(ValueError, match="no systolic_step for device"):
        systolic_step({k: v.to("meta") for k, v in st.items()}, 4)


# ----------------------------------------------------------- NetworkSim
def test_systolic_cell_netlist_cycle_by_cycle():
    """``SystolicCell`` on the port's ``NetworkSim`` against the JAX one on
    a 4x5 grid: every queue and block-state leaf after every cycle."""
    M, R, C = 5, 4, 5
    A, B = _operands(3, M, R, C)
    jnet, _ = j_network(A, B, capacity=4)
    tnet, grid = make_systolic_network(A, B, capacity=4)
    js = JSim(jnet.graph())
    ts = tnet.build(session=False, device="cpu")
    jst, tst = js.init(jax.random.key(0)), ts.init(0)
    step = jax.jit(js.step)
    assert_same(jst, tst, "init")
    for t in range(cycles_needed(M, R, C)):
        jst, tst = step(jst), ts.step(tst)
        assert_same(jst, tst, t)
    assert (tst.block_states[0].y_idx[-C:] == M).all()
    assert_within_bound(collect_result(ts, tst, grid), A, B)


# ------------------------------------------------- RegisterGridEngine
def _jax_trajectory(je, A, B, n_max):
    st = je.place(je.init(A, B))
    states = [_jax_state_dict(st)]
    for _ in range(n_max):
        st = je.run_epochs(st, 1, donate=False)
        states.append(_jax_state_dict(st))
        if bool(np.all(~states[-1]["cell.is_south"] | (states[-1]["cell.y_idx"] >= je.M))):
            break
    return states


@pytest.mark.parametrize("K", [2, 8, 16])
def test_register_engine_matches_jax_epoch_by_epoch(K):
    """One tile: every state leaf equal after every epoch to completion."""
    M, R, C = 10, 8, 8
    A, B = _operands(K, M, R, C)
    je = JEngine(R, C, auto_mesh((1, 1), ("gr", "gc")), K=K, m_stream=M)
    want = _jax_trajectory(je, A, B, 200)
    te = TEngine(R, C, K=K, m_stream=M, device="cpu")
    st = te.init(A, B)
    _assert_same(want[0], register_state_to_numpy(st), "init")
    for ep, w in enumerate(want[1:]):
        st = te.run_epochs(st, 1)
        _assert_same(w, register_state_to_numpy(st), (K, ep))
    assert te.tiles_done(st.cell, te.y_done)
    assert np.array_equal(te.result(st), want[-1]["cell.y_buf"][0, 0, R - 1].T)
    assert_within_bound(te.result(st), A, B)


def test_register_tiles_match_jax_mesh(tmp_path):
    """``tiles=(2, 2)`` against a JAX (2, 2) mesh on 4 fake devices (in a
    subprocess, which writes its per-epoch states to an .npz): every leaf
    after every epoch, for two epoch lengths."""
    M, R, C = 12, 8, 8
    out = tmp_path / "traj.npz"
    code = textwrap.dedent(f"""
        import numpy as np, jax
        from jax.sharding import AxisType
        from repro.core.fastgrid import RegisterGridEngine
        M, R, C = {M}, {R}, {C}
        rng = np.random.RandomState(1)
        A = rng.randn(M, R).astype(np.float32)
        B = rng.randn(R, C).astype(np.float32)
        mesh = jax.make_mesh((2, 2), ('gr', 'gc'), axis_types=(AxisType.Auto,) * 2)
        arrays = {{}}
        for K in (2, 7):
            eng = RegisterGridEngine(R, C, mesh, K=K, m_stream=M)
            st = eng.place(eng.init(A, B))
            for ep in range(100):
                st = eng.run_epochs(st, 1, donate=False)
                for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(st))[0]:
                    key = '.'.join(str(getattr(k, 'name', getattr(k, 'key', k))) for k in path)
                    arrays[f'{{K}}/{{ep}}/{{key}}'] = np.asarray(leaf)
                c = jax.device_get(st.cell)
                if np.all(~c['is_south'] | (c['y_idx'] >= M)):
                    break
        np.savez({str(out)!r}, **arrays)
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    traj = np.load(out)
    rng = np.random.RandomState(1)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    for K in (2, 7):
        te = TEngine(R, C, K=K, m_stream=M, tiles=(2, 2), device="cpu")
        st = te.init(A, B)
        ep = 0
        while f"{K}/{ep}/cycle" in traj:
            st = te.run_epochs(st, 1)
            got = register_state_to_numpy(st)
            want = {k.split("/", 2)[2]: traj[k] for k in traj.files
                    if k.startswith(f"{K}/{ep}/")}
            _assert_same(want, got, (K, ep))
            ep += 1
        assert ep > 3 and te.tiles_done(st.cell, te.y_done)
        assert_within_bound(te.result(st), A, B)


def test_convert_carries_a_mid_run_state():
    """The port starts from a JAX mid-run state, continues, and reaches the
    JAX end state (2x2 tiles on one JAX device: the tile layout is the
    state's, not the mesh's)."""
    M, R, C, K = 9, 6, 6, 4
    A, B = _operands(7, M, R, C)
    je = JEngine(R, C, auto_mesh((1, 1), ("gr", "gc")), K=K, m_stream=M)
    traj = _jax_trajectory(je, A, B, 200)
    te = TEngine(R, C, K=K, m_stream=M, device="cpu")
    mid = len(traj) // 2
    st = register_state_from_numpy(te, traj[mid])
    _assert_same(traj[mid], register_state_to_numpy(st), "carried")
    st = te.run_epochs(st, len(traj) - 1 - mid)
    _assert_same(traj[-1], register_state_to_numpy(st), "end")
    with pytest.raises(KeyError, match="missing"):
        register_state_from_numpy(te, {k: v for k, v in traj[mid].items() if k != "cycle"})


# --------------------------------------------------------------- sessions
def test_session_scenario_matches_jax_and_the_other_engines():
    """The JAX session scenario of ``tests/test_session.py`` (reset,
    run(cycles=12), probe, run(until), result) on the port's register
    engine equals the JAX register and single sessions, and the port's
    own single and fused engines."""
    from repro.core.compat import make_mesh

    M, R, C = 6, 4, 4
    A, B = _operands(3, M, R, C)
    j_done = {
        "single": lambda s: ((~s.block_states[0].is_south)
                             | (s.block_states[0].y_idx >= M)).all(),
        "register": lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all(),
    }
    want = {}
    for kind in ("single", "register"):
        net, _ = j_network(A, B)
        jsim = (net.build() if kind == "single" else
                net.build(engine="register", mesh=make_mesh((1, 1), ("gr", "gc")), K=4))
        jsim.reset(0)
        jsim.run(cycles=12)
        mid = jsim.probe(0)
        jsim.run(until=j_done[kind], max_epochs=100_000, cache_key="done")
        want[kind] = (int(np.asarray(mid["a_idx"] if kind == "register" else mid.a_idx)),
                      jsim.cycle, np.asarray(
                          jsim.engine.result(jsim.state) if kind == "register" else
                          np.stack([np.asarray(jsim.probe((R - 1) * C + c).y_buf)
                                    for c in range(C)], 1)))
    assert np.array_equal(want["single"][2], want["register"][2])

    got = {}
    for kind in ("single", "fused", "register"):
        net, _ = make_systolic_network(A, B)
        kw = {} if kind == "single" else {"K": 4}
        sim = net.build(engine=kind, device="cpu", **kw)
        assert isinstance(sim, Simulation) and sim.kind == kind
        sim.reset(0)
        sim.run(cycles=12)
        mid = sim.probe(0)
        a_idx = int(mid["a_idx"] if kind == "register" else mid.a_idx)
        assert a_idx > 0  # the stream has started
        if kind == "register":
            sim.run(until=lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all())
            Y = sim.engine.result(sim.state)
            assert sim.stats()["engine"] == "register"
            with pytest.raises(KeyError, match="no external-in"):
                sim.tx("x")
        else:
            sim.run(until=lambda s: ((~s.block_states[0].is_south)
                                     | (s.block_states[0].y_idx >= M)).all())
            Y = np.stack([sim.probe((R - 1) * C + c).y_buf.numpy() for c in range(C)], 1)
        got[kind] = (a_idx, sim.cycle, Y)
    for kind in ("single", "register"):
        assert got[kind][:2] == want[kind][:2], kind
        assert np.array_equal(got[kind][2], want[kind][2]), kind
    assert np.array_equal(got["fused"][2], want["single"][2])
    assert_within_bound(got["register"][2], A, B)
    # an already-done register session runs zero more epochs
    cyc = sim.cycle
    sim.run(until=lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all())
    assert sim.cycle == cyc


def test_register_build_with_tiles_and_rejections():
    M, R, C = 4, 4, 6
    A, B = _operands(0, M, R, C)
    net, _ = make_systolic_network(A, B)
    sim = net.build(engine="register", device="cpu", K=3, tiles=(2, 3))
    assert (sim.engine.Dr, sim.engine.Dc, sim.engine.Tr, sim.engine.Tc) == (2, 3, 2, 2)
    sim.reset()
    sim.run(until=sim.engine.y_done)
    ref = net.build(engine="register", device="cpu", K=3, session=False)
    done = ref.run_until_done(ref.init(), max_epochs=1000)
    assert np.array_equal(sim.engine.result(sim.state), ref.result(done))
    with pytest.raises(ValueError, match="not divisible"):
        net.build(engine="register", device="cpu", K=3, tiles=(3, 3))
    # a real mesh axis (which raised before the mesh was ported) runs as
    # two shards, and gives the one-tile run's Y and state in the global
    # layout (the one-tile state stacked as the mesh's two tiles)
    mesh = net.build(engine="register", device="cpu", K=3, mesh={"gr": 2})
    assert len(mesh.engine.shardings()) == 2
    mesh.reset()
    mesh.run(until=mesh.engine.y_done)
    assert np.array_equal(mesh.engine.result(mesh.state), ref.result(done))
    stacked = net.build(engine="register", device="cpu", K=3, tiles=(2, 1))
    stacked.reset()
    stacked.run(until=stacked.engine.y_done)
    assert mesh.cycle == stacked.cycle
    got, want = register_state_to_numpy(mesh.state), register_state_to_numpy(stacked.state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="not both"):
        net.build(engine="register", device="cpu", K=3, mesh={"gr": 2}, tiles=(1, 2))
    with pytest.raises(TypeError):
        net.build(engine="register", device="cpu", K=3, partition=[0])
