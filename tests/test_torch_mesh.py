"""The port's real mesh axes (one controller, one state a shard, every
shard on the CPU here) against the JAX package's forced-device meshes:
``FusedEngine`` and ``GraphEngine`` on tori of ``ManycoreCell``s.

One JAX subprocess with 8 forced CPU devices and Auto axes (ROADMAP Queue
3, R1) builds the reference engines, placed on their meshes, and dumps
their states epoch by epoch (tables excluded, the global layout) and at
the first epoch at which the allreduce is done; the port runs the same
systems in-process.  The cases mirror the reference's own multi-device
tests:

  * random hierarchical partitions on a 2x2 ``(pod, gx)`` mesh, fused and
    queue engines (``tests/test_fused.py:236``);
  * K = (1, 1) at capacity 2 across that split (``:285``), also against
    the port's single netlist cycle by cycle;
  * the wafer allreduce on two tiers (``:321``) and on the example's
    all-real ``(pod, gr, gc) = (2, 2, 2)`` mesh (``examples/wafer_scale.py``);
  * overlap on against the port with overlap on and off
    (``tests/test_overlap.py:144``), unbatched and with the pods real and
    the ``gx`` axis batched (``tests/test_batched.py:102``);
  * the exchange tables themselves (classes with their ``real_perm``,
    ``send_idx``, ``bat_fwd``, every ``tables()`` leaf), and
    ``route_shift_groups`` (``tests/test_tiered.py:187``).

Tolerance: bit-exact (``np.array_equal`` on every f32 and int32 leaf).
``test_torch_mesh_grid.py`` holds the systolic, register and session
cases with a subprocess of its own.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import ChannelGraph as JGraph
from repro.core import grid_partition as j_grid_partition
from repro.core.distributed import merge_compatible_classes as j_merge
from repro.core.distributed import route_shift_groups as j_shift_groups
from repro.hw.manycore import ManycoreCell as JCell
from repro.hw.manycore import make_core_params as j_params
from repro_torch.convert import fused_state_to_numpy
from repro_torch.core import ChannelGraph, NetworkSim, tiered_grid_partition
from repro_torch.core.distributed import GraphEngine, route_shift_groups
from repro_torch.core.fused import FusedEngine
from repro_torch.core.mesh import ShardedState
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

#: shared by the reference scripts: an Auto-axes mesh over the first
#: devices, leaf keys by dotted path, and a trajectory dump
PRELUDE = '''
import json, sys
import numpy as np
import jax
from jax.sharding import AxisType

OUT, TESTS = sys.argv[1], sys.argv[2]
out = {}


def mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(names))


def flat(tree):
    key = lambda p: ".".join(str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
                             for k in p)
    return {key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def put(case, ep, state):
    st = jax.device_get(state)
    if hasattr(st, "tables"):
        st = st.replace(tables=None)
    for k, v in flat(st).items():
        out[f"{case}/{ep}/{k}"] = v


def tables(case, eng):
    out[f"{case}/classes"] = np.array(json.dumps([
        [[list(p) for p in cl.perm], cl.cmax, cl.tier, cl.col0,
         None if cl.real_perm is None else [list(p) for p in cl.real_perm]]
        for cl in eng.classes]))
    for name in ("_send_idx", "_send_mask", "_recv_idx", "_recv_mask",
                 "_bat_fwd", "_bat_rev"):
        for t, a in enumerate(getattr(eng, name)):
            out[f"{case}/{name}.{t}"] = np.asarray(a)
    for k, v in flat(eng.tables()).items():
        out[f"{case}/tables/{k}"] = v


def traj(case, eng, st, n_epochs, done):
    """States at epochs 0..n_epochs, and the first epoch at which ``done``
    (read on the global state) holds, with its state."""
    put(case, 0, st)
    ep, done_at = 0, -1
    while ep < 5000:
        if done_at < 0 and bool(done(jax.device_get(st))):
            done_at = ep
            put(case, "final", st)
        if ep >= n_epochs and done_at >= 0:
            break
        st = eng.run_epochs(st, 1, donate=False)
        ep += 1
        if ep <= n_epochs:
            put(case, ep, st)
    out[f"{case}/done_at"] = np.array(done_at)
'''

REFERENCE = '''
from repro.core import ChannelGraph, FusedEngine, tiered_grid_partition
from repro.core.distributed import GraphEngine
from repro.hw.manycore import ManycoreCell, allreduce_done, make_core_params


def torus(R, C, vals, cap):
    return ChannelGraph.torus(ManycoreCell(R, C), R, C,
                              params=make_core_params(vals), capacity=cap)


ar_done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])
m22 = mesh((2, 2), ("pod", "gx"))

R, C = 4, 6
vals = np.random.RandomState(11).randint(1, 30, size=(R, C)).astype(np.float32)
for seed, (ko, ki) in ((0, (1, 1)), (1, (2, 3))):
    part = np.random.RandomState(seed).randint(0, 4, size=R * C)
    eng = FusedEngine(torus(R, C, vals, 4), part, m22,
                      tiers=[(("pod",), ko), (("gx",), ki)])
    traj(f"frand{seed}", eng, eng.place(eng.init(jax.random.key(0))), 3, ar_done)
    if seed == 0:
        tables("frand0", eng)
eng = GraphEngine(torus(R, C, vals, 4), np.random.RandomState(1).randint(0, 4, size=R * C),
                  m22, tiers=[(("pod",), 2), (("gx",), 3)])
traj("grand1", eng, eng.place(eng.init(jax.random.key(0))), 3, ar_done)

vals44 = np.random.RandomState(5).randint(1, 20, size=(4, 4)).astype(np.float32)
eng = FusedEngine(torus(4, 4, vals44, 2), np.random.RandomState(0).randint(0, 4, size=16),
                  m22, tiers=[(("pod",), 1), (("gx",), 1)])
traj("k11", eng, eng.place(eng.init(jax.random.key(0))), 30, lambda s: True)

N = 16
wvals = (np.arange(N * N) % 23 + 1).astype(np.float32).reshape(N, N)
eng = FusedEngine(torus(N, N, wvals, 8), tiered_grid_partition(N, N, [(2, 1), (1, 2)]),
                  m22, tiers=[(("pod",), 4), (("gx",), 8)])
traj("wafer", eng, eng.place(eng.init(jax.random.key(0))), 1, ar_done)
eng = FusedEngine(torus(N, N, wvals, 8), tiered_grid_partition(N, N, [(2, 1), (2, 2)]),
                  mesh((2, 2, 2), ("pod", "gr", "gc")),
                  tiers=[(("pod",), 2), (("gr", "gc"), 4)])
traj("mesh8", eng, eng.place(eng.init(jax.random.key(0))), 1, ar_done)
tables("mesh8", eng)

vals7 = np.random.RandomState(7).randint(1, 30, size=(R, C)).astype(np.float32)
part = np.random.RandomState(2).randint(0, 4, size=R * C)
for name, cls, m, kw in (("ovl_f", FusedEngine, m22, {}),
                         ("ovl_g", GraphEngine, m22, {}),
                         ("mix_f", FusedEngine, mesh((2,), ("pod",)), {"batch_axes": {"gx": 2}}),
                         ("mix_g", GraphEngine, mesh((2,), ("pod",)), {"batch_axes": {"gx": 2}})):
    eng = cls(torus(R, C, vals7, 4), part, m, tiers=[(("pod",), 2), (("gx",), 4)],
              overlap=True, **kw)
    traj(name, eng, eng.place(eng.init(jax.random.key(0))), 3, ar_done)
    if name.startswith("mix"):
        tables(name, eng)
np.savez(OUT, **out)
'''


def run_reference(body: str, out_path) -> dict:
    """Run ``PRELUDE + body`` in a JAX subprocess with 8 forced CPU
    devices; returns its dump as {case: {epoch or name: value}}, an
    epoch's value being {leaf path: array}."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(PRELUDE + body), str(out_path), HERE],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref: dict = {}
    with np.load(out_path) as data:
        for name in data.files:
            case, rest = name.split("/", 1)
            if "/" in rest:
                ep, key = rest.split("/", 1)
                ref.setdefault(case, {}).setdefault(ep, {})[key] = data[name]
            else:
                ref.setdefault(case, {})[rest] = data[name]
    return ref


def assert_same(want: dict, got: dict, where):
    assert sorted(got) == sorted(want), (where, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (where, k, got[k].dtype, w.dtype)
        assert np.array_equal(got[k], w), (where, k)


def check_trajectory(ref_case: dict, eng, done, n_epochs: int, where, st=None,
                     to_numpy=fused_state_to_numpy):
    """The port ``eng`` from ``st`` (``eng.init(0)`` by default): every leaf
    after epochs 0..n_epochs, then ``run_until(done)`` stops at the
    reference's first done epoch with its state."""
    st = eng.init(0) if st is None else st
    assert_same(ref_case["0"], to_numpy(st), (where, 0))
    for ep in range(1, n_epochs + 1):
        st = eng.run_epochs(st, 1)
        assert_same(ref_case[str(ep)], to_numpy(st), (where, ep))
    done_at = int(ref_case["done_at"])
    assert done_at >= n_epochs, where
    st = eng.run_until(st, done, 5000)
    assert int(st.epoch.reshape(-1)[0]) == done_at, where
    assert_same(ref_case["final"], to_numpy(st), (where, "final"))
    return st


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, tmp_path_factory.mktemp("mesh") / "ref.npz")


def torus(R, C, vals, cap):
    return ChannelGraph.torus(ManycoreCell(R, C), R, C,
                              params=make_core_params(vals), capacity=cap)


def ar_done(s):
    return allreduce_done(s.block_states[0], s.tables.active[0])


M22 = {"pod": 2, "gx": 2}
R, C = 4, 6


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("seed,k", [(0, (1, 1)), (1, (2, 3))])
def test_fused_random_partitions_match_jax_mesh(ref, seed, k):
    vals = np.random.RandomState(11).randint(1, 30, size=(R, C)).astype(np.float32)
    part = np.random.RandomState(seed).randint(0, 4, size=R * C)
    eng = FusedEngine(torus(R, C, vals, 4), part, M22,
                      tiers=[(("pod",), k[0]), (("gx",), k[1])], device="cpu")
    assert eng.shardings() == (eng.device,) * 4 and eng._resident_from == 2
    st = check_trajectory(ref[f"frand{seed}"], eng, ar_done, 3, seed)
    assert isinstance(st, ShardedState) and len(st.shards) == 4
    assert (eng.gather_group(st, 0).total == vals.sum()).all()


def test_graph_random_partition_matches_jax_mesh(ref):
    vals = np.random.RandomState(11).randint(1, 30, size=(R, C)).astype(np.float32)
    part = np.random.RandomState(1).randint(0, 4, size=R * C)
    eng = GraphEngine(torus(R, C, vals, 4), part, M22,
                      tiers=[(("pod",), 2), (("gx",), 3)], device="cpu")
    st = check_trajectory(ref["grand1"], eng, ar_done, 3, "graph")
    assert (eng.gather_group(st, 0).total == vals.sum()).all()


def test_k11_capacity2_cycle_accurate_across_shards(ref):
    """K = (1, 1) at capacity 2 over four shards: every leaf equals the JAX
    mesh engine's for 30 one-cycle epochs, and every core's ``acc`` the
    port's single netlist's, cycle by cycle."""
    vals = np.random.RandomState(5).randint(1, 20, size=(4, 4)).astype(np.float32)
    part = np.random.RandomState(0).randint(0, 4, size=16)
    eng = FusedEngine(torus(4, 4, vals, 2), part, M22,
                      tiers=[(("pod",), 1), (("gx",), 1)], device="cpu")
    sim = NetworkSim(torus(4, 4, vals, 2), device="cpu")
    fs, ss = eng.init(0), sim.init(0)
    for ep in range(1, 31):
        fs, ss = eng.run_epochs(fs, 1), sim.step(ss)
        assert_same(ref["k11"][str(ep)], fused_state_to_numpy(fs), ep)
        assert np.array_equal(eng.gather_group(fs, 0).acc,
                              ss.block_states[0].acc.numpy()), ep


@pytest.mark.parametrize("case", ["wafer", "mesh8"])
def test_wafer_allreduce_matches_jax_mesh(ref, case):
    N = 16
    vals = (np.arange(N * N) % 23 + 1).astype(np.float32).reshape(N, N)
    if case == "wafer":
        eng = FusedEngine(torus(N, N, vals, 8), tiered_grid_partition(N, N, [(2, 1), (1, 2)]),
                          M22, tiers=[(("pod",), 4), (("gx",), 8)], device="cpu")
    else:  # the example's mesh: every axis real, one granule a shard
        eng = FusedEngine(torus(N, N, vals, 8), tiered_grid_partition(N, N, [(2, 1), (2, 2)]),
                          {"pod": 2, "gr": 2, "gc": 2},
                          tiers=[(("pod",), 2), (("gr", "gc"), 4)], device="cpu")
        assert len(eng.shardings()) == 8
    st = check_trajectory(ref[case], eng, ar_done, 1, case)
    assert (eng.gather_group(st, 0).total == vals.sum()).all()


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("case", ["ovl_f", "ovl_g", "mix_f", "mix_g"])
def test_overlap_and_mixed_axes_match_jax_mesh(ref, case, overlap):
    """The JAX engines run overlapped; the port runs both schedules, which
    give the same bits by construction.  ``mix_*``: the pods real (two
    shards), the ``gx`` granules batched on each."""
    vals = np.random.RandomState(7).randint(1, 30, size=(R, C)).astype(np.float32)
    part = np.random.RandomState(2).randint(0, 4, size=R * C)
    cls = FusedEngine if case.endswith("f") else GraphEngine
    kw = ({"mesh": M22} if case.startswith("ovl")
          else {"mesh": {"pod": 2}, "batch_axes": {"gx": 2}})
    eng = cls(torus(R, C, vals, 4), part, tiers=[(("pod",), 2), (("gx",), 4)],
              overlap=overlap, device="cpu", **kw)
    if case == "mix_f":  # the inner tier stays on a shard: it runs resident
        assert eng._resident_from == 1
        assert all(cl.real_perm == () for cl in eng.tier_classes[1])
        assert all(cl.real_perm for cl in eng.tier_classes[0])
    check_trajectory(ref[case], eng, ar_done, 3, (case, overlap))


@pytest.mark.parametrize("case", ["frand0", "mesh8", "mix_f", "mix_g"])
def test_tables_match_jax_mesh(ref, case):
    """Classes (perm, cmax, tier, col0, real_perm), the slot and credit
    windows, the batch-row gathers and every ``tables()`` leaf equal the
    reference engine's, built with no run."""
    if case == "mesh8":
        N = 16
        vals = (np.arange(N * N) % 23 + 1).astype(np.float32).reshape(N, N)
        eng = FusedEngine(torus(N, N, vals, 8), tiered_grid_partition(N, N, [(2, 1), (2, 2)]),
                          {"pod": 2, "gr": 2, "gc": 2},
                          tiers=[(("pod",), 2), (("gr", "gc"), 4)], device="cpu")
    else:
        seed, vseed = (0, 11) if case == "frand0" else (2, 7)
        vals = np.random.RandomState(vseed).randint(1, 30, size=(R, C)).astype(np.float32)
        part = np.random.RandomState(seed).randint(0, 4, size=R * C)
        tiers = [(("pod",), 1), (("gx",), 1)] if case == "frand0" else [(("pod",), 2), (("gx",), 4)]
        cls = GraphEngine if case == "mix_g" else FusedEngine
        kw = ({"mesh": M22} if case == "frand0"
              else {"mesh": {"pod": 2}, "batch_axes": {"gx": 2}})
        eng = cls(torus(R, C, vals, 4), part, tiers=tiers, device="cpu", **kw)
    want = ref[case]
    got_classes = [[[list(p) for p in cl.perm], cl.cmax, cl.tier, cl.col0,
                    None if cl.real_perm is None else [list(p) for p in cl.real_perm]]
                   for cl in eng.classes]
    assert got_classes == json.loads(str(want["classes"]))
    for name in ("_send_idx", "_send_mask", "_recv_idx", "_recv_mask", "_bat_fwd", "_bat_rev"):
        got = getattr(eng, name)
        assert len(got) == sum(k.startswith(name + ".") for k in want), name
        for t, a in enumerate(got):
            assert np.array_equal(a, want[f"{name}.{t}"]), (name, t)
    tables = {p: x.numpy() for p, x in tree_paths(eng.tables())}
    assert_same(want["tables"], tables, "tables")


def test_route_shift_groups_torus_collapses_to_four_shifts():
    """As the reference's test: block-tiling an 8x8 torus onto a 2x2
    granule mesh gives the four shifts east, east-wrap, south, south-wrap,
    each a partial permutation, and the groups equal the reference's."""
    jg = JGraph.torus(JCell(8, 8), 8, 8, params=j_params(np.ones((8, 8), np.float32)))
    part = j_grid_partition(8, 8, 2, 2)
    src, dst = jg.channel_granules(part)
    boundary = (src >= 0) & (dst >= 0) & (src != dst)
    pairs = sorted({(int(s), int(d)) for s, d in zip(src[boundary], dst[boundary])})
    groups = route_shift_groups(pairs, (2, 2))
    assert groups == j_shift_groups(pairs, (2, 2))
    assert set(groups) == {(0, 1), (0, -1), (1, 0), (-1, 0)}
    for routes in groups.values():
        assert len({s for s, _ in routes}) == len(routes) == len({d for _, d in routes})
    assert len(j_merge([groups[k] for k in sorted(groups)])) == 2
    # the port's engine on that mesh needs no more classes than shifts
    g = ChannelGraph.torus(ManycoreCell(8, 8), 8, 8,
                           params=make_core_params(np.ones((8, 8), np.float32)))
    eng = GraphEngine(g, part, {"gr": 2, "gc": 2}, axes=("gr", "gc"), device="cpu")
    assert len(eng.tier_classes[0]) <= len(groups)
    assert all(cl.real_perm is None for cl in eng.tier_classes[0])


def test_device_sequence_places_one_shard_a_device():
    """``device`` takes one device for every shard or a sequence of one a
    shard (row-major over the real axes); a sequence of the wrong length
    raises, and ``cuda`` without a card raises rather than moving to the
    CPU.  A placed state gathers back to the global layout exactly."""
    from repro_torch.core.device import resolve_device
    from repro_torch.core.mesh import unshard

    vals = (np.arange(16) % 5 + 1).astype(np.float32).reshape(4, 4)
    part = np.arange(16) % 4
    eng = FusedEngine(torus(4, 4, vals, 4), part, M22, device=["cpu"] * 4)
    assert eng.shardings() == (eng.device,) * 4 and eng.G_real == 4
    one = FusedEngine(torus(4, 4, vals, 4), part, M22, device="cpu")
    a, b = eng.run_epochs(eng.init(0), 3), one.run_epochs(one.init(0), 3)
    assert_same(fused_state_to_numpy(a), fused_state_to_numpy(b), "sequence")
    assert_same(fused_state_to_numpy(eng.place(unshard(a))), fused_state_to_numpy(a), "place")
    with pytest.raises(ValueError, match="3 devices given for 4 shards"):
        FusedEngine(torus(4, 4, vals, 4), part, M22, device=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(["cpu", "cuda"])
    # the device loop holds one card's work: shards on two cards are refused
    from repro_torch.core.mesh import require_one_card
    require_one_card([torch.device("cuda", 0)] * 2 + [torch.device("cpu")])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        require_one_card([torch.device("cuda", 0), torch.device("cuda", 1)])


@pytest.mark.parametrize("engine", ["graph", "fused", "register"])
def test_one_shard_engine_takes_a_one_device_sequence(engine):
    """An engine with no real axis larger than 1 has one shard, so a
    sequence of one device is a valid ``device``: it runs as the same
    engine given that device alone."""
    from repro_torch.convert import graph_state_to_numpy, register_state_to_numpy
    from repro_torch.hw.systolic import make_systolic_network

    if engine == "register":
        rng = np.random.default_rng(0)
        net, _ = make_systolic_network(rng.standard_normal((5, 4), dtype=np.float32),
                                       rng.standard_normal((4, 6), dtype=np.float32))
        make = lambda dev: net.build(engine="register", K=3, device=dev,  # noqa: E731
                                     session=False)
        run = lambda e: register_state_to_numpy(e.run_epochs(e.init(), 4))  # noqa: E731
    else:
        vals = (np.arange(16) % 5 + 1).astype(np.float32).reshape(4, 4)
        Engine, to_np = {"graph": (GraphEngine, graph_state_to_numpy),
                         "fused": (FusedEngine, fused_state_to_numpy)}[engine]
        make = lambda dev: Engine(torus(4, 4, vals, 4), np.arange(16) % 2,  # noqa: E731
                                  {"gx": 2}, K=2, batch_axes=("gx",), device=dev)
        run = lambda e: to_np(e.run_epochs(e.init(0), 4))  # noqa: E731
    seq, one = make(["cpu"]), make("cpu")
    assert seq.device == one.device == torch.device("cpu")
    assert_same(run(one), run(seq), engine)


@pytest.mark.parametrize("case", ["frand1", "grand1", "mix_f"])
def test_reference_mid_run_state_crosses_into_shards(ref, case):
    """A JAX mesh engine's mid-run state, in its global layout, becomes the
    port's sharded state (``convert.*_state_from_numpy`` places it on the
    shards) and continues to the reference's next epoch."""
    from repro_torch.convert import fused_state_from_numpy, graph_state_from_numpy

    if case == "mix_f":
        vals = np.random.RandomState(7).randint(1, 30, size=(R, C)).astype(np.float32)
        part = np.random.RandomState(2).randint(0, 4, size=R * C)
        eng = FusedEngine(torus(R, C, vals, 4), part, {"pod": 2}, batch_axes={"gx": 2},
                          tiers=[(("pod",), 2), (("gx",), 4)], device="cpu")
    else:
        vals = np.random.RandomState(11).randint(1, 30, size=(R, C)).astype(np.float32)
        part = np.random.RandomState(1).randint(0, 4, size=R * C)
        cls = GraphEngine if case == "grand1" else FusedEngine
        eng = cls(torus(R, C, vals, 4), part, M22, device="cpu",
                  tiers=[(("pod",), 2), (("gx",), 3)])
    from_numpy = graph_state_from_numpy if case == "grand1" else fused_state_from_numpy
    st = from_numpy(eng, ref[case]["2"])
    assert isinstance(st, ShardedState) and len(st.shards) == eng.G_real
    assert_same(ref[case]["2"], fused_state_to_numpy(st), "carried")
    st = eng.run_epochs(st, 1)
    assert_same(ref[case]["3"], fused_state_to_numpy(st), "continued")
