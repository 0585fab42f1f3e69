"""The port's channel-graph IR and partition lowering against ``repro``.

Both packages build the same wafer; every table must be equal: the
``ChannelGraph.torus`` tables, the ``PartitionTree``, ``lower_partition``
(queue ids, member placement, routes), the signature batching
(``granule_signature`` groups and ``batch_plan``), the exchange-class
coloring, and the fused engine's flat port tables, inverse maps and
``bat_fwd``/``bat_rev`` slab gathers.

The helpers at the top are shared with the other ``test_torch_*`` files.
JAX reference meshes use Auto axes (ROADMAP Queue 3, R1).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import ChannelGraph as JGraph
from repro.core import PartitionTree as JTree
from repro.core import lower_partition as j_lower
from repro.core import tiered_grid_partition as j_tgp
from repro.core.distributed import edge_color_routes as j_color
from repro.core.fused import FusedEngine as JFused
from repro.hw.manycore import ManycoreCell as JCell
from repro.hw.manycore import make_core_params as j_params
from repro_torch.convert import fused_state_to_numpy
from repro_torch.core import ChannelGraph as TGraph
from repro_torch.core import PartitionTree as TTree
from repro_torch.core import lower_partition as t_lower
from repro_torch.core import tiered_grid_partition as t_tgp
from repro_torch.core.distributed import edge_color_routes as t_color
from repro_torch.core.fused import FusedEngine as TFused
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import ManycoreCell as TCell
from repro_torch.hw.manycore import make_core_params as t_params


# ------------------------------------------------------------ shared helpers
def auto_mesh(shape, names):
    """A JAX mesh with Auto axes (the reference's working mode on jax 0.9)."""
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(names))


def wafer_values(R, C):
    return ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)


def wafer_pair(R, C, tiers, cap, part=None, overlap=False, batch=None, **jax_kw):
    """The same wafer engine in both packages: (jax engine, port engine on
    the CPU, values).  ``tiers`` is ((pod axis, K_outer), (g axis, K_inner))
    style; the default partition is 2 pods x 2x2 granules."""
    vals = wafer_values(R, C)
    if part is None:
        part = j_tgp(R, C, [(2, 1), (2, 2)])
    batch = batch or {"pod": 2, "g": 4}
    names = tuple(batch)
    je = JFused(
        JGraph.torus(JCell(R, C), R, C, params=j_params(vals), capacity=cap),
        part, auto_mesh((1,) * len(names), names), tiers=tiers,
        batch_axes=batch, overlap=overlap, **jax_kw,
    )
    te = TFused(
        TGraph.torus(TCell(R, C), R, C, params=t_params(vals), capacity=cap),
        part, None, tiers=tiers, batch_axes=batch, overlap=overlap,
        device="cpu",
    )
    return je, te, vals


def jax_state_dict(state) -> dict:
    """A JAX fused state (global view) as {dotted path: numpy}, tables
    excluded — the keys ``repro_torch.convert`` uses."""
    state = jax.device_get(state).replace(tables=None)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = ".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path)
        out[key] = np.asarray(leaf)
    return out


def assert_same_state(jax_arrays: dict, torch_state, where=""):
    got = fused_state_to_numpy(torch_state)
    assert sorted(got) == sorted(jax_arrays), where
    for k, want in jax_arrays.items():
        assert got[k].dtype == want.dtype, (where, k, got[k].dtype, want.dtype)
        assert np.array_equal(got[k], want), (where, k)


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("R,C", [(4, 4), (6, 10)])
def test_torus_tables_equal(R, C):
    jg = JGraph.torus(JCell(R, C), R, C, params=j_params(wafer_values(R, C)))
    tg = TGraph.torus(TCell(R, C), R, C, params=t_params(wafer_values(R, C)))
    assert tg.n_channels == jg.n_channels and tg.n_instances == jg.n_instances
    for a, b in ((jg.chan_src, tg.chan_src), (jg.chan_dst, tg.chan_dst),
                 (jg.inst_loc, tg.inst_loc)):
        assert np.array_equal(a, b)
    for a, b in zip(jg.rx_idx + jg.tx_idx, tg.rx_idx + tg.tx_idx):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tg.capacity == jg.capacity == 62


def _partitions():
    R, C = 8, 8
    rng = np.random.RandomState(5)
    return [
        ("tiered", R, C, j_tgp(R, C, [(2, 1), (2, 2)])),
        ("random", R, C, rng.randint(0, 8, size=R * C).astype(np.int32)),
    ]


@pytest.mark.parametrize("name,R,C,part", _partitions(), ids=lambda x: x if isinstance(x, str) else "")
def test_partition_lowering_equal(name, R, C, part):
    vals = wafer_values(R, C)
    jg = JGraph.torus(JCell(R, C), R, C, params=j_params(vals), capacity=8)
    tg = TGraph.torus(TCell(R, C), R, C, params=t_params(vals), capacity=8)
    tiers = [(("pod",), 2), (("g",), 4)]
    jt, tt = JTree(part, tiers, {"pod": 2, "g": 4}), TTree(part, tiers, {"pod": 2, "g": 4})
    assert jt.periods() == tt.periods() and jt.summary() == tt.summary()
    src, dst = jg.channel_granules(part)
    assert np.array_equal(jt.tier_of_edges(src, dst), tt.tier_of_edges(src, dst))
    jl, tl = j_lower(jg, jt), t_lower(tg, tt)
    assert jl.n_local == tl.n_local
    for a, b in ((jl.tx_local, tl.tx_local), (jl.rx_local, tl.rx_local),
                 (jl.chan_owner, tl.chan_owner), (jl.boundary, tl.boundary)):
        assert np.array_equal(a, b)
    for a, b in zip(jl.rx_tables + jl.tx_tables + jl.act_tables,
                    tl.rx_tables + tl.tx_tables + tl.act_tables):
        assert np.array_equal(a, b)
    assert jl.routes == tl.routes
    # signatures hash the block's module path, so compare the grouping
    assert list(jl.signature_groups().values()) == list(tl.signature_groups().values())
    assert jl.batch_plan() == tl.batch_plan()


@pytest.mark.parametrize("seed", range(4))
def test_edge_coloring_equal_and_koenig_optimal(seed):
    """The exchange-class coloring is the same in both packages, and its
    class count equals the maximum granule in/out degree (König)."""
    rng = np.random.RandomState(seed)
    G = 6
    pairs = sorted({(int(s), int(d)) for s, d in rng.randint(0, G, size=(14, 2)) if s != d})
    jc, tc = j_color(pairs, G), t_color(pairs, G)
    assert jc == tc
    deg = max(max(sum(1 for s, _ in pairs if s == g), sum(1 for _, d in pairs if d == g))
              for g in range(G))
    assert len(tc) == deg
    for cls in tc:  # each class a partial permutation
        assert len({s for s, _ in cls}) == len(cls) == len({d for _, d in cls})


@pytest.mark.parametrize("name,R,C,part", _partitions(), ids=lambda x: x if isinstance(x, str) else "")
def test_fused_tables_equal(name, R, C, part):
    """Flat port tables, inverse maps, exchange tables and the batch-row
    gathers: the port's ``FusedEngine.tables()`` equals the JAX engine's
    leaf for leaf."""
    je, te, _ = wafer_pair(R, C, [(("pod",), 2), (("g",), 4)], 8, part=part)
    assert (je.n_reg, je.n_q, je.n_local, je.B) == (te.n_reg, te.n_q, te.n_local, te.B)
    assert [len(c) for c in je.tier_classes] == [len(c) for c in te.tier_classes]
    assert je._resident_program(0) == te._resident_program(0)
    jt = jax.device_get(je.tables())
    want = {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jt)[0]}
    got = {p: x.numpy() for p, x in tree_paths(te.tables())}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # initial states match too (ManycoreCell ignores the seed)
    assert_same_state(jax_state_dict(je.init(jax.random.key(0))), te.init(0))
    assert isinstance(te.tables().inv_tx, torch.Tensor)


def test_params_carried_across():
    """``params_from_numpy`` turns the JAX ``CoreParams`` leaves into the
    port's params; a wafer built from them starts in the JAX state."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.hw.manycore import CoreParams

    R, C = 4, 8
    vals = np.random.RandomState(2).randint(1, 50, size=(R, C)).astype(np.float32)
    jp = j_params(vals)
    tp = params_from_numpy(CoreParams, {"value": np.asarray(jp.value)}, device="cpu")
    assert isinstance(tp.value, torch.Tensor) and tp.value.dtype == torch.float32
    part = j_tgp(R, C, [(2, 1), (2, 2)])
    tiers = [(("pod",), 2), (("g",), 2)]
    je = JFused(JGraph.torus(JCell(R, C), R, C, params=jp, capacity=4), part,
                auto_mesh((1, 1), ("pod", "g")), tiers=tiers,
                batch_axes={"pod": 2, "g": 4})
    te = TFused(TGraph.torus(TCell(R, C), R, C, params=tp, capacity=4), part,
                None, tiers=tiers, batch_axes={"pod": 2, "g": 4}, device="cpu")
    assert_same_state(jax_state_dict(je.init(jax.random.key(0))), te.init(0))
