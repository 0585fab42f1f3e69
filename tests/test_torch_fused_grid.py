"""The port's ``FusedEngine.grid`` and fused programs of several groups and
block types (CPU, plain version) against the JAX ``FusedEngine``.

The JAX engine runs two ways: ``fuse="pallas", pallas_interpret=True``
(``granule_step.pallas_program``, the TPU kernel the port's Hopper kernel
replaces, in the Pallas interpreter) and ``fuse="xla"``.  Tolerance is
bit-exact throughout, state leaf for state leaf after every epoch: the
logic is integer handshakes, and the MAC is one fused multiply-add in
both packages (XLA contracts the reference's ``psum + a * b`` in either
mode; a multiply then an add would differ, as the last check of the grid
case shows).  The networks of several groups come from
``repro_torch.kernels.fused_checks``, built in each package from its own
classes.  JAX meshes use Auto axes (ROADMAP Queue 3, R1).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Network as JNetwork
from repro.core.fused import FusedEngine as JFused
from repro.hw.manycore import CoreParams as JCoreParams
from repro.hw.manycore import ManycoreCell as JCore
from repro.hw.systolic import SystolicCell as JCell
from repro.hw.systolic import SystolicParams as JParams
from repro.hw.systolic import make_cell_params as j_params
from repro_torch.convert import (fused_state_from_numpy, fused_state_to_numpy,
                                 params_from_numpy)
from repro_torch.core.fused import FusedEngine as TFused
from repro_torch.hw.systolic import SystolicCell as TCell
from repro_torch.hw.systolic import SystolicParams as TParams
from repro_torch.hw.systolic import make_cell_params as t_params
from repro_torch.hw.systolic import matmul_error_bound
from repro_torch.kernels import fused_checks as fc
from repro_torch.kernels import granule_step

from test_torch_graph import assert_same_state, auto_mesh, jax_state_dict

JAX_KIT = types.SimpleNamespace(
    Network=JNetwork, ManycoreCell=JCore, CoreParams=JCoreParams,
    SystolicCell=JCell, SystolicParams=JParams, make_cell_params=j_params)
FUSE = {"pallas": dict(fuse="pallas", pallas_interpret=True),
        "xla": dict(fuse="xla")}


def _grid_pair(M, R, C, K, fuse):
    """The same grid in both packages: (jax engine, its placed initial
    state, port engine on the CPU, A, B)."""
    A, B = fc.operands(M, R, C, seed=M + K)
    je = JFused.grid(JCell(m_stream=M), R, C, auto_mesh((1, 1), ("gr", "gc")),
                     K=K, **FUSE[fuse])
    gp = {0: jax.tree.map(lambda x: jnp.reshape(jnp.asarray(x),
                                                (R * C,) + np.shape(x)[2:]),
                          j_params(A, B))}
    js = je.place(je.init(jax.random.key(0), group_params=gp))
    te = TFused.grid(TCell(m_stream=M), R, C, K=K, params=t_params(A, B),
                     device="cpu")
    return je, js, te, A, B


def _lockstep(je, js, te, ts, done, max_epochs=300):
    """Epochs of both engines from their states, every leaf bit-exact after
    each, until ``done`` holds on the port's block states.  Returns the
    final (jax, port) states and the epochs run."""
    for ep in range(max_epochs):
        js = je.run_epochs(js, 1, donate=False)
        ts = te.run_epochs(ts, 1)
        assert_same_state(jax_state_dict(js), ts, ep)
        if done(ts.block_states):
            return js, ts, ep + 1
    raise AssertionError(f"not done after {max_epochs} epochs")


@pytest.mark.parametrize("fuse", list(FUSE))
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("M,R,C", [(6, 4, 4), (12, 8, 8)])
def test_grid_matches_jax_epoch_by_epoch(M, R, C, K, fuse):
    je, js, te, A, B = _grid_pair(M, R, C, K, fuse)
    ts = te.init(0)
    assert_same_state(jax_state_dict(js), ts, "init")
    _, ts, epochs = _lockstep(
        je, js, te, ts, lambda st: bool(fc.south_done(st[0], M)))
    assert epochs * K == int(ts.cycle.reshape(-1)[0])
    Y = fc.grid_result(te, ts, 0, R, C, M)
    Y64 = A.astype(np.float64) @ B.astype(np.float64)
    assert (np.abs(Y - Y64) <= matmul_error_bound(A, B)).all()
    # one rounding a MAC: summing the products rounded first differs
    two = np.zeros((M, C), np.float32)
    for r in range(R):
        two = two + A[:, r:r + 1] * B[r:r + 1, :]
    assert not np.array_equal(Y, two)


def test_run_until_stops_where_jax_does():
    """``run_until`` with a relative ``max_epochs`` budget stops at the JAX
    engine's cycle with the JAX engine's state, budget cut or not."""
    M, R, C, K = 12, 8, 8, 4
    je, js0, te, _, _ = _grid_pair(M, R, C, K, "xla")
    jdone = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                       | (s.block_states[0].y_idx >= M)).all()
    tdone = lambda s: fc.south_done(s.block_states[0], M)  # noqa: E731
    cycles = []
    for max_epochs in (1, 3, 100):
        js = je.run_until(js0, jdone, max_epochs, cache_key="done", donate=False)
        ts = te.run_until(te.init(0), tdone, max_epochs)
        assert_same_state(jax_state_dict(js), ts, max_epochs)
        cycles.append(int(ts.cycle.reshape(-1)[0]))
    assert cycles[:2] == [K, 3 * K] and cycles[2] < 100 * K
    # an already-done state runs no epoch
    ts = te.run_until(ts, tdone, 5)
    assert int(ts.cycle.reshape(-1)[0]) == cycles[2]


def _net_pair(build, fuse, K, **part):
    """A network built from the same builder in both packages, lowered to
    the fused engine in each (the port's on the CPU)."""
    A, B = fc.operands(7, 6, 5, seed=11)
    jnet = build(A, B, JAX_KIT)[0]
    tnet = build(A, B, None)[0]
    if part:
        jmesh = auto_mesh((1,), ("g",))
    else:
        jmesh = auto_mesh((1,), ("gx",))
    je = jnet.build(engine="fused", session=False, mesh=jmesh, K=K, **part,
                    **FUSE[fuse])
    te = tnet.build(engine="fused", session=False, device="cpu", K=K, **part)
    return je, te


def _all_done(te):
    blocks = [g.block for g in te.graph.groups]
    return lambda states: fc.blocks_done(blocks, states)


def _two_group(A, B, kit):
    return fc.two_group_systolic(A, B, kit=kit, capacity=4)


def _mixed(A, B, kit):
    return fc.mixed_network(A, B, 4, 5, kit=kit, capacity=4)


@pytest.mark.parametrize("fuse", list(FUSE))
@pytest.mark.parametrize("which", ["two_group", "mixed"])
def test_networks_of_several_groups_match_jax(which, fuse):
    """Two groups of SystolicCell (channels across the groups), and a
    ManycoreCell torus with SystolicCell relays in its rings beside a
    systolic grid (three groups, two types, channels from one type to the
    other both ways): bit-exact after every epoch to the end of the run."""
    build = {"two_group": _two_group, "mixed": _mixed}[which]
    je, te = _net_pair(build, fuse, 3)
    assert len(te.graph.groups) == {"two_group": 2, "mixed": 3}[which]
    js = je.place(je.init(jax.random.key(0)))
    ts = te.init(0)
    assert_same_state(jax_state_dict(js), ts, "init")
    _, ts, _ = _lockstep(je, js, te, ts, _all_done(te))
    if which == "mixed":
        assert (te.gather_group(ts, 0).total == fc.torus_values(4, 5).sum()).all()


def test_mixed_network_on_two_batched_granules_matches_jax():
    """The mixed network cut into two granules stacked on one batch axis:
    boundary queue rows between the types, the tier exchange between
    cycle blocks."""
    part = dict(partition=np.arange(6 * 5 + 4 * 5 + 4) % 2,
                tiers=[(("g",), 4)], batch_axes={"g": 2})
    je, te = _net_pair(_mixed, "xla", 4, **part)
    assert te.B == 2 and te.n_q > 1
    js = je.place(je.init(jax.random.key(0)))
    ts = te.init(0)
    _lockstep(je, js, te, ts, _all_done(te))


def test_consumer_table_across_groups():
    """Consumers named by flat id across groups, -1 for a boundary row, -2
    for a sentinel; a row with two local sides raises."""
    A, B = fc.operands(7, 6, 5, seed=11)
    net, *_ = fc.mixed_network(A, B, 4, 5, capacity=4)
    eng = net.build(engine="fused", session=False, device="cpu", K=4,
                    partition=np.arange(54) % 2, tiers=[(("g",), 4)],
                    batch_axes={"g": 2})
    n_reg = eng.B * eng.n_reg
    args = (eng._inv_tx_flat, eng._inv_tx_mask_flat, eng._inv_rx_flat,
            eng._inv_rx_mask_flat, n_reg)
    tables = granule_step.consumer_table(eng._tx_flat, *args)
    rxs = [t[0] for t in eng._rx_flat]
    bases = np.cumsum([0] + [2 * r.shape[0] for r in rxs])
    kinds = {"cross": 0, "queue": 0, "sentinel": 0}
    for g, (cons, tx) in enumerate(zip(tables, eng._tx_flat)):
        tx = tx[0]
        assert cons.shape == tx.shape and cons.dtype == np.int32
        for i, p in zip(*np.nonzero(cons >= 0)):
            cg = int(np.searchsorted(bases, cons[i, p], side="right")) - 1
            j, pj = divmod(int(cons[i, p] - bases[cg]), 2)
            assert rxs[cg][j, pj] == tx[i, p] < n_reg
            kinds["cross"] += cg != g
        kinds["queue"] += int((cons == -1).sum())
        assert (tx[cons == -1] >= n_reg).all()
        kinds["sentinel"] += int((cons == -2).sum())
        assert (tx[cons == -2] % eng.n_reg < 2).all()
    assert all(kinds.values()), kinds
    # an egress row given a local consumer too breaks the rule
    row = int(eng._tx_flat[0][0][tables[0] == -1][0])
    inv_rx_mask = eng._inv_rx_mask_flat.copy()
    inv_rx_mask[0, row] = True
    with pytest.raises(NotImplementedError, match="one local side"):
        granule_step.consumer_table(eng._tx_flat, eng._inv_tx_flat,
                                    eng._inv_tx_mask_flat, eng._inv_rx_flat,
                                    inv_rx_mask, n_reg)


def test_grid_state_carried_across_both_ways():
    """A mid-run JAX grid state and its group params, as numpy, start the
    port's engine (built without params) and continue to the JAX end
    state; the port's state maps back to the same arrays."""
    M, R, C, K = 12, 8, 8, 4
    je, js, _, A, B = _grid_pair(M, R, C, K, "xla")
    js = je.run_epochs(js, 3, donate=False)
    arrays = jax_state_dict(js)
    te = TFused.grid(TCell(m_stream=M), R, C, K=K, device="cpu")
    gp = {0: params_from_numpy(TParams, {
        f: np.reshape(getattr(t_params(A, B), f), (R * C,) + np.shape(
            getattr(t_params(A, B), f))[2:]) for f in TParams._data_fields},
        device="cpu")}
    ts = fused_state_from_numpy(te, arrays, group_params=gp)
    assert_same_state(arrays, ts, "converted")
    back = fused_state_to_numpy(ts)
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
    js = je.run_epochs(js, 4, donate=False)
    ts = te.run_epochs(ts, 4)
    assert_same_state(jax_state_dict(js), ts, "continued")
    with pytest.raises(ValueError, match="per-instance params"):
        fused_state_from_numpy(te, arrays)


class _OwnStep(TCell):
    """A block type with a step of its own: it has no device step."""

    def step(self, state, rx, tx_ready):
        return super().step(state, rx, tx_ready)


class _HalfRate(TCell):
    clock_divider = 2


def test_cuda_program_refuses_a_block_type_without_device_step():
    """A CUDA program of a type with no device step raises before anything
    is launched, naming the type (checked on a CPU carry, which the CUDA
    wrapper takes as far as its type check); a subclass that keeps the
    base step (a clock divider) has the base's device step."""
    A, B = fc.operands(6, 4, 4, seed=1)
    assert granule_step.device_step_type(_HalfRate(6)) == 1
    assert granule_step.device_step_type(_OwnStep(6)) is None
    eng = TFused.grid(_OwnStep(6), 4, 4, K=2, params=t_params(A, B), device="cpu")
    local = eng._local_view(eng.init(0))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    before = granule_step.launches
    with pytest.raises(NotImplementedError, match="_OwnStep"):
        granule_step.epoch_program_cuda(carry, eng._resident_program(0),
                                        eng._consts(local.tables))
    assert granule_step.launches == before
    # the plain version runs it on the CPU
    st = eng.run_epochs(eng.init(0), 3)
    assert int(st.cycle.reshape(-1)[0]) == 6
