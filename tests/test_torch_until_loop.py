"""``run_until`` as one device program (``repro_torch.core.device_loop``)
against the JAX engines' ``jax.lax.while_loop``.

Engines, at the CPU tests' sizes: the fused engine on the 8x8 wafer of
``tests/test_torch_fused.py`` (2 pods x 2x2 granules, K = (2, 4)), on
``FusedEngine.grid(SystolicCell)`` at (M, R, C, K) = (12, 8, 8, 4) on one
granule and on 2x2 batched granules with ``overlap`` off and on, and the
register engine at (12, 8, 8), K = 4, on one tile and on 2x2 tiles.  Each
runs ``run_until`` from its initial state at ``max_epochs`` 0, 1, 3 and
100 with spans of 1, 3 and 8 epochs; the stop cycle, the epoch and every
state leaf must equal the JAX engine's ``run_until(..., cache_key=...)``
bit for bit.  The JAX side runs its compiled loop with a budget of one
epoch, re-entered until it runs no epoch: by the reference's contract (a
relative budget; a done state runs zero epochs) the state after b calls is
its ``run_until`` at budget b, and one compile a configuration keeps the
file inside its time budget (the wafer's loop takes seconds to compile).
The cheap configurations also hold a direct call at budget 100.  The
2x2-tile register reference needs a 2x2 JAX mesh and runs in a
subprocess on 4 fake devices.  JAX meshes use Auto axes (ROADMAP Queue 3,
R1).

On the CPU the span runs eagerly with the kernels' plain versions, so
these tests hold the same stop and budget logic that a CUDA state replays
from a captured graph; ``cuda``-marked tests hold the replay against the
host loop on the card and skip here
(``tests/test_torch_until_loop_cuda.py``, which imports no JAX).
"""
import functools
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fastgrid import RegisterGridEngine as JReg
from repro.core.fused import FusedEngine as JFused
from repro.core.graph import ChannelGraph as JGraphC
from repro.core.graph import grid_partition as j_grid_partition
from repro.core.session import Simulation as JSimulation
from repro.core.distributed import GraphEngine as JGraphEngine
from repro.hw.manycore import allreduce_done as j_allreduce_done
from repro.hw.systolic import SystolicCell as JCell
from repro.hw.systolic import make_cell_params as j_cell_params
from repro_torch.core import Simulation
from repro_torch.core import device_loop
from repro_torch.core.distributed import GraphEngine as TGraphEngine
from repro_torch.core.fastgrid import RegisterGridEngine as TReg
from repro_torch.core.fused import FusedEngine as TFused
from repro_torch.core.struct import tree_leaves
from repro_torch.kernels import fused_checks as fc
from repro_torch.kernels import granule_step, systolic_step
from repro_torch.obs.registry import REGISTRY

from test_torch_graph import auto_mesh, jax_state_dict, wafer_pair
from test_torch_until_loop_cuda import (BUDGETS, CONFIGS, SPANS, WAFER_TIERS, C, K,
                                        M, R, _operands, _t_done, assert_same,
                                        port_engine, to_numpy)

def _j_south(bs):
    return ((~bs.is_south) | (bs.y_idx >= M)).all()


def _j_reg_dict(state) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]:
        out[".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path)] = (
            np.asarray(leaf))
    return out


def _chain(run_until, state, to_dict):
    """States after 0, 1, 2, ... calls of a budget-1 ``run_until``, up to
    the first call that runs no epoch (the run's end)."""
    states = [to_dict(state)]
    for _ in range(100):
        state = run_until(state, 1)
        states.append(to_dict(state))
        if np.array_equal(states[-1]["epoch"], states[-2]["epoch"]):
            return states
    raise AssertionError("the JAX reference did not finish in 100 epochs")


_REG_2X2 = textwrap.dedent("""
    import sys, numpy as np, jax
    from jax.sharding import AxisType
    from repro.core.fastgrid import RegisterGridEngine
    M, R, C, K = {M}, {R}, {C}, {K}
    rng = np.random.RandomState(7)
    A = rng.randn(M, R).astype(np.float32)
    B = rng.randn(R, C).astype(np.float32)
    mesh = jax.make_mesh((2, 2), ('gr', 'gc'), axis_types=(AxisType.Auto,) * 2)
    eng = RegisterGridEngine(R, C, mesh, K=K, m_stream=M)
    done = lambda cell: ((~cell['is_south']) | (cell['y_idx'] >= M)).all()
    st = eng.place(eng.init(A, B))
    arrays, ep = {{}}, 0
    def dump(st, i):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(st))[0]:
            key = '.'.join(str(getattr(k, 'name', getattr(k, 'key', k))) for k in path)
            arrays[f'{{i}}/{{key}}'] = np.asarray(leaf)
    dump(st, 0)
    for i in range(1, 101):
        prev = int(np.asarray(jax.device_get(st.epoch)).ravel()[0])
        st = eng.run_until(st, done, 1, cache_key='done', donate=False)
        dump(st, i)
        if int(np.asarray(jax.device_get(st.epoch)).ravel()[0]) == prev:
            break
    np.savez(sys.argv[1], **arrays)
""")


@functools.lru_cache(maxsize=None)
def jax_reference(config, tmp_dir):
    """The JAX engine's ``run_until`` states of a configuration: the list
    of states after 0, 1, ... budget-1 calls (the last two equal), and,
    where it is cheap, the state of one direct call at budget 100."""
    A, B = _operands()
    if config == "register-2x2":
        out = os.path.join(tmp_dir, "reg2x2.npz")
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _REG_2X2.format(M=M, R=R, C=C, K=K), out],
            capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        traj = np.load(out)
        n = 1 + max(int(k.split("/")[0]) for k in traj.files)
        return [{k.split("/", 1)[1]: traj[k] for k in traj.files
                 if k.startswith(f"{i}/")} for i in range(n)], None
    if config == "register":
        je = JReg(R, C, auto_mesh((1, 1), ("gr", "gc")), K=K, m_stream=M)
        js = je.place(je.init(A, B))
        done = lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all()  # noqa: E731
        to_dict = _j_reg_dict
    elif config == "wafer":
        je = wafer_pair(8, 8, WAFER_TIERS, 8, fuse="xla")[0]
        js = je.place(je.init(jax.random.key(0)))
        done = lambda s: j_allreduce_done(s.block_states[0])  # noqa: E731
        to_dict = jax_state_dict
    else:
        mesh = auto_mesh((1, 1), ("gr", "gc"))
        graph = JGraphC.grid(JCell(m_stream=M), R, C)
        if "2x2" in config:
            je = JFused(graph, j_grid_partition(R, C, 2, 2), mesh, K=K,
                        axes=("gr", "gc"), batch_axes={"gr": 2, "gc": 2},
                        overlap=config.endswith("overlap"), fuse="xla")
        else:
            je = JFused(graph, j_grid_partition(R, C, 1, 1), mesh, K=K,
                        axes=("gr", "gc"), fuse="xla")
        gp = {0: jax.tree.map(lambda x: jnp.reshape(jnp.asarray(x),
                                                    (R * C,) + np.shape(x)[2:]),
                              j_cell_params(A, B))}
        js = je.place(je.init(jax.random.key(0), group_params=gp))
        done = lambda s: _j_south(s.block_states[0])  # noqa: E731
        to_dict = jax_state_dict
    chain = _chain(lambda st, b: je.run_until(st, done, b, cache_key="done",
                                              donate=False), js, to_dict)
    direct = None
    if config in ("grid", "register"):
        direct = to_dict(je.run_until(js, done, 100, cache_key="done",
                                      donate=False))
    return chain, direct


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("until_ref"))


def _cycle(state) -> int:
    return int(state.cycle.reshape(-1)[0])


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("config", CONFIGS)
def test_run_until_matches_jax(config, span, ref_dir, monkeypatch):
    """The port's device loop (eager on the CPU) stops at the JAX engine's
    cycle and epoch with its state, at every budget and span."""
    monkeypatch.setattr(device_loop, "SPAN", span)
    chain, direct = jax_reference(config, ref_dir)
    eng, st0 = port_engine(config)
    done = _t_done(config)
    stop_epochs = len(chain) - 2
    assert stop_epochs > 3  # the budgets below cut the run before its end
    for b in BUDGETS:
        st = eng.run_until(st0, done, b, cache_key="done")
        want = chain[min(b, stop_epochs)]
        assert_same(want, to_numpy(st), (config, span, b))
        assert int(st.epoch.reshape(-1)[0]) == min(b, stop_epochs)
    if direct is not None:
        assert_same(direct, to_numpy(st), (config, span, "direct"))


@pytest.mark.parametrize("config", CONFIGS)
def test_host_loop_matches_device_loop(config, ref_dir):
    """The plain version of the loop (``run_until_host``, the predicate
    read on the host before every epoch) stops where the device loop and
    the JAX engine do."""
    chain, _ = jax_reference(config, ref_dir)
    eng, st0 = port_engine(config)
    for b in BUDGETS:
        st = eng.run_until_host(st0, _t_done(config), b)
        assert_same(chain[min(b, len(chain) - 2)], to_numpy(st), (config, b))


@pytest.mark.parametrize("config", ["wafer", "grid-2x2-overlap", "register-2x2"])
def test_done_state_runs_zero_epochs(config):
    """A state already done runs no epoch: the state, cycle and epoch come
    back bit for bit, and no epoch is counted."""
    eng, st = port_engine(config)
    done = _t_done(config)
    st = eng.run_until(st, done, 100)
    assert bool(eng.tiles_done(st.cell, done) if hasattr(st, "cell")
                else done(eng._done_view(eng._local_view(st))))
    before = to_numpy(st)
    counters = REGISTRY.counters()
    for b in (0, 1, 5):
        again = eng.run_until(st, done, b)
        assert_same(before, to_numpy(again), b)
    kind = "register" if hasattr(st, "cell") else "fused"
    assert REGISTRY.counters().get(f"{kind}.epochs") == counters.get(f"{kind}.epochs")


@pytest.mark.parametrize("config", CONFIGS)
def test_epoch_counters_count_epochs_run(config, monkeypatch):
    """The loop's epoch counter (``until.epochs``) rises by the epochs
    that ran, not by the no-op epochs of a span, as the host loop's does;
    the engine's dispatch counters count none of them (the reference's
    ``run_until`` counts none either); and the loop reads the host once a
    span plus once at its end."""
    monkeypatch.setattr(device_loop, "SPAN", 3)
    eng, st0 = port_engine(config)
    kind = "register" if hasattr(st0, "cell") else "fused"
    before = REGISTRY.counters()
    st = eng.run_until(st0, _t_done(config), 100)
    after = REGISTRY.counters()
    ran = int(st.epoch.reshape(-1)[0])
    delta = lambda n: after.get(n, 0) - before.get(n, 0)  # noqa: E731
    assert ran > 3
    assert delta("until.epochs") == ran
    assert delta(f"{kind}.epochs") == 0
    assert delta(f"{kind}.dispatch.count") == 0
    # the predicate first holds at the check before epoch ran + 1, which
    # ends span ceil(ran / 3) (a span's last check is the next one's first)
    assert delta("until.spans") == -(-ran // 3)
    assert delta("until.host_syncs") == -(-ran // 3) + 1
    eng, st0 = port_engine(config)
    before = REGISTRY.counters().get("until.epochs", 0)
    eng.run_until_host(st0, _t_done(config), 100)
    assert REGISTRY.counters().get("until.epochs", 0) - before == ran


@pytest.mark.parametrize("config", ["wafer", "grid-2x2-overlap"])
def test_gated_epoch_is_a_noop_fused(config):
    """With ``stop`` set, ``epoch_program_ref`` returns the carry bit for
    bit, and so does the engine's whole epoch (counters included); with
    ``stop`` clear both equal the ungated epoch."""
    eng, st = port_engine(config)
    st = eng.run_epochs(st, 2)
    local = eng._local_view(st)
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    args = dict(exchange_fn=eng._resident_exchange,
                issue_fn=eng._resident_exchange_issue,
                commit_fn=eng._resident_exchange_commit,
                consts=eng._consts(local.tables))
    program = eng._resident_program(0)
    stopped = granule_step.epoch_program_ref(
        eng._resident_cycle, carry, program, stop=torch.tensor(True), **args)
    _same_leaves(carry, stopped)
    ran = granule_step.epoch_program_ref(eng._resident_cycle, carry, program, **args)
    gated = granule_step.epoch_program_ref(
        eng._resident_cycle, carry, program, stop=torch.tensor(False), **args)
    _same_leaves(ran, gated)
    assert not _leaves_equal(carry, ran)  # the epoch does move the state
    before = to_numpy(st)
    out = eng._global_view(eng._epoch(local, stop=torch.tensor(True)))
    assert_same(before, to_numpy(out), "stopped epoch")
    assert_same(to_numpy(eng.run_epochs(st, 1)),
                to_numpy(eng._global_view(eng._epoch(local, stop=torch.tensor(False)))),
                "running epoch")


@pytest.mark.parametrize("config", ["register", "register-2x2"])
def test_gated_epoch_is_a_noop_register(config):
    """With ``stop`` set, ``systolic_step_ref`` returns the cells bit for
    bit with empty slabs, and the engine's epoch (exchange and counters
    included) leaves the whole state as it was."""
    eng, st = port_engine(config)
    st = eng.run_epochs(st, 3)
    inp = eng.step_input(st)
    out = systolic_step.systolic_step_ref(inp, K, torch.tensor(True))
    for k in systolic_step.CELL_OUT:
        assert torch.equal(out[k], inp[k]), k
    for k in systolic_step.EDGE_OUT:
        assert not out[k].any(), k
    ran = systolic_step.systolic_step_ref(inp, K)
    gated = systolic_step.systolic_step_ref(inp, K, torch.tensor(False))
    for k in systolic_step.CELL_OUT + systolic_step.EDGE_OUT:
        assert torch.equal(ran[k], gated[k]), k
    assert not torch.equal(ran["a_idx"], inp["a_idx"])
    before = to_numpy(st)
    assert_same(before, to_numpy(eng._epoch(st, stop=torch.tensor(True))), "stopped")
    assert_same(to_numpy(eng._epoch(st)),
                to_numpy(eng._epoch(st, stop=torch.tensor(False))), "running")


def _leaves_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _same_leaves(a, b):
    assert _leaves_equal(a, b)


@pytest.mark.parametrize("config", ["wafer", "register"])
def test_donate_false_keeps_input(config):
    eng, st0 = port_engine(config)
    before = to_numpy(st0)
    out = eng.run_until(st0, _t_done(config), 100, donate=False)
    assert_same(before, to_numpy(st0), "input")
    assert int(out.epoch.reshape(-1)[0]) > 3


def test_run_until_signatures_match_jax():
    """``run_until`` of both engines and ``Simulation.run`` (and the
    ``_session_run`` behind it) take the JAX package's parameters,
    ``cache_key`` included, with its defaults."""
    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(TGraphEngine.run_until) == params(JGraphEngine.run_until)
    assert params(TFused.run_until) == params(JFused.run_until)
    assert params(TReg.run_until) == params(JReg.run_until)
    assert params(Simulation._session_run)[1:] == params(JSimulation._session_run)[1:]
    assert params(Simulation.run) == params(JSimulation.run)


@pytest.mark.parametrize("config", ["grid-2x2", "register"])
def test_session_run_until_takes_cache_key(config, ref_dir):
    """``Simulation.run(until=..., cache_key=...)`` stops where the JAX
    engine does, and again at once on a done state."""
    chain, _ = jax_reference(config, ref_dir)
    eng, _ = port_engine(config)
    sim = Simulation(eng).reset(0)
    sim.run(until=_t_done(config), max_epochs=3, cache_key="k")
    assert sim.epoch == 3
    sim.run(until=_t_done(config), cache_key="k")
    assert_same(chain[-1], to_numpy(sim.state), config)
    cycle = sim.cycle
    sim.run(until=_t_done(config), cache_key="k")
    assert sim.cycle == cycle


def test_blocks_done_is_a_device_tensor():
    """``fused_checks.blocks_done`` (the fsys predicate) returns a () bool
    tensor, with no host read, for both block types."""
    A, B = fc.operands(7, 6, 5, seed=11)
    net = fc.mixed_network(A, B, 4, 5, capacity=4)[0]
    eng = net.build(engine="fused", session=False, device="cpu", K=3)
    done = fc.network_done(eng)
    st = eng.init(0)
    flag = done(eng._local_view(st))
    assert isinstance(flag, torch.Tensor) and flag.shape == () and not bool(flag)
    st = eng.run_until(st, done, 1000)
    assert bool(done(eng._local_view(st)))
