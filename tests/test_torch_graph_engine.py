"""The port's queue-interpreter ``GraphEngine`` (CPU) against the JAX
``GraphEngine``, leaf for leaf.

Tori of ``ManycoreCell``s on 2 pods x 4 granules, every granule batched
on one device, tiers ((pod, 2), (g, 4)): a 4x4 torus on the tiered tile
partition and a 6x10 one on a random partition (uneven, so padding slots
are live).  After every epoch every state leaf must equal the JAX
engine's, with ``overlap`` off and on; a mid-run JAX state carried across
by ``convert.graph_state_from_numpy`` continues to the JAX end state.
Each case runs the port twice: as the CPU runs it (the functional queue
ops) and with the engine's in-place path switched on (``queue.cycle_``,
``stage_drain_``, ``stage_fill_`` and ``SystolicCell.step_``, what the
card runs), which must give the same bits.  Also: ``run_until`` at
budgets 0, 1, 3 and 1000; the capacity-2, K = (1, 1) engine against the
single netlist cycle by cycle and against ``FusedEngine``; ``GridEngine``
against the JAX ``GridEngine`` on a systolic matmul at K = 1, 4 and 16;
the heterogeneous SoC of ``examples/`` and a ``PipeStage`` chain driven
through the session's host ports.  Tolerance is bit-exact throughout.
JAX meshes use Auto axes (ROADMAP Queue 3, R1).
"""
import functools
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import ChannelGraph as JGraph
from repro.core import tiered_grid_partition as j_tgp
from repro.core.distributed import GraphEngine as JGE
from repro.core.distributed import GridEngine as JGrid
from repro.core.session import Simulation as JSimulation
from repro.hw.manycore import ManycoreCell as JCell
from repro.hw.manycore import allreduce_done as j_done
from repro.hw.manycore import make_core_params as j_params
from repro.hw.pipestage import make_chain as j_chain
from repro.hw.systolic import SystolicCell as JSys
from repro.hw.systolic import make_cell_params as j_cell_params
from repro_torch.convert import graph_state_from_numpy, graph_state_to_numpy
from repro_torch.core import ChannelGraph as TGraph
from repro_torch.core import NetworkSim, Simulation
from repro_torch.core import device_loop
from repro_torch.core import queue as qmod
from repro_torch.core.distributed import GraphEngine as TGE
from repro_torch.core.distributed import GridEngine as TGrid
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.manycore import ManycoreCell as TCell
from repro_torch.hw.manycore import allreduce_done
from repro_torch.hw.manycore import make_core_params as t_params
from repro_torch.hw.pipestage import PipeStage, make_chain
from repro_torch.hw.systolic import SystolicCell as TSys
from repro_torch.hw.systolic import make_cell_params as t_cell_params

from test_torch_graph import auto_mesh, jax_state_dict, wafer_values

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIERS = [(("pod",), 2), (("g",), 4)]
BATCH = {"pod": 2, "g": 4}
CAP = 4
MODES = ("functional", "inplace")


def _partition(R, C):
    if (R, C) == (4, 4):
        return j_tgp(R, C, [(2, 1), (2, 2)])
    return np.random.RandomState(5).randint(0, 8, size=R * C).astype(np.int32)


def port_engine(R, C, overlap, mode, cap=CAP):
    """The port's engine of a torus case on the CPU; ``mode="inplace"``
    switches on the path the card runs."""
    vals = wafer_values(R, C)
    eng = TGE(TGraph.torus(TCell(R, C), R, C, params=t_params(vals), capacity=cap),
              _partition(R, C), None, tiers=TIERS, batch_axes=BATCH,
              overlap=overlap, device="cpu")
    eng._inplace = mode == "inplace"
    return eng


@functools.lru_cache(maxsize=None)
def jax_trajectory(R, C, overlap):
    """The JAX engine's states after 0, 1, ... epochs, one epoch past the
    allreduce's end, and the JAX ``run_until`` states after 0, 1, ...
    budget-1 calls (by the reference's contract, a relative budget that
    runs no epoch on a done state, the state after b calls is its
    ``run_until`` at budget b; one compile serves every budget)."""
    vals = wafer_values(R, C)
    je = JGE(JGraph.torus(JCell(R, C), R, C, params=j_params(vals), capacity=CAP),
             _partition(R, C), auto_mesh((1, 1), ("pod", "g")), tiers=TIERS,
             batch_axes=BATCH, overlap=overlap)
    st0 = je.place(je.init(jax.random.key(0)))
    states, st = [jax_state_dict(st0)], st0
    done = lambda s: j_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    while not bool(done(st)) and len(states) < 200:
        st = je.run_epochs(st, 1, donate=False)
        states.append(jax_state_dict(st))
    states.append(jax_state_dict(je.run_epochs(st, 1, donate=False)))
    until, st = [jax_state_dict(st0)], st0
    while len(until) < 2 or not np.array_equal(until[-1]["epoch"], until[-2]["epoch"]):
        assert len(until) < 200, "the JAX run did not end"
        st = je.run_until(st, done, 1, cache_key="done", donate=False)
        until.append(jax_state_dict(st))
    direct = jax_state_dict(je.run_until(st0, done, 1000, cache_key="done",
                                         donate=False))
    return {"states": states, "until": until, "direct": direct,
            "total": float(vals.sum())}


def assert_same(want: dict, state, where):
    got = graph_state_to_numpy(state)
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        assert np.array_equal(got[k], want[k]), (where, k)


# ------------------------------------------------------------ epoch parity
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("R,C,ref_overlap", [(4, 4, False), (6, 10, True)])
def test_matches_jax_epoch_by_epoch(R, C, ref_overlap, overlap, mode):
    """Both schedules, both paths, against one JAX trajectory a torus (the
    schedules give the same bits by construction, in both packages)."""
    ref = jax_trajectory(R, C, ref_overlap)
    eng = port_engine(R, C, overlap, mode)
    st = eng.init(0)
    for ep, want in enumerate(ref["states"]):
        assert_same(want, st, (R, C, overlap, mode, ep))
        st = eng.run_epochs(st, 1)
    assert (eng.gather_group(st, 0).total == ref["total"]).all()
    # a mid-run JAX state continues to the JAX end state
    mid = len(ref["states"]) // 2
    st = graph_state_from_numpy(eng, ref["states"][mid])
    st = eng.run_epochs(st, len(ref["states"]) - 1 - mid)
    assert_same(ref["states"][-1], st, "carried across")
    with pytest.raises(KeyError, match="missing"):
        graph_state_from_numpy(eng, {"cycle": ref["states"][0]["cycle"]})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("span", [1, 3])
def test_run_until_matches_jax(span, mode, monkeypatch):
    """The device loop (eager on the CPU) and the host loop stop at the
    JAX engine's epoch with its state at budgets 0, 1, 3 and 1000 (the
    last also against one direct JAX call at that budget)."""
    monkeypatch.setattr(device_loop, "SPAN", span)
    ref = jax_trajectory(6, 10, True)
    until = ref["until"]
    assert_same(until[-1], graph_state_from_numpy(
        port_engine(6, 10, True, mode), ref["direct"]), "direct JAX call")
    stop = len(until) - 2
    assert stop > 3
    eng = port_engine(6, 10, True, mode)
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    for b in (0, 1, 3, 1000):
        for run in (eng.run_until, eng.run_until_host):
            st = run(eng.init(0), done, b)
            assert_same(until[min(b, stop)], st, (span, mode, b, run.__name__))
            assert int(st.epoch.reshape(-1)[0]) == min(b, stop)


@pytest.mark.parametrize("mode", MODES)
def test_gated_epoch_is_a_noop(mode):
    """With ``stop`` set the epoch leaves every leaf as it was; with it
    clear the epoch equals the ungated one; ``donate=False`` keeps the
    input on the in-place path too."""
    eng = port_engine(6, 10, False, mode)
    st = eng.run_epochs(eng.init(0), 2)
    before = graph_state_to_numpy(st)
    local = eng._local_view(st)
    out = eng._global_view(eng._epoch(local, stop=torch.tensor(True)))
    assert_same(before, out, "stopped")
    ran = eng.run_epochs(st, 1, donate=False)
    assert_same(before, st, "donate=False input")
    gated = eng._global_view(eng._epoch(eng._local_view(st), stop=torch.tensor(False)))
    assert_same(graph_state_to_numpy(ran), gated, "running")


# --------------------------------------------------- against the other engines
def _cap2_graph(vals):
    return TGraph.torus(TCell(4, 4), 4, 4, params=t_params(vals), capacity=2)


@pytest.mark.parametrize("mode", MODES)
def test_k11_capacity2_tracks_netlist_and_fused(mode):
    """K = (1, 1) exchanges every cycle, so the engine tracks the single
    netlist cycle by cycle; at capacity 2 the fused engine's depth-1
    registers are cycle-identical to its rings, so every block state
    equals the fused engine's after every epoch."""
    vals = np.random.RandomState(3).randint(1, 20, size=(4, 4)).astype(np.float32)
    part = np.arange(16) % 4
    sim = NetworkSim(_cap2_graph(vals), device="cpu")
    eng = TGE(_cap2_graph(vals), part, None, tiers=[(("g",), 1)], batch_axes={"g": 4},
              device="cpu")
    eng._inplace = mode == "inplace"
    fused = FusedEngine(_cap2_graph(vals), part, None, tiers=[(("g",), 1)],
                        batch_axes={"g": 4}, device="cpu")
    ss, gs, fs = sim.init(0), eng.init(0), fused.init(0)
    for t in range(40):
        ss, gs, fs = sim.step(ss), eng.run_epochs(gs, 1), fused.run_epochs(fs, 1)
        got, other = eng.gather_group(gs, 0), fused.gather_group(fs, 0)
        for name in ("value", "own", "acc", "total", "sent", "rcvd", "phase", "fwd",
                     "fwd_v", "fires"):
            want = getattr(ss.block_states[0], name).numpy()
            assert np.array_equal(want, getattr(got, name)), (t, name)
            assert np.array_equal(getattr(other, name), getattr(got, name)), (t, name)
    assert (eng.gather_group(gs, 0).total == vals.sum()).all()


def _sys_done(cells, M):
    return ((~cells.is_south) | (cells.y_idx >= M)).all()


@functools.lru_cache(maxsize=None)
def jax_grid(K, M, R, C):
    rng = np.random.RandomState(K)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    sim = JSimulation(JGrid(JSys(m_stream=M), R, C, auto_mesh((1, 1), ("gr", "gc")), K=K))
    sim.reset(jax.random.key(0), cell_params=j_cell_params(A, B))
    sim.run(until=lambda c: _sys_done(c, M), max_epochs=1000, cache_key="done")
    cells = sim.engine.gather_cells(sim.state)
    return A, B, np.asarray(cells.y_buf[R - 1]).T, sim.cycle, jax_state_dict(sim.state)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [1, 4, 16])
def test_grid_engine_matches_jax(K, mode):
    """``GridEngine`` on one granule stops at the JAX ``GridEngine``'s cycle
    with its state and ``Y``; on 2x2 batched granules ``Y`` is the same
    bits (the channels are handshaked, so the tiling moves only the
    cycle)."""
    M, R, C = 8, 6, 6
    A, B, Y_j, cycles_j, state_j = jax_grid(K, M, R, C)
    for batch in (None, {"gr": 2, "gc": 2}):
        eng = TGrid(TSys(m_stream=M), R, C, K=K, batch_axes=batch, device="cpu")
        eng._inplace = mode == "inplace"
        sim = Simulation(eng).reset(0, cell_params=t_cell_params(A, B))
        sim.run(until=lambda c: _sys_done(c, M), max_epochs=1000, cache_key="done")
        Y = eng.gather_cells(sim.state).y_buf[R - 1].T
        assert np.array_equal(Y.view(np.uint32), Y_j.view(np.uint32)), (K, batch)
        if batch is None:
            assert sim.cycle == cycles_j
            assert_same(state_j, sim.state, (K, mode))
    assert np.abs(Y - A.astype(np.float64) @ B).max() < 1e-4


# ---------------------------------------------------------------- host ports
def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("K,cycles", [(1, 120), (8, 160)])
def test_heterogeneous_soc_matches_jax(K, cycles):
    """The SoC of three block types (one with a clock divider), one block a
    granule on three batched granules: the CPU's state equals the JAX
    engine's, and at K = 1 the single netlist's."""
    j_soc, t_soc = _load("heterogeneous_soc"), _load("torch_heterogeneous_soc")
    part = {"cpu": 0, "dram": 1, "adc": 2}
    jnet, jcpu = j_soc.build_soc()
    jsim = jnet.build(engine="graph", mesh=auto_mesh((1,), ("gx",)), partition=part,
                      K=K, batch_axes={"gx": 3})
    want = jsim.reset(jax.random.key(0)).run(cycles=cycles).probe(jcpu)
    got, eng = t_soc.run_distributed(K=K, cycles=cycles, device="cpu")
    assert len(eng.classes) == 2
    for name in ("pc", "acc", "results", "n_done", "waiting"):
        assert np.array_equal(np.asarray(getattr(want, name)),
                              getattr(got, name).numpy()), (K, name)
    assert int(got.n_done) == t_soc.N_REQ
    if K == 1:
        single = t_soc.run_single(cycles, device="cpu")
        assert torch.equal(single.results, got.results)


def test_pipestage_chain_host_io_matches_jax():
    """A six-stage ``PipeStage`` chain on three granules (K = 2), packets
    sent at several boundaries through ``sim.tx`` and drained through
    ``sim.rx``: the same packets and the same final state as JAX."""
    part = [0, 0, 1, 1, 2, 2]
    jsim = j_chain(6, capacity=4).build(engine="graph", mesh=auto_mesh((1,), ("g",)),
                                        partition=part, K=2, batch_axes={"g": 3})
    tsim = make_chain(6, capacity=4).build(engine="graph", partition=part, K=2,
                                           batch_axes={"g": 3}, device="cpu")
    jsim.reset(jax.random.key(0))
    tsim.reset(0)
    got_j, got_t = [], []
    for k in range(6):
        pays = np.stack([np.arange(5) + 10.0 * k, np.arange(5)], 1).astype(np.float32)
        for sim in (jsim, tsim):
            sim.tx("tx").send_many(pays)
            sim.run(cycles=6)
        got_j.append(np.asarray(jsim.rx("rx").drain()))
        got_t.append(tsim.rx("rx").drain())
        assert np.array_equal(got_j[-1], got_t[-1]), k
    jsim.run(cycles=40)
    tsim.run(cycles=40)
    assert np.array_equal(np.asarray(jsim.rx("rx").drain()), tsim.rx("rx").drain())
    assert_same(jax_state_dict(jsim.state), tsim.state, "chain")
    assert sum(len(x) for x in got_t) > 0 and tsim.tx("tx").pending == 0
    assert isinstance(tsim.engine.graph.groups[0].block, PipeStage)
    with pytest.warns(DeprecationWarning):
        st, ok = tsim.engine.push_external(tsim.state, "tx", [1.0, 0.0])
    assert bool(ok)
    with pytest.warns(DeprecationWarning):
        _, front, valid = tsim.engine.pop_external(st, "rx")


# -------------------------------------------------- in-place queue operations
def _queues(n, cap, W, seed):
    g = torch.Generator().manual_seed(seed)
    return qmod.QueueArray(
        buf=torch.randn((n, cap, W), generator=g),
        head=torch.randint(0, cap, (n,), generator=g, dtype=torch.int32),
        tail=torch.randint(0, cap, (n,), generator=g, dtype=torch.int32),
        capacity=cap,
    )


def _clone(q):
    return q.replace(buf=q.buf.clone(), head=q.head.clone(), tail=q.tail.clone())


def _same_queues(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("buf", "head", "tail"))


@pytest.mark.parametrize("seed", range(3))
def test_inplace_queue_ops_match_functional(seed):
    """``cycle_``, ``stage_drain_`` and ``stage_fill_`` write the bits the
    functional forms return into the queue's own tensors, with padding
    indices repeated on scratch row 0 (limit and count 0)."""
    n, cap, W = 40, 6, 3
    g = torch.Generator().manual_seed(100 + seed)
    q = _queues(n, cap, W, seed)
    pay = torch.randn((n, W), generator=g)
    pv, pr = (torch.rand(n, generator=g) < 0.5 for _ in range(2))
    want, dp, dq = qmod.cycle(q, pay, pv, pr)
    got = _clone(q)
    ptrs = [got.buf.data_ptr(), got.head.data_ptr(), got.tail.data_ptr()]
    out, dp2, dq2 = qmod.cycle_(got, pay, pv, pr)
    assert _same_queues(want, out) and torch.equal(dp, dp2) and torch.equal(dq, dq2)
    assert [out.buf.data_ptr(), out.head.data_ptr(), out.tail.data_ptr()] == ptrs

    idx = torch.tensor([5, 0, 9, 0, 17, 0, 30], dtype=torch.int32)
    limit = torch.tensor([3, 0, 1, 0, 5, 0, 2], dtype=torch.int32)
    want, slab, cnt = qmod.stage_drain(q, idx, cap - 1, limit=limit)
    got, slab2, cnt2 = qmod.stage_drain_(_clone(q), idx, cap - 1, limit=limit)
    assert _same_queues(want, got) and torch.equal(slab, slab2) and torch.equal(cnt, cnt2)

    payloads = torch.randn((len(idx), cap - 1, W), generator=g)
    count = torch.where(limit > 0, limit, 0)
    want = qmod.stage_fill(q, idx, payloads, count)
    got = qmod.stage_fill_(_clone(q), idx, payloads, count)
    assert _same_queues(want, got)
