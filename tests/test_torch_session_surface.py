"""The rest of the port's session surface against the JAX session:
monitors, ``stats()`` through ``obs.schema``, ``trace``, ``save``/``load``
with ``checkpoint.checkpointing``, the legacy shims, ``obs.report`` and
``core.perfmodel``.

The same networks, seeds and host scripts go through ``repro.core``'s
``Simulation`` (reference meshes with Auto axes, ROADMAP R1) and the
port's on the CPU (each kernel's plain version): the Increment chain and
the 6x4 @ 4x4 systolic network of ``tests/test_session.py``.  Tolerance:
bit-exact for every traffic, count, cycle, sample and result; ``==`` for
``perfmodel`` (the same arithmetic) and ``report`` (the same text).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import Network as JNetwork
from repro.core import perfmodel as j_perf
from repro.hw.systolic import make_systolic_network as j_systolic
from repro.obs import report as j_report
from repro_torch.checkpoint import checkpointing
from repro_torch.core import DonatedStateError, Network, Simulation
from repro_torch.core import perfmodel as t_perf
from repro_torch.core.struct import tree_paths
from repro_torch.hw.systolic import make_systolic_network as t_systolic
from repro_torch.obs import report as t_report
from repro_torch.obs import schema as t_schema
from repro_torch.obs import trace as t_trace

from test_torch_graph import auto_mesh
from test_torch_network import JIncrement, TIncrement, chain

ENGINES = ("single", "graph", "fused")


# ----------------------------------------------------------------- builders
def jax_chain(engine, capacity=4, K=2, n=3):
    net = chain(JNetwork, JIncrement(), n, capacity)
    if engine == "single":
        return net.build()
    return net.build(engine=engine, mesh=auto_mesh((1,), ("gx",)), K=K)


def port_chain(engine, capacity=4, K=2, n=3):
    net = chain(Network, TIncrement(), n, capacity)
    if engine == "single":
        return net.build(device="cpu")
    return net.build(engine=engine, device="cpu", K=K)


def _chains(engine, **kw):
    return {"jax": jax_chain(engine, **kw), "port": port_chain(engine, **kw)}


def _counts(sim, n=3):
    return [int(np.asarray(sim.probe(i).count)) for i in range(n)]


def _interactive(sim, ckpt_dir=None, resume_from=None):
    """``tests/test_session.py``'s scripted scenario: feed packets, advance,
    checkpoint mid-run (or resume from one), feed more, drain."""
    sim.reset(0)
    if resume_from is None:
        sim.tx("tx").send_many([[v, 0.0] for v in (10.0, 20.0, 30.0)])
        sim.run(cycles=8)
        if ckpt_dir is not None:
            sim.save(ckpt_dir)
    else:
        sim.load(resume_from)
    sim.tx("tx").send_many([[v, 1.0] for v in (40.0, 50.0)])
    out = []
    for _ in range(5):
        sim.run(cycles=10)
        out.extend(np.asarray(sim.rx("rx").drain()))
    return np.asarray(out), _counts(sim), sim.cycle


def io_script(sim, n_steps=12, seed=0):
    """Pseudo-random host sends and drains, one boundary at a time."""
    rng = np.random.RandomState(seed)
    tx, rx = sim.tx("tx"), sim.rx("rx")
    trace = []
    for step in range(n_steps):
        k = int(rng.randint(0, 3))
        if k:
            tx.send_many([[100.0 * step + j, float(step)] for j in range(k)])
        sim.run(cycles=sim.period)
        trace.append(np.asarray(rx.drain()))
    sim.run(cycles=16 * sim.period)
    trace.append(np.asarray(rx.drain()))
    return trace


# ------------------------------------------ interactive checkpoint / resume
@pytest.mark.parametrize("engine", ENGINES)
def test_interactive_checkpoint_resume(engine, tmp_path):
    """Host feeds packets, checkpoints mid-run, resumes in a fresh
    session: the port's traffic, counts and cycle equal the JAX session's,
    and the resumed run equals the uninterrupted one."""
    got = {}
    for pkg, sim in _chains(engine).items():
        ckpt = str(tmp_path / pkg)
        got[pkg] = _interactive(sim, ckpt_dir=ckpt)
    out, counts, cyc = got["port"]
    np.testing.assert_array_equal(out, got["jax"][0])
    assert counts == got["jax"][1] == [5, 5, 5]
    assert cyc == got["jax"][2]
    np.testing.assert_array_equal(np.sort(out[:, 0]), [13.0, 23.0, 33.0, 43.0, 53.0])
    res = _interactive(port_chain(engine), resume_from=str(tmp_path / "port"))
    np.testing.assert_array_equal(res[0], out)
    assert res[1:] == (counts, cyc)


def test_scenario_all_four_engines(tmp_path):
    """The systolic network through reset / run(cycles=12) / probe / save /
    run(until) / a fresh session's load and resume on all four engines of
    both packages: every result equal to the single engine's, across the
    packages and across resume."""
    rng = np.random.RandomState(3)
    M, K, N = 6, 4, 4
    A = rng.randn(M, K).astype(np.float32)
    B = rng.randn(K, N).astype(np.float32)

    def build(pkg, engine):
        if pkg == "jax":
            net, _ = j_systolic(A, B)
            if engine == "single":
                return net.build()
            names = ("gr", "gc") if engine == "register" else ("gx",)
            return net.build(engine=engine, mesh=auto_mesh((1,) * len(names), names), K=4)
        net, _ = t_systolic(A, B)
        return net.build(device="cpu") if engine == "single" else net.build(
            engine=engine, device="cpu", K=4)

    def done_for(sim):
        if sim.kind == "register":
            return lambda cell: ((~cell["is_south"]) | (cell["y_idx"] >= M)).all()
        return lambda s: ((~s.block_states[0].is_south)
                          | (s.block_states[0].y_idx >= M)).all()

    def result_of(sim):
        if sim.kind == "register":
            return np.asarray(sim.engine.result(sim.state))
        cols = [sim.probe((K - 1) * N + c) for c in range(N)]
        return np.stack([np.asarray(c.y_buf) for c in cols], axis=1)

    results, resumed, cycles = {}, {}, {}
    for pkg in ("jax", "port"):
        for engine in ("single", "graph", "fused", "register"):
            sim = build(pkg, engine)
            sim.reset(0)
            sim.run(cycles=12)
            ckpt = str(tmp_path / f"{pkg}_{engine}")
            sim.save(ckpt)
            mid = sim.probe(0)
            assert int(np.asarray(mid["a_idx"] if isinstance(mid, dict) else mid.a_idx)) > 0
            sim.run(until=done_for(sim), max_epochs=100_000, cache_key="done")
            results[pkg, engine], cycles[pkg, engine] = result_of(sim), sim.cycle

            sim2 = build(pkg, engine)
            sim2.reset(0)
            sim2.load(ckpt)
            assert sim2.cycle == 12
            sim2.run(until=done_for(sim2), max_epochs=100_000, cache_key="done")
            resumed[pkg, engine] = result_of(sim2)
            assert sim2.cycle == sim.cycle
    for key, got in results.items():
        np.testing.assert_array_equal(results["jax", "single"], got, err_msg=str(key))
        np.testing.assert_array_equal(resumed[key], got, err_msg=f"{key} resume")
        assert cycles[key] == cycles["jax", key[1]], key
    np.testing.assert_allclose(results["port", "single"], A @ B, rtol=1e-4)


# --------------------------------------------------------- monitors, stats
def _monitor_samples(sim):
    sim.reset(0)
    sim.tx("tx").send([1.0, 0.0])
    seen = []
    mon = sim.add_monitor(lambda s: seen.append(s.cycle), every=2)
    sim.run(cycles=12)
    samples = mon.samples
    st = sim.stats()
    mon.remove()
    sim.run(cycles=4)
    return seen, samples, st


def test_monitors_and_stats():
    """Monitor samples (cadence 2, then removed) list-equal to JAX's; the
    gcd cadence of two monitors; the stats."""
    got = {pkg: _monitor_samples(sim) for pkg, sim in _chains("graph").items()}
    assert got["port"][:2] == got["jax"][:2] == ([4, 8, 12], 3)
    st = got["port"][2]
    assert st["cycle"] == 12 and st["engine"] == "graph"
    assert st["ports"]["tx"]["tx"] == {k: got["jax"][2]["ports"]["tx"]["tx"][k]
                                       for k in ("sent", "pending", "occupancy", "credit")}
    assert st["metrics"]["session.tx.sent"] == 1.0
    assert st["metrics"]["session.monitor.fired"] >= 3

    seen = {}
    for pkg, sim in _chains("graph", K=1).items():
        sim.reset(0)
        twos, threes = [], []
        sim.add_monitor(lambda s: twos.append(s.epoch), every=2)
        sim.add_monitor(lambda s: threes.append(s.epoch), every=3)
        sim.run(epochs=12)
        seen[pkg] = (twos, threes)
    assert seen["port"] == seen["jax"] == ([2, 4, 6, 8, 10, 12], [3, 6, 9, 12])


@pytest.mark.parametrize("engine", ENGINES)
def test_monitor_cadence_survives_chunked_runs(engine):
    """Cadence counts on the global boundary index: ten run(epochs=1)
    calls sample like one run(epochs=10), in both packages."""
    seen = {}
    for pkg, sim in _chains(engine, K=1).items():
        for slices in ((1,) * 10, (3, 7), (10,)):
            sim.reset(0)
            got = []
            sim.add_monitor(lambda s, got=got: got.append(s.epoch), every=2)
            for n in slices:
                sim.run(epochs=n)
            seen[pkg, slices] = got
            sim._monitors.clear()
    assert all(v == [2, 4, 6, 8, 10] for v in seen.values()), seen


def _state_leaves(sim):
    return {p: np.asarray(x) for p, x in tree_paths(sim.state)
            if isinstance(x, torch.Tensor)}


@pytest.mark.parametrize("engine", ENGINES)
def test_until_stop_point_invariant_to_monitors(engine):
    """An attached monitor moves neither the stop cycle nor the state of
    ``run(until=...)``, at budgets that cut the run (0, 1, 3) and one that
    does not, with a monitor every 1, 2 and 4 epochs; the stop cycle is
    the JAX session's, and so are the samples."""
    pred_j = lambda s: (s.block_states[0].count >= 1).all()  # noqa: E731
    pred_t = lambda s: (s.block_states[0].count >= 1).all()  # noqa: E731

    def run_one(sim, pred, budget, every):
        sim.reset(0)
        seen = []
        if every:
            sim.add_monitor(lambda s: seen.append(s.cycle), every=every)
        sim.tx("tx").send([1.0, 0.0])
        sim.run(cycles=sim.period)  # a first boundary: the send lands
        sim.run(until=pred, max_epochs=budget, cache_key=("c1", budget))
        return sim.cycle, seen

    for budget in (0, 1, 3, 50):
        ref_cycle, _ = run_one(jax_chain(engine, K=1), pred_j, budget, 0)
        base = port_chain(engine, K=1)
        base_cycle, _ = run_one(base, pred_t, budget, 0)
        assert base_cycle == ref_cycle, budget
        want = _state_leaves(base)
        for every in (1, 2, 4):
            sim = port_chain(engine, K=1)
            cyc, seen = run_one(sim, pred_t, budget, every)
            assert cyc == ref_cycle, (budget, every)
            got = _state_leaves(sim)
            assert got.keys() == want.keys()
            for p in want:
                np.testing.assert_array_equal(got[p], want[p], err_msg=f"{budget} {every} {p}")
            _, jseen = run_one(jax_chain(engine, K=1), pred_j, budget, every)
            assert seen == jseen, (budget, every)
    assert ref_cycle < 51  # the predicate, not the budget, stopped the last run


# ----------------------------------------------------- shims, donation guard
def test_donated_state_guard_and_run_cycles_shim():
    """Legacy state threading through the facade: a donated input raises
    ``DonatedStateError`` on reuse, ``donate=False`` keeps it, and the
    cycles are JAX's."""
    for pkg, sim in _chains("graph").items():
        key = jax.random.key(0) if pkg == "jax" else 0
        with pytest.warns(DeprecationWarning):
            st = sim.init(key)
            st2 = sim.run_epochs(st, 3)
        with pytest.raises(Exception, match="donated to run_epochs"):
            np.asarray(st.cycle)
        with pytest.raises(Exception, match="pass donate=False"):
            st.queues.buf
        with pytest.warns(DeprecationWarning):
            st3 = sim.run_epochs(st2, 2, donate=False)
        assert int(np.asarray(st2.cycle).ravel()[0]) == 6
        assert int(np.asarray(st3.cycle).ravel()[0]) == 10
        with pytest.warns(DeprecationWarning):
            st4 = sim.run_cycles(st3, 5)  # rounds up to 3 epochs = 6 cycles
        assert int(np.asarray(st4.cycle).ravel()[0]) == 16
        with pytest.raises(Exception, match="donated to run_cycles"):
            np.asarray(st3.cycle)
    with pytest.raises(DonatedStateError):
        st3.cycle.reshape(-1)


def test_legacy_shims_still_work():
    """init / push_external / run(state, n) / pop_external through the
    facade, with DeprecationWarnings; attribute delegation to the engine;
    the register engine's run_until / run_until_done shims."""
    got = {}
    for pkg, sim in _chains("single").items():
        with pytest.warns(DeprecationWarning):
            st = sim.init(jax.random.key(0) if pkg == "jax" else 0)
            st, ok = sim.push_external(st, "tx", np.array([5.0, 0.0], np.float32))
            assert bool(ok)
            st = sim.run(st, 8)
            st, pay, valid = sim.pop_external(st, "rx")
        assert bool(valid)
        got[pkg] = float(np.asarray(pay)[0])
        assert sim.graph.n_channels == 6
        assert sim.engine.engine_kind == "single"
    assert got["port"] == got["jax"] == 8.0

    A = np.arange(12, dtype=np.float32).reshape(3, 4)
    B = np.ones((4, 2), np.float32)
    sim = t_systolic(A, B)[0].build(engine="register", device="cpu", K=2)
    with pytest.warns(DeprecationWarning):
        st = sim.init()
        st2 = sim.run_until(st, sim.engine.y_done, 2)
        st3 = sim.run_until_done(st2, 1000)
    with pytest.raises(DonatedStateError, match="run_until"):
        st.cell["y_idx"]
    with pytest.raises(DonatedStateError, match="run_until_done"):
        st2.cell["y_idx"]
    np.testing.assert_array_equal(sim.engine.result(st3), A @ B)


def test_poison_spares_the_returned_state():
    """A shim poisons its input only where the engine returned another
    object: an engine that hands the input back (as a CUDA until-run
    does) leaves the caller a usable state."""
    sim = port_chain("graph")
    eng = sim.engine
    st = sim.reset(0).state

    class Echo:
        engine_kind = "graph"

        def __getattr__(self, name):
            return getattr(eng, name)

        def run_until(self, state, done_fn, max_epochs, **kw):
            return state

    echo = Simulation(Echo())
    with pytest.warns(DeprecationWarning):
        out = echo.run_until(st, lambda s: True, 5)
    assert out is st and int(out.cycle.reshape(-1)[0]) == 0


def test_session_period_and_errors():
    sim = port_chain("graph", K=2)
    with pytest.raises(ValueError, match="multiple"):
        Simulation(sim.engine, period=3)
    s4 = Simulation(sim.engine, period=4).reset(0)
    seen = []
    s4.add_monitor(lambda s: seen.append(s.cycle), every=1)
    s4.run(cycles=10)  # rounds up to 3 periods of 4 cycles
    assert seen == [4, 8, 12] and s4.cycle == 12
    with pytest.raises(TypeError, match="exactly one"):
        s4.run()
    with pytest.raises(TypeError, match="not both"):
        s4.run(until=lambda s: s.cycle > 0, max_cycles=4, max_epochs=1)


# ------------------------------------------------------------ stats schema
def test_validate_stats_every_engine_and_rejections():
    """``stats()`` of all four engines passes ``repro-stats-v1`` under both
    packages' validators; malformed layouts are refused."""
    from repro.obs import schema as j_schema

    sims = {e: port_chain(e, capacity=2, K=1) for e in ENGINES}
    A, B = np.ones((2, 2), np.float32), np.ones((2, 2), np.float32)
    sims["register"] = t_systolic(A, B)[0].build(engine="register", device="cpu", K=2)
    for name, sim in sims.items():
        sim.reset(0)
        if name != "register":
            sim.tx("tx").send_many([[1.0, 0.0], [2.0, 0.0]])
            sim.rx("rx")
        sim.run(cycles=3)
        st = t_schema.validate_stats(sim.stats())
        j_schema.validate_stats(st)
        assert st["engine"] == name and "metrics" in st
        if name == "single":
            assert set(st["detail"]) == {"push_count", "pop_count"}
    good = {"schema": t_schema.STATS_SCHEMA, "engine": "procs", "cycle": 0, "epoch": 0,
            "ports": {"tx": {"tx": {"sent": 0, "pending": 0, "occupancy": 0, "credit": 0}},
                      "rx": {"rx": {"received": 0, "occupancy": 0, "credit": 0}}}}
    t_schema.validate_stats(good)
    broken_tx = json.loads(json.dumps(good))
    del broken_tx["ports"]["tx"]["tx"]["credit"]
    for bad in (dict(good, engine="warp"), dict(good, bogus=1),
                {k: v for k, v in good.items() if k != "ports"}, broken_tx,
                dict(good, bridges=[{"link": 0}]), dict(good, cycle=1.5), []):
        with pytest.raises(ValueError, match="stats schema"):
            t_schema.validate_stats(bad)


# ------------------------------------------------------------------- trace
@pytest.mark.parametrize("engine", ENGINES)
def test_traced_bit_identical(engine, tmp_path):
    """Traffic with the flight recorder on is bit-identical to the
    untraced run's; the file is a valid trace whose ``epoch_window`` spans
    carry the reference's name, category and args."""
    ref = io_script(port_chain(engine, capacity=2, K=1).reset(0))
    sim = port_chain(engine, capacity=2, K=1).reset(0)
    path = str(tmp_path / "t.json")
    rec = t_trace.recorder()
    rec.clear()
    with sim.trace(path):
        got = io_script(sim)
    assert not rec.enabled
    for step, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    doc = t_schema.validate_trace_file(path)
    spans = [e for e in doc["traceEvents"] if e["name"] == "epoch_window"]
    key = "cycles" if engine == "single" else "epochs"
    assert spans and all(e["cat"] == "session" and key in e["args"] for e in spans)
    assert doc["otherData"]["dropped"] == 0
    assert "epoch_window" in t_report.summarize(doc)
    assert t_schema.main([path]) == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_traced_monitored_until(engine, tmp_path):
    """A traced ``run(until=...)`` with a monitor stops where the untraced
    one does, with the same state and samples, and records the JAX
    session's ``epoch_window`` spans: as many, one epoch each."""
    pred_j = lambda s: (s.block_states[0].count >= 1).all()  # noqa: E731
    pred_t = lambda s: (s.block_states[0].count >= 1).all()  # noqa: E731

    def run_one(sim, pred, path=None):
        sim.reset(0)
        seen = []
        sim.add_monitor(lambda s: seen.append(s.cycle), every=2)
        sim.tx("tx").send([1.0, 0.0])
        sim.run(cycles=sim.period)  # a first boundary: the send lands
        if path is None:
            sim.run(until=pred, max_epochs=50)
            return seen
        with sim.trace(path):
            sim.run(until=pred, max_epochs=50)
        spans = [e for e in t_schema.validate_trace_file(path)["traceEvents"]
                 if e["name"] == "epoch_window"]
        assert spans and all(e["cat"] == "session" for e in spans)
        return seen, [e["args"]["epochs"] for e in spans]

    base = port_chain(engine, K=1)
    base_seen = run_one(base, pred_t)
    t_trace.recorder().clear()
    sim = port_chain(engine, K=1)
    seen, epochs = run_one(sim, pred_t, str(tmp_path / "t.json"))
    assert sim.cycle == base.cycle and seen == base_seen
    want, got = _state_leaves(base), _state_leaves(sim)
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    from repro.obs import trace as j_trace
    j_trace.recorder().clear()
    jsim = jax_chain(engine, K=1)
    jseen, jepochs = run_one(jsim, pred_j, str(tmp_path / "j.json"))
    assert (sim.cycle, seen, epochs) == (jsim.cycle, jseen, jepochs)
    assert epochs == [1] * ((sim.cycle - sim.period) // sim.period) and epochs


def test_trace_recorder_units(tmp_path, monkeypatch):
    rec = t_trace.TraceRecorder(max_events=5)
    rec.span("ignored", 0.0, 1.0)
    assert rec.events == []
    rec.enabled = True
    rec.set_process(0, "host")
    rec.set_track(0, t_trace.TID_SESSION, "session")
    for i in range(9):
        rec.span(f"s{i}", float(i), 0.5)
    with rec.span_ctx("ctx"):
        pass
    rec.instant("mark", args={"k": 1})
    assert len(rec.events) == 5 and rec.dropped == 6
    doc = t_schema.validate_trace_file(rec.export(str(tmp_path / "r.json")))
    assert doc["traceEvents"][2]["ts"] == 0.0 and doc["traceEvents"][2]["dur"] == 0.5e6
    rec.clear()
    assert rec.events == [] and rec.dropped == 0
    for bad in ({"traceEvents": [{"name": "a", "ph": "Z", "ts": 0, "pid": 0, "tid": 0}]},
                {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0}]},
                {"notTraceEvents": []}):
        with pytest.raises(ValueError, match="trace format"):
            t_schema.validate_trace(bad)
    # REPRO_TRACE arms the global recorder once
    monkeypatch.setenv(t_trace.ENV_TRACE, str(tmp_path / "env.json"))
    monkeypatch.setattr(t_trace, "_env_armed", False)
    monkeypatch.setattr(t_trace.recorder(), "enabled", False)
    monkeypatch.setattr(t_trace.atexit, "register", lambda fn: None)
    sim = port_chain("single")
    assert t_trace.recorder().enabled and isinstance(sim, Simulation)


def test_report_summarize_matches_reference():
    doc = {"traceEvents": [
        {"name": "step", "cat": "worker", "ph": "X", "ts": 0.0, "dur": 2e4,
         "pid": 0, "tid": 0},
        {"name": "exchange_commit", "cat": "worker", "ph": "X", "ts": 2e4,
         "dur": 6e4, "pid": 0, "tid": 0},
        {"name": "step", "cat": "worker", "ph": "X", "ts": 0.0, "dur": 1e4,
         "pid": 0, "tid": 1},
        {"name": "recovery_incident", "cat": "recovery", "ph": "i", "s": "p",
         "ts": 5e4, "pid": 0, "tid": t_trace.TID_SESSION,
         "args": {"incarnation": 2}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "worker 0"}},
    ]}
    for top in (2, 10):
        text = t_report.summarize(t_schema.validate_trace(doc), top=top)
        assert text == j_report.summarize(doc, top=top)
    assert "worker 0" in text and "incarnation" in text


# -------------------------------------------------------------- checkpoint
def test_checkpoint_round_trip_gc_and_mismatch(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"f32": torch.randn(3, 4, generator=g),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.tensor([True, False, True]),
            "bf16": torch.randn(5, generator=g).to(torch.bfloat16),
            "nested": (torch.zeros((), dtype=torch.int32), [torch.ones(2)])}
    path = str(tmp_path / "ck")
    for step in range(5):
        checkpointing.save(path, step, tree, meta={"n": np.int64(step)}, keep_last=2)
    assert sorted(os.listdir(path)) == ["step_00000003", "step_00000004"]
    assert checkpointing.latest_step(path) == 4
    out, meta = checkpointing.restore(path, tree)
    assert meta == {"n": 4}
    for (p, a), (q, b) in zip(tree_paths(tree), tree_paths(out)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    with open(os.path.join(path, "step_00000004", "tree.json")) as f:
        spec = json.load(f)
    assert spec["dtypes"][3] == "bfloat16" and spec["paths"][4] == "nested.0"
    # the async save copies on the caller's thread: a later in-place write
    # does not reach the checkpoint
    before = tree["f32"].clone()
    fut = checkpointing.save_async(path, 9, tree)
    tree["f32"].add_(1.0)
    fut.result()
    out9, _ = checkpointing.restore(path, tree, 9)
    assert torch.equal(out9["f32"], before)
    with pytest.raises(ValueError, match="checkpoint has 6 leaves, template 5"):
        checkpointing.restore(path, {k: v for k, v in tree.items() if k != "b"})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpointing.restore(path, dict(tree, f32=torch.zeros(4, 3)))
    with pytest.raises(ValueError, match="tree mismatch at leaf 2"):
        checkpointing.restore(path, {"f32": tree["f32"], "i32": tree["i32"],
                                     "c": tree["b"], "bf16": tree["bf16"],
                                     "nested": tree["nested"]})
    with pytest.raises(FileNotFoundError):
        checkpointing.restore(str(tmp_path / "none"), tree)


def test_reference_checkpoint_is_refused(tmp_path):
    """A checkpoint the JAX package wrote records a treedef, not leaf
    paths: the port's ``restore`` refuses it with a ``ValueError`` that
    names ``convert``, and never loads it by bare leaf order."""
    import jax.numpy as jnp
    from repro.checkpoint import checkpointing as j_checkpointing

    path = str(tmp_path / "ref")
    j_checkpointing.save(path, 0, {"a": jnp.arange(4, dtype=jnp.float32),
                                   "b": jnp.arange(2, dtype=jnp.int32)})
    template = {"a": torch.zeros(4), "b": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="convert"):
        checkpointing.restore(path, template)
    # the port's own checkpoint of the same tree still restores
    checkpointing.save(str(tmp_path / "own"), 0, template)
    out, _ = checkpointing.restore(str(tmp_path / "own"), template)
    assert torch.equal(out["b"], template["b"])


def test_load_refuses_another_engine(tmp_path):
    a = port_chain("graph").reset(0)
    a.save(str(tmp_path / "g"))
    b = port_chain("fused").reset(0)
    with pytest.raises(ValueError):
        b.load(str(tmp_path / "g"))
    single = port_chain("single").reset(0)
    single.tx("tx").send_many([[1.0, 0.0]] * 5)  # 3 land, 2 stay pending
    single.save(str(tmp_path / "s"), step=7)
    fresh = port_chain("single").reset(0).load(str(tmp_path / "s"))
    assert (fresh.tx("tx").sent, fresh.tx("tx").pending) == (3, 2)


# --------------------------------------------------------------- perfmodel
def test_perfmodel_matches_reference():
    """Every function of ``perfmodel`` against the reference's on a grid
    of arguments: the same arithmetic, so ``==``."""
    names = sorted(n for n in dir(j_perf) if callable(getattr(j_perf, n))
                   and getattr(getattr(j_perf, n), "__module__", "") == j_perf.__name__)
    assert names == sorted(n for n in dir(t_perf) if callable(getattr(t_perf, n))
                           and getattr(getattr(t_perf, n), "__module__", "")
                           == t_perf.__name__)
    xs = (0.0, 0.5, 1.0, 3.0, 17.25)
    pos = (0.5, 1.0, 4.0, 62.0)
    cases = {
        "n_meas_ideal": [(n, a, b) for n in xs for a in pos for b in pos],
        "n_meas_actual": [(n, a, b, t, rx, tx) for n in xs for a in pos for b in pos
                          for t in (0.0, 1e-3) for rx in (0, 2) for tx in (1, 3)],
        "max_wall_rate": [(n, t, e) for n in xs for t in pos for e in (0.01, 0.05)],
        "bsp_error_bound": [(k, x, n) for k in (1, 8, 62) for x in (0, 3) for n in xs],
        "tier_periods": [((4, 16),), ((2, 2, 8),), ((62,),), ((),)],
        "tiered_comm_cycles": [((4, 16), (1, 2)), ((2, 2, 8), (0, 1, 3)), ((62,), (5,))],
        "n_meas_actual_tiered": [(n, a, b, (4, 16), (1, 2)) for n in xs for a in pos
                                 for b in pos],
        "bsp_error_bound_tiered": [((4, 16), (1, 2), n) for n in xs],
        "batched_epoch_time": [(b, s, d, p) for b in (1, 4, 64) for s in pos for d in pos
                               for p in (1.0, 1.5)],
        "unbatched_epoch_time": [(b, s, d) for b in (1, 4, 64) for s in pos for d in pos],
        "dispatch_amortization": [(b, s, d, p) for b in (1, 4, 64) for s in pos
                                  for d in pos for p in (1.0, 1.5)],
        "fit_dispatch_overhead": [(u, t, b) for u in (1.0, 8.0) for t in (0.5, 2.0, 9.0)
                                  for b in (2, 8)],
        "batching_crossover": [(s, d, p) for s in pos for d in pos for p in (1.0, 1.5, 9.0)],
        "serial_epoch_time": [(s, c, r) for s in xs for c in xs for r in (0.0, 0.25)],
        "overlapped_epoch_time": [(s, c, r) for s in xs for c in xs for r in (0.0, 0.25)],
        "overlap_fraction": [(s, c) for s in xs for c in xs],
        "overlap_speedup": [(s, c, r) for s in xs for c in xs for r in (0.0, 0.25)],
        "fit_overlap_residual": [(s, c, m) for s in xs for c in xs for m in (0.0, 2.0, 20.0)],
        "dividers_for_rates": [([],), ([1.0, 2.0],), ([2.5, 1.0, 0.5],), ([3.0, 7.0, 1.4],)],
    }
    assert sorted(cases) == names
    for name, args in cases.items():
        for a in args:
            assert getattr(t_perf, name)(*a) == getattr(j_perf, name)(*a), (name, a)
    for bad in ((1.0, 1.0, 1),):
        with pytest.raises(ValueError):
            t_perf.fit_dispatch_overhead(*bad)
    with pytest.raises(ValueError):
        t_perf.tiered_comm_cycles((4, 16), (1,))


def test_quickstart_example():
    """``examples/torch_quickstart.py`` on the CPU: Listing 1/2's packet
    comes back incremented, with the example's own asserts."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main(["--device", "cpu"])
    assert stats["cycle"] == 4 and t_schema.validate_stats(stats) is stats
