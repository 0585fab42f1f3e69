"""The port's procs engine (``build(engine="procs")``: one free-running
worker process a granule, shared-memory rings between them) on the CPU,
the scenarios of ``tests/test_runtime.py``, each against the JAX package's
single netlist:

  * host I/O: the random send/drain script cycle-accurate at K = 1 and
    capacity 2, the packet sequence after quiescence at any K, and a
    4-worker chain whose ports home off worker 0;
  * the interactive checkpoint, and its resume in a fresh fleet;
  * the systolic scenario (reset / run(cycles) / save / probe /
    run(until) / load into a fresh fleet);
  * the 4x4 wafer allreduce on 4 workers;
  * prebuild dedup (1 signature on the column-pair torus, 3 on the chain);
  * SIGKILL of one worker raises ``WorkerDiedError`` fast;
  * the ``stats()`` port schema and worker rows; stale handles; the
    knobs (multi-host and telemetry run, the rest refused).

Workers run with ``device="cpu"`` (one intra-op thread each).  Tolerance:
bit-exact for every packet, count, cycle and result.
"""
import json
import os
import signal
import time

import numpy as np
import pytest

from repro.core.graph import ChannelGraph as JChannelGraph
from repro.hw.manycore import ManycoreCell as JManycoreCell
from repro.hw.manycore import make_core_params as j_core_params
from repro.hw.pipestage import make_chain as j_chain
from repro.hw.systolic import make_systolic_network as j_systolic
from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
from repro_torch.hw.manycore import (
    ManycoreCell, allreduce_done, expected_total, make_core_params,
)
from repro_torch.hw.pipestage import make_chain
from repro_torch.hw.systolic import make_systolic_network
from repro_torch.obs import schema
from repro_torch.runtime import ProcsEngine, WorkerDiedError
from repro_torch.runtime.fault_tolerance import ProcessMonitor

from test_torch_session_surface import _interactive, io_script

TIMEOUT = 60.0  # generous: the test workers timeshare the box's cores


@pytest.fixture
def closing():
    """Close every fleet the test opened (workers die with the launcher
    either way — the atexit sweep — but tests should not leak)."""
    engines = []
    yield engines.append
    for eng in engines:
        eng.close()


def procs(net, closing, **kw):
    kw.setdefault("timeout", TIMEOUT)
    sim = net.build(engine="procs", device="cpu", **kw)
    closing(sim.engine)
    return sim


def reference(net):
    """The JAX package's single netlist as a session."""
    return net.build()


# -------------------------------------------------- session bit-exactness
def test_procs_io_parity_cycle_accurate(closing):
    """K = 1 / capacity 2: per-boundary traffic of the random send/drain
    script is bit-identical to the JAX single netlist's."""
    ref = reference(j_chain(3, capacity=2))
    ref.reset(0)
    want = io_script(ref, n_steps=12)
    sim = procs(make_chain(3, capacity=2), closing, n_workers=2,
                partition=[0, 0, 1], K=1)
    sim.reset(0)
    got = io_script(sim, n_steps=12)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")
    assert sum(len(t) for t in want) > 3  # something actually flowed


def test_procs_io_parity_quiescent_any_k(closing):
    """K = 3: boundary timing shifts but the drained packet sequence is
    identical after quiescence."""
    payloads = [[float(10 * j + 1), float(j)] for j in range(7)]

    def run_one(sim):
        sim.reset(0)
        sim.tx("tx").send_many(payloads)
        got = []
        for _ in range(20):
            sim.run(cycles=15)
            got.extend(np.asarray(sim.rx("rx").drain()))
            if len(got) == len(payloads) and sim.tx("tx").pending == 0:
                break
        assert sim.tx("tx").pending == 0
        return np.asarray(got)

    want = run_one(reference(j_chain(3)))
    got = run_one(procs(make_chain(3), closing, n_workers=3, partition=[0, 1, 2], K=3))
    np.testing.assert_array_equal(want, got)
    assert len(want) == 7


def test_procs_multiworker_nonzero_home(closing):
    """4 workers with the chain reversed over granules: ext-in homes on
    worker 3, ext-out on worker 1 — host I/O routes to the owning
    worker's rings and stays bit-identical to the single netlist."""
    ref = reference(j_chain(4, capacity=2))
    ref.reset(0)
    want = io_script(ref, n_steps=10)
    part = {"s0": 3, "s1": 2, "s2": 2, "s3": 1}
    sim = procs(make_chain(4, capacity=2), closing, n_workers=4, partition=part, K=1)
    g = sim.engine.graph
    assert sim.engine._chan_owner[g.ext_in["tx"]] == 3
    assert sim.engine._chan_owner[g.ext_out["rx"]] == 1
    sim.reset(0)
    got = io_script(sim, n_steps=10)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")


def test_procs_interactive_checkpoint_resume(closing, tmp_path):
    """Feed, mid-run checkpoint, resume in a FRESH fleet, drain: the
    resumed traffic equals the uninterrupted run's and the JAX single
    netlist's."""
    ck = str(tmp_path / "ck")
    kw = dict(n_workers=3, partition=[0, 1, 2], K=2)
    out_full, counts_full, cyc_full = _interactive(
        procs(make_chain(3, capacity=4), closing, **kw), ckpt_dir=ck)
    out_res, counts_res, cyc_res = _interactive(
        procs(make_chain(3, capacity=4), closing, **kw), resume_from=ck)
    np.testing.assert_array_equal(out_full, out_res)
    assert counts_full == counts_res == [5, 5, 5]
    assert cyc_full == cyc_res
    np.testing.assert_array_equal(np.sort(out_full[:, 0]), [13.0, 23.0, 33.0, 43.0, 53.0])
    ref_out, ref_counts, ref_cyc = _interactive(reference(j_chain(3, capacity=4)))
    np.testing.assert_array_equal(ref_out, out_full)
    assert ref_counts == counts_full and ref_cyc == cyc_full


def test_procs_systolic_scenario(closing, tmp_path):
    """reset / run(cycles=12) / save / probe / run(until) on a 4-worker
    fleet, then load into a fresh fleet and resume: Y bit-identical to the
    JAX single netlist's each time."""
    rng = np.random.RandomState(3)
    M, K, N = 6, 4, 4
    A = rng.randn(M, K).astype(np.float32)
    B = rng.randn(K, N).astype(np.float32)

    def result_of(sim):
        cols = [sim.probe((K - 1) * N + c) for c in range(N)]
        return np.stack([np.asarray(c.y_buf) for c in cols], axis=1)

    done = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                      | (s.block_states[0].y_idx >= M)).all()
    ref = reference(j_systolic(A, B)[0])
    ref.reset(0)
    ref.run(until=done, max_epochs=100_000, cache_key="d")
    want = result_of(ref)

    part = (np.arange(K * N) % 4).tolist()  # round-robin: heavy cross-talk
    sim = procs(make_systolic_network(A, B)[0], closing, n_workers=4,
                partition=part, K=4)
    sim.reset(0)
    sim.run(cycles=12)
    ck = str(tmp_path / "sys")
    sim.save(ck)
    assert int(sim.probe(0).a_idx) > 0  # the stream has started
    sim.run(until=done, max_epochs=100_000)
    got = result_of(sim)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    np.testing.assert_allclose(got, A @ B, rtol=1e-4)

    sim2 = procs(make_systolic_network(A, B)[0], closing, n_workers=4,
                 partition=part, K=4)
    sim2.reset(0)
    sim2.load(ck)
    assert sim2.cycle == 12
    sim2.run(until=done, max_epochs=100_000)
    assert result_of(sim2).view(np.uint32).tolist() == want.view(np.uint32).tolist()


# ------------------------------------------------- wafer smoke (4 workers)
def test_procs_wafer_smoke(closing):
    """4-worker manycore torus allreduce: every core's total is the global
    sum (every packet crossed every shared-memory boundary)."""
    R = C = 4
    values = (np.arange(R * C, dtype=np.int64) % 7 + 1).astype(np.float32)
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C,
                               params=make_core_params(values.reshape(R, C)),
                               capacity=4)
    eng = ProcsEngine(graph, tiered_grid_partition(R, C, [(2, 2)]), n_workers=4,
                      K=2, timeout=TIMEOUT, device="cpu")
    closing(eng)
    sim = Simulation(eng)
    sim.reset(0)
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    sim.run(until=done, max_epochs=2000)
    totals = np.asarray(eng.gather_group(sim.state, 0).total)
    assert np.array_equal(totals, np.full_like(totals, expected_total(values)))
    assert sim.cycle > 0 and sim.cycle % eng.cycles_per_epoch == 0


# ------------------------------------------------ prebuilt-simulator dedup
def test_prebuilt_cache_dedup(closing):
    """Column pairs of a 2x4 torus on 4 workers share ONE signature, so the
    launcher's prebuild builds one simulator for the fleet; a chain's ends
    differ from its middle (3 signatures)."""
    R, C = 2, 4
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C,
                               params=make_core_params(np.ones((R, C), np.float32)),
                               capacity=4)
    eng = ProcsEngine(graph, [0, 0, 1, 1, 2, 2, 3, 3], n_workers=4, K=2,
                      timeout=TIMEOUT, device="cpu")
    closing(eng)
    assert eng.build_stats["n_workers"] == 4
    assert eng.build_stats["n_signatures"] == 1
    assert len(eng.build_stats["compiled"]) == 1
    assert len(set(eng.signatures)) == 1
    eng2 = procs(make_chain(4, capacity=4), closing, n_workers=4,
                 partition=[0, 1, 2, 3]).engine
    assert eng2.build_stats["n_signatures"] == 3  # head, middle, tail
    assert eng2.signatures[1] == eng2.signatures[2]
    assert not eng.launch_stats and not eng2.launch_stats  # nothing spawned yet


# --------------------------------------------------------- fault tolerance
def test_kill_one_worker_raises_not_hangs(closing):
    """SIGKILL one worker mid-session: the next command raises a
    WorkerDiedError naming the worker and carrying its captured log tail,
    and the whole fleet is torn down — never a hang on a dead peer."""
    sim = procs(make_chain(3, capacity=4), closing, n_workers=3,
                partition=[0, 1, 2], K=1, timeout=20.0)
    sim.reset(0)
    sim.tx("tx").send([1.0, 0.0])
    sim.run(cycles=4)
    os.kill(sim.engine._procs[1].pid, signal.SIGKILL)
    time.sleep(0.3)
    t0 = time.monotonic()
    with pytest.raises(WorkerDiedError) as exc:
        sim.run(cycles=200)
    assert time.monotonic() - t0 < 30.0  # fail fast, not a hang
    assert exc.value.worker == 1
    assert "granule 1" in str(exc.value)  # the worker's own log tail
    assert sim.engine._closed  # peers were torn down with it
    with pytest.raises(RuntimeError, match="closed"):
        sim.run(cycles=1)


def test_silence_clock_starts_at_each_command():
    """The hang check counts a worker's silence from its last beat or the
    last command sent to it, whichever is later: a launcher that paused
    longer than the timeout between two commands does not find its idle
    workers "hung" at the next command's first check; a worker silent for
    the timeout within one command is."""
    class Alive:
        exitcode = None

    mon = ProcessMonitor({0: Alive()}, {0: None}, heartbeat=lambda w: 1.0,
                         hang_timeout_s=0.2)
    mon.check((0,))  # the first beat seen
    time.sleep(0.3)  # the launcher between commands
    mon.arm(0)  # a command goes out
    mon.check((0,))
    time.sleep(0.3)
    with pytest.raises(WorkerDiedError, match="no progress"):
        mon.check((0,))


def test_stats_schema_and_worker_rows(closing):
    """stats()["ports"] carries the same keys and counters as the JAX
    single netlist's; the procs stats add one worker row a granule and
    validate under the port's schema."""
    sims = {"jax": reference(j_chain(3, capacity=4)),
            "procs": procs(make_chain(3, capacity=4), closing, n_workers=2,
                           partition=[0, 1, 1], K=1)}
    stats = {}
    for name, sim in sims.items():
        sim.reset(0)
        sim.tx("tx").send_many([[1.0, 0.0], [2.0, 0.0]])
        sim.rx("rx")
        sim.run(cycles=3)
        stats[name] = sim.stats()
    assert stats["jax"]["ports"] == stats["procs"]["ports"]
    st = stats["procs"]
    schema.validate_stats(st)
    assert st["engine"] == "procs" and st["cycle"] == 3
    rows = st["workers"]
    assert [r["granule"] for r in rows] == [0, 1]
    assert all(r["cycle"] == 3 and r["epoch"] == 3 and r["device"] == "cpu"
               for r in rows)
    assert rows[0]["ports"]["tx"]["is_input"] and rows[1]["ring_ops"] > 0
    assert set(rows[0]) >= {"wait_s", "run_s", "wait_fraction", "capture_s", "signature"}


def test_stale_handle_and_reuse_errors(closing):
    """A pre-reset ProcsState handle fails loudly, unknown ports raise the
    session's KeyError, and a closed engine reopens on the same lowering."""
    sim = procs(make_chain(3), closing, n_workers=2, partition=[0, 1, 1], K=1)
    sim.reset(0)
    stale = sim.state
    sim.reset(0)
    with pytest.raises(RuntimeError, match="stale ProcsState"):
        sim.engine.run_epochs(stale, 1)
    with pytest.raises(KeyError, match="external-in"):
        sim.tx("nope")
    with pytest.raises(TypeError, match="ProcsState"):
        sim.engine.run_epochs(object(), 1)
    sim.engine._reopen()
    sim.reset(0)
    sim.tx("tx").send([5.0, 0.0])
    sim.run(cycles=6)
    assert sim.rx("rx").recv()[0] == 8.0


def test_trace_and_spawn_start(closing, tmp_path, monkeypatch):
    """``sim.trace`` records the session's epoch windows on a fleet, with
    no telemetry hook on the engine; ``REPRO_WORKER_SPAWN=spawn`` starts
    each worker afresh, with the same traffic as the forkserver's."""
    got = {}
    for method in ("forkserver", "spawn"):
        monkeypatch.setenv("REPRO_WORKER_SPAWN", method)
        sim = procs(make_chain(3, capacity=4), closing, n_workers=3,
                    partition=[0, 1, 2], K=2)
        assert sim.engine._ctx.get_start_method() == method
        sim.reset(0).tx("tx").send_many([[1.0, 0.0], [2.0, 0.0]])
        path = str(tmp_path / f"{method}.json")
        with sim.trace(path):
            sim.run(cycles=8)
        got[method] = sim.rx("rx").drain()
        with open(path) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e.get("name") == "epoch_window"]
        assert spans and spans[-1]["args"] == {"epochs": 4}
    np.testing.assert_array_equal(got["forkserver"], got["spawn"])
    assert len(got["spawn"]) == 2


def test_refused_knobs_name_their_items(monkeypatch):
    """Every reference knob runs or is refused with a ``ValueError`` that
    names it, before any lowering; none is accepted and ignored.  The
    multi-host knobs (``hosts``, ``REPRO_HOSTS``, ``base_port``,
    ``REPRO_BRIDGE_PORT``) and worker telemetry (``set_tracing``,
    ``flush_telemetry``) run; ``host`` without a plan, ``cache_dir`` and a
    shallow ``ring_depth`` are refused."""
    from test_torch_fleet_plans import _free_port

    net = make_chain(2)

    def runs(**kw):
        eng = net.build(engine="procs", device="cpu", session=False, timeout=TIMEOUT, **kw)
        try:
            sim = Simulation(eng).reset(0)
            sim.tx("tx").send([1.0, 0.0])
            sim.run(cycles=4)
            assert sim.rx("rx").drain().shape == (1, 2)
            return eng.host_plan, eng._base_port
        finally:
            eng.close()

    monkeypatch.delenv("REPRO_HOSTS", raising=False)
    monkeypatch.delenv("REPRO_BRIDGE_PORT", raising=False)
    plan, _ = runs(n_workers=2, hosts=2)
    assert plan.hosts == ("h0", "h1")
    port = _free_port()
    assert runs(n_workers=2, hosts=2, base_port=port)[1] == port
    with monkeypatch.context() as m:
        env_port = _free_port()
        m.setenv("REPRO_HOSTS", "2")
        m.setenv("REPRO_BRIDGE_PORT", str(env_port))
        plan, base = runs(n_workers=2)
        assert plan.n_hosts == 2 and base == env_port
    with pytest.raises(ValueError, match="host= names a fleet member"):
        net.build(engine="procs", device="cpu", host="a")
    with pytest.raises(ValueError, match="cache"):
        net.build(engine="procs", device="cpu", cache_dir="/tmp/x")
    with pytest.raises(ValueError, match="ring_depth"):
        net.build(engine="procs", device="cpu", ring_depth=1)
    eng = net.build(engine="procs", device="cpu", session=False, timeout=TIMEOUT)
    try:
        assert eng.set_tracing(True) is True  # remembered before launch
        sim = Simulation(eng).reset(0)
        sim.tx("tx").send([1.0, 0.0])
        sim.run(cycles=4)
        eng.flush_telemetry()
        assert eng.set_tracing(False) is False
        assert all(r["telem_dropped"] == 0 for r in eng.worker_stats())
    finally:
        eng.close()


def test_wafer_partition_matches_jax_lowering():
    """The launcher's per-granule specs (tables, tiers, ext ports,
    signatures) equal the JAX launcher's on a tiered wafer — the lowering
    both fleets start from (no processes)."""
    from repro.core.graph import PartitionTree as JPT, Tier as JTier
    from repro.runtime.launcher import ProcsEngine as JProcs
    from repro_torch.core.graph import PartitionTree, Tier

    R = C = 8
    vals = np.ones((R, C), np.float32)
    part = tiered_grid_partition(R, C, [(2, 1), (2, 1)])
    jt = JPT(part, (JTier(axes=("pod",), K=2), JTier(axes=("g",), K=4)), {"pod": 2, "g": 2})
    tt = PartitionTree(part, (Tier(axes=("pod",), K=2), Tier(axes=("g",), K=4)),
                       {"pod": 2, "g": 2})
    jeng = JProcs(JChannelGraph.torus(JManycoreCell(R, C), R, C,
                                      params=j_core_params(vals), capacity=4),
                  jt, prebuild=False)
    teng = ProcsEngine(ChannelGraph.torus(ManycoreCell(R, C), R, C,
                                          params=make_core_params(vals), capacity=4),
                       tt, prebuild=False, device="cpu")
    try:
        # the hashes name each package's classes; which granules share
        # one must agree
        shared = lambda sigs: [sigs.index(x) for x in sigs]  # noqa: E731
        assert shared(teng.signatures) == shared(jeng.signatures)
        for js, ts in zip(jeng._specs, teng._specs):
            assert (js.granule, js.n_local, js.capacity) == (ts.granule, ts.n_local, ts.capacity)
            for jg, tg in zip(js.groups, ts.groups):
                for f in ("member_of", "active", "rx_idx", "tx_idx"):
                    np.testing.assert_array_equal(getattr(jg, f), getattr(tg, f))
            for jtier, ttier in zip(js.tiers, ts.tiers):
                assert (jtier.K, jtier.E, jtier.egress_chans, jtier.ingress_chans) == (
                    ttier.K, ttier.E, ttier.egress_chans, ttier.ingress_chans)
                np.testing.assert_array_equal(jtier.egress_lqids, ttier.egress_lqids)
                np.testing.assert_array_equal(jtier.ingress_lqids, ttier.ingress_lqids)
            assert js.ext_ports == ts.ext_ports
    finally:
        jeng.close()
        teng.close()
