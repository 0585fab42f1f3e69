"""The port's multi-host fleet (``runtime/bridge.py``, ``runtime/fleet.py``,
the launcher's fleet half) on the CPU, case for case against
``tests/test_bridge.py``:

  * wire framing units: frames over a real socket, the incremental
    ``FrameReader`` under split feeds, the oversized-frame guard, pickled
    control messages and the flavor check;
  * the verbatim record (``pop_record`` -> wire -> ``push_record``) and a
    byte flipped on the wire tripping the far consumer's crc32;
  * host plans (every input form, env precedence), the deterministic link
    map, the link-fault grammar and its build-time validation;
  * 2-launcher loopback fleets: traffic and ``gather_state`` bit-exact
    against the single-host port fleet with live bridge counters in
    ``stats()["bridges"]``, cycle-accurate I/O at K = 1 / capacity 2
    against the JAX single netlist, systolic save/resume across the
    bridge, and a ``linkkill`` recovery that is bit-identical;

and cross-package cases: frames written by either package's framing
parse in the other's ``FrameReader``; a checked record popped from a
port ring, framed by the port and pushed into a JAX-package ring
verifies at the JAX consumer, and with one flipped byte raises there.
The 2-host fleet against the JAX package's 2-host fleet, the link drills
and ``base_port`` are in ``tests/test_torch_fleet.py``.

Workers run with ``device="cpu"``.  Tolerance: bit-exact.
"""
import os
import socket

import numpy as np
import pytest

from repro.hw.pipestage import make_chain as j_chain
from repro.runtime import bridge as jbridge
from repro.runtime.shmem import RingCorruptionError as JRingCorruptionError
from repro.runtime.shmem import ShmRing as JShmRing
from repro_torch.core.struct import tree_paths
from repro_torch.hw.pipestage import make_chain
from repro_torch.hw.systolic import make_systolic_network
from repro_torch.runtime import RingCorruptionError, ShmRing, parse_fault_plan
from repro_torch.runtime import bridge as tbridge
from repro_torch.runtime.bridge import (
    FLAVOR_CREDIT, FLAVOR_CTL, FLAVOR_SLAB, FrameReader, _FRAME, _MAX_FRAME,
    recv_frame, recv_msg, send_frame, send_msg,
)
from repro_torch.runtime.faultinject import LINK_KINDS, actions_for, split_plan
from repro_torch.runtime.fleet import HostPlan, build_links, resolve_host_plan

from test_torch_session_surface import io_script

TIMEOUT = 60.0  # generous: the test workers AND bridges timeshare the box


@pytest.fixture
def closing():
    sims = []
    yield sims.append
    for sim in sims:
        sim.engine.close()


def procs(net, closing, **kw):
    kw.setdefault("timeout", TIMEOUT)
    sim = net.build(engine="procs", device="cpu", **kw)
    closing(sim)
    return sim


def assert_trees_equal(ref, got):
    want, have = tree_paths(ref), tree_paths(got)
    assert [p for p, _ in want] == [p for p, _ in have]
    for (p, a), (_, b) in zip(want, have):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a, b), p


# ----------------------------------------------------------- wire framing
FRAME_CASES = [
    (FLAVOR_SLAB, 0, 0, b""),
    (FLAVOR_SLAB, 7, 3, b"\x00" * 41),
    (FLAVOR_CREDIT, 255, 2**32 - 1, np.uint32(5).tobytes()),
    (FLAVOR_CTL, 300, 9, bytes(range(256)) * 3),  # gen wraps & 0xFF
]


def test_frame_roundtrip_over_socket():
    """Frames of every shape — empty, odd-sized, gen-wrapped — cross a
    real socket byte-exact."""
    a, b = socket.socketpair()
    reader = FrameReader()
    try:
        for flavor, gen, chan, payload in FRAME_CASES:
            n = send_frame(a, flavor, gen, chan, payload)
            assert n == _FRAME.size + len(payload)
            assert recv_frame(b, reader, 5.0) == (flavor, gen & 0xFF, chan, payload)
    finally:
        a.close()
        b.close()


def test_frame_reader_split_feeds():
    """The incremental parser reassembles frames from arbitrary chunk
    boundaries — single bytes, mid-header splits, coalesced frames."""
    rng = np.random.RandomState(0)
    frames = [(FLAVOR_SLAB, i & 0xFF, i, rng.bytes(int(rng.randint(0, 100))))
              for i in range(40)]
    stream = b"".join(_FRAME.pack(f, g, c, len(p)) + p for f, g, c, p in frames)
    for chunk in (1, 3, 7, len(stream)):
        reader = FrameReader()
        got = []
        for off in range(0, len(stream), chunk):
            reader.feed(stream[off:off + chunk])
            while (f := reader.next_frame()) is not None:
                got.append(f)
        assert got == frames, f"chunk={chunk}"


def test_frame_oversize_rejected():
    reader = FrameReader()
    reader.feed(_FRAME.pack(FLAVOR_SLAB, 0, 0, _MAX_FRAME + 1))
    with pytest.raises(ValueError, match="oversized frame"):
        reader.next_frame()


def test_ctl_msg_roundtrip_and_flavor_check():
    a, b = socket.socketpair()
    reader = FrameReader()
    try:
        send_msg(a, ("run", 4, {"nested": np.arange(3)}))
        got = recv_msg(b, reader, 5.0)
        assert got[0] == "run" and got[1] == 4
        np.testing.assert_array_equal(got[2]["nested"], np.arange(3))
        send_frame(a, FLAVOR_SLAB, 0, 0, b"xx")
        with pytest.raises(ValueError, match="flavor"):
            recv_msg(b, reader, 5.0)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_cross_packages(direction):
    """The wire format is the reference's byte for byte: the same frame
    bytes from either package's ``send_frame``/``send_msg``, and each
    parses in the other's ``FrameReader``."""
    src, dst = (tbridge, jbridge) if direction == "port_to_jax" else (jbridge, tbridge)
    a, b = socket.socketpair()
    try:
        reader = dst.FrameReader()
        for flavor, gen, chan, payload in FRAME_CASES:
            src.send_frame(a, flavor, gen, chan, payload)
            assert dst.recv_frame(b, reader, 5.0) == (flavor, gen & 0xFF, chan, payload)
        src.send_msg(a, {"token": "ab12", "link": 3, "host": "h1"},
                     flavor=src.FLAVOR_HELLO)
        assert dst.recv_msg(b, reader, 5.0, expect=dst.FLAVOR_HELLO) == {
            "token": "ab12", "link": 3, "host": "h1"}
    finally:
        a.close()
        b.close()
    assert src._FRAME.format == dst._FRAME.format and src._MAX_FRAME == dst._MAX_FRAME
    for name in ("FLAVOR_SLAB", "FLAVOR_CREDIT", "FLAVOR_PKT", "FLAVOR_CTL",
                 "FLAVOR_FENCE", "FLAVOR_HELLO"):
        assert getattr(src, name) == getattr(dst, name), name


# ------------------------------------------------ verbatim record bridging
def _ring_pair(tag, cap=4, slot=16, rx_cls=ShmRing):
    pid = os.getpid()
    tx = ShmRing.create(f"t_tbr_{tag}_tx_{pid}", cap, slot, checked=True,
                        label=f"bridge:{tag}:tx")
    rx = rx_cls.create(f"t_tbr_{tag}_rx_{pid}", cap, slot, checked=True,
                       label=f"bridge:{tag}:rx")
    return tx, rx


def test_verbatim_record_survives_bridging():
    """The bridge's data path — pop_record verbatim, frame, push_record
    verbatim — keeps the producer's seq+crc header intact, so the far
    consumer's checked pop verifies the ORIGINAL record."""
    tx, rx = _ring_pair("ok")
    try:
        for i in range(10):  # wraps both rings
            assert tx.push_bytes(bytes([i]) * 16)
            rec = tx.pop_record()
            assert rec is not None and len(rec) == tx.stride
            assert rx.push_record(bytes(rec))
            assert rx.pop_bytes() == bytes([i]) * 16
        assert rx.seq_state() == (10, 10)  # seq timeline carried over
    finally:
        tx.close()
        rx.close()


def test_wire_corruption_detected_at_far_pop():
    """A byte flipped BETWEEN the rings (on the wire) trips the far
    consumer's crc32 — end-to-end detection, not hop-by-hop."""
    tx, rx = _ring_pair("bad")
    try:
        assert tx.push_bytes(b"\x05" * 16)
        rec = bytearray(tx.pop_record())
        rec[8] ^= 0xFF  # first payload byte (after the 8B seq+crc header)
        assert rx.push_record(bytes(rec))
        with pytest.raises(RingCorruptionError, match="crc32") as ei:
            rx.pop_bytes()
        assert ei.value.kind == "crc"
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("flip", [False, True])
def test_checked_record_crosses_into_jax_ring(flip):
    """A checked record popped from a PORT ring, framed by the port's
    ``send_frame`` over a socket, parsed by the JAX package's
    ``FrameReader`` and pushed into a JAX-package ring verifies at the JAX
    consumer; with one byte flipped on the wire it raises there."""
    tx, rx = _ring_pair(f"x{int(flip)}", rx_cls=JShmRing)
    a, b = socket.socketpair()
    try:
        payload = bytes(range(16))
        for i in range(6):
            assert tx.push_bytes(payload)
            rec = tx.pop_record()
            if flip and i == 5:
                rec = bytearray(rec)
                rec[8] ^= 0xFF
                rec = bytes(rec)
            send_frame(a, FLAVOR_SLAB, 1, 7, rec)
            flavor, gen, chan, got = jbridge.recv_frame(b, jbridge.FrameReader(), 5.0)
            assert (flavor, gen, chan, got) == (FLAVOR_SLAB, 1, 7, rec)
            assert rx.push_record(got)
            if flip and i == 5:
                with pytest.raises(JRingCorruptionError, match="crc32"):
                    rx.pop_bytes()
            else:
                assert rx.pop_bytes() == payload
    finally:
        a.close()
        b.close()
        tx.close()
        rx.close()


# --------------------------------------------------- host plans and links
def test_resolve_host_plan_forms(monkeypatch):
    monkeypatch.delenv("REPRO_HOSTS", raising=False)
    assert resolve_host_plan(None, 4) is None
    assert resolve_host_plan(1, 4) is None          # count 1 == single-host
    plan = resolve_host_plan(2, 4)
    assert plan.hosts == ("h0", "h1")
    assert plan.assignment == ("h0", "h0", "h1", "h1")
    assert resolve_host_plan("2", 4) == plan        # digit string
    named = resolve_host_plan("alpha, beta", 4)     # comma list
    assert named.hosts == ("alpha", "beta") and named.leader == "alpha"
    by_dict = resolve_host_plan({"a": [0, 2], "b": [1, 3]}, 4)
    assert by_dict.assignment == ("a", "b", "a", "b")
    assert by_dict.granules_of("a") == (0, 2)
    monkeypatch.setenv("REPRO_HOSTS", "3")
    assert resolve_host_plan(None, 6).n_hosts == 3  # env fallback
    assert resolve_host_plan(2, 6).n_hosts == 2     # explicit arg wins
    with pytest.raises(ValueError, match="not assigned"):
        resolve_host_plan({"a": [0]}, 2)
    with pytest.raises(ValueError, match="hosts but the partition"):
        resolve_host_plan(5, 3)


def test_host_plan_matches_jax(monkeypatch):
    """Every input form resolves to the JAX package's plan."""
    from repro.runtime.fleet import resolve_host_plan as j_resolve

    monkeypatch.delenv("REPRO_HOSTS", raising=False)
    for hosts, n in ((2, 4), ("3", 7), ("a,b", 5), ({"x": [1], "y": [0, 2]}, 3)):
        want, got = j_resolve(hosts, n), resolve_host_plan(hosts, n)
        assert (got.hosts, got.assignment) == (want.hosts, want.assignment)


def test_build_links_deterministic():
    plan = HostPlan(("a", "b", "c"), ("a", "a", "b", "c"))
    chan_hosts = {
        0: ("a", "a"),   # local — no link
        1: ("a", "b"),
        2: ("b", "a"),   # same pair, opposite direction: SAME link
        3: ("b", "c"),
        4: ("c", "a"),
    }
    links = build_links(plan, chan_hosts)
    assert [(lk.accept, lk.dial) for lk in links] == [
        ("a", "b"), ("a", "c"), ("b", "c")]
    assert links[0].chans == ((1, "a"), (2, "b"))
    assert links[0].label == "link0:a<->b"
    assert links[0].peer_of("a") == "b" and links[0].peer_of("b") == "a"
    # deterministic: every host derives the identical map independently
    assert build_links(plan, dict(reversed(chan_hosts.items()))) == links


def test_link_fault_grammar():
    plan = parse_fault_plan("linkkill:0@3, linkslow:1@2:0.05 "
                            "linkcorrupt:0@4:r1 kill:1@5")
    worker_faults, link_faults = split_plan(plan)
    assert [a.kind for a in worker_faults] == ["kill"]
    assert [(a.kind, a.worker, a.epoch) for a in link_faults] == [
        ("linkkill", 0, 3), ("linkslow", 1, 2), ("linkcorrupt", 0, 4)]
    assert link_faults[1].arg == 0.05
    assert link_faults[2].restart == 1
    # link faults are leader-driven: never delivered to worker plans
    for w in range(3):
        assert all(a.kind not in LINK_KINDS for a in actions_for(plan, w, 0))


def test_link_faults_validated_at_build():
    with pytest.raises(ValueError, match="no bridged links"):
        make_chain(3, capacity=4).build(engine="procs", device="cpu", n_workers=2,
                                        partition=[0, 0, 1], K=1,
                                        fault_plan="linkkill:0@3")
    with pytest.raises(ValueError, match="bridged link"):
        make_chain(3, capacity=4).build(engine="procs", device="cpu", n_workers=2,
                                        partition=[0, 0, 1], K=1, hosts=2,
                                        fault_plan="linkkill:7@3")


def test_fleet_lowering_matches_jax():
    """Both packages derive the same host-local topology from the same
    chain and plan: local workers, channel hosts, the link map and the
    bridge ids the stall graph blames (no process is started)."""
    from repro.runtime.launcher import ProcsEngine as JProcs
    from repro_torch.runtime import ProcsEngine

    for host in ("h0", "h1"):
        kw = dict(n_workers=4, K=2, hosts=2, host=host, prebuild=False)
        j = JProcs(j_chain(6, capacity=4).graph(), [0, 0, 1, 2, 3, 3], **kw)
        t = ProcsEngine(make_chain(6, capacity=4).graph(), [0, 0, 1, 2, 3, 3],
                        device="cpu", **kw)
        try:
            assert t._local_ws == j._local_ws
            assert t._chan_hosts == j._chan_hosts
            assert ([(lk.link, lk.accept, lk.dial, lk.chans) for lk in t._links]
                    == [(lk.link, lk.accept, lk.dial, lk.chans) for lk in j._links])
            assert t._bridge_ids == j._bridge_ids and t._chan_peers == j._chan_peers
            assert t.is_leader == j.is_leader == (host == "h0")
        finally:
            j.close()
            t.close()


# ------------------------------------- 2-launcher loopback fleet sessions
def test_fleet_bit_exact_vs_single_host(closing):
    """A chain sharded across TWO launcher processes connected only by
    loopback TCP: host traffic AND the gathered state tree bit-identical
    to the single-host port fleet, and the bridges report live counters
    through the session."""
    ref = procs(make_chain(3, capacity=4), closing, n_workers=2,
                partition=[0, 0, 1], K=1)
    ref.reset(0)
    ref_trace = io_script(ref, n_steps=8, seed=0)
    ref_tree = ref.engine.gather_state(ref.state)
    ref.engine.close()

    sim = procs(make_chain(3, capacity=4), closing, n_workers=2,
                partition=[0, 0, 1], K=1, hosts=2)
    assert sim.engine.host_plan.n_hosts == 2
    sim.reset(0)
    trace = io_script(sim, n_steps=8, seed=0)
    tree = sim.engine.gather_state(sim.state)

    assert len(ref_trace) == len(trace)
    for step, (a, b) in enumerate(zip(ref_trace, trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, tree)

    rows = sim.stats()["bridges"]  # session wiring: stats()["bridges"]
    assert len(rows) == 2          # one row per SIDE of the single link
    by_host = {r["host"]: r for r in rows}
    assert set(by_host) == {"h0", "h1"}
    for r in rows:
        assert r["label"] == "link0:h0<->h1"
        assert r["bytes_tx"] > 0 and r["bytes_rx"] > 0
        assert 0.0 <= r["wait_fraction"] <= 1.0
    # slabs flow h0 -> h1 on this chain; the far side receives them all
    assert by_host["h0"]["slabs_tx"] == by_host["h1"]["slabs_rx"] > 0
    assert by_host["h0"]["credits_rx"] == by_host["h1"]["credits_tx"] > 0


def test_fleet_io_parity_cycle_accurate(closing):
    """K = 1 / capacity 2: the bridged fleet keeps per-boundary traffic
    bit-identical to the JAX single netlist — the cycle-accurate parity
    contract, with a TCP hop in the middle."""
    ref_sim = j_chain(3, capacity=2).build()
    ref_sim.reset(0)
    ref = io_script(ref_sim, n_steps=12)

    sim = procs(make_chain(3, capacity=2), closing, n_workers=2,
                partition=[0, 0, 1], K=1, hosts=2)
    sim.reset(0)
    tr = io_script(sim, n_steps=12)
    assert len(tr) == len(ref)
    for i, (a, b) in enumerate(zip(ref, tr)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")
    assert sum(len(t) for t in ref) > 3  # something actually flowed


def test_fleet_systolic_save_resume(closing, tmp_path):
    """The systolic scenario across a bridge: save mid-run, load into a
    FRESH 2-host fleet (scatter_state over the control link and into the
    follower's workers' bulk segments), finish — bit-identical to the JAX
    single netlist."""
    from repro.hw.systolic import make_systolic_network as j_systolic

    rng = np.random.RandomState(3)
    M, K, N = 6, 4, 4
    A = rng.randn(M, K).astype(np.float32)
    B = rng.randn(K, N).astype(np.float32)

    def result_of(sim):
        cols = [sim.probe((K - 1) * N + c) for c in range(N)]
        return np.stack([np.asarray(c.y_buf) for c in cols], axis=1)

    done = lambda s: ((~s.block_states[0].is_south)  # noqa: E731
                      | (s.block_states[0].y_idx >= M)).all()

    ref = j_systolic(A, B)[0].build()
    ref.reset(0)
    ref.run(until=done, max_epochs=100_000, cache_key="d")
    want = result_of(ref)

    # contiguous worker blocks so each worker's granules share a host
    part = (np.arange(K * N) // 4).tolist()
    fleet_kw = dict(n_workers=4, partition=part, K=4, hosts=2)
    sim = procs(make_systolic_network(A, B)[0], closing, **fleet_kw)
    sim.reset(0)
    sim.run(cycles=12)
    ck = str(tmp_path / "sys")
    sim.save(ck)
    sim.run(until=done, max_epochs=100_000)
    np.testing.assert_array_equal(want, result_of(sim))
    sim.engine.close()

    sim2 = procs(make_systolic_network(A, B)[0], closing, **fleet_kw)
    sim2.reset(0)
    sim2.load(ck)
    assert sim2.cycle == 12
    sim2.run(until=done, max_epochs=100_000)
    np.testing.assert_array_equal(want, result_of(sim2))


def test_fleet_linkkill_recovery_bit_identical(closing):
    """Kill the TCP bridge mid-run: the leader diagnoses LinkDownError
    (not an innocent worker), tears the WHOLE fleet down, re-rendezvouses
    under a fresh incarnation token, restores the last coordinated
    snapshot, and replays — bit-identical to the fault-free timeline, with
    nothing of the first incarnation left."""
    ref = procs(make_chain(3, capacity=4), closing, n_workers=2,
                partition=[0, 0, 1], K=1)
    ref.reset(0)
    ref_trace = io_script(ref, n_steps=8, seed=1)
    ref_tree = ref.engine.gather_state(ref.state)
    ref.engine.close()

    sim = procs(make_chain(3, capacity=4), closing, n_workers=2,
                partition=[0, 0, 1], K=1, hosts=2, on_fault="recover",
                snapshot_every=2, backoff_s=0.0, fault_plan="linkkill:0@3")
    sim.reset(0)
    eng = sim.engine
    first = {"prefix": eng._ring_prefix, "token": eng._fleet_token,
             "procs": [*eng._procs.values(), *eng._bridge_procs.values(),
                       *eng._follower_procs.values()],
             "follower": eng._follower_hello["h1"]}
    trace = io_script(sim, n_steps=8, seed=1)
    tree = eng.gather_state(sim.state)

    for step, (a, b) in enumerate(zip(ref_trace, trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, tree)

    faults = sim.stats()["faults"]
    assert faults["policy"] == "recover"
    assert faults["restarts"] == 1
    assert faults["incarnation"] == 1
    assert faults["last_recovery"]["fault"] == "LinkDownError"
    assert eng._fleet_token != first["token"]
    # nothing of the first incarnation is left on either host
    assert not [p.pid for p in first["procs"] if p.is_alive()]
    for pid in first["follower"]["pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    left = [f for f in os.listdir("/dev/shm")
            for pre in (first["prefix"], first["follower"]["prefix"])
            if f.startswith(pre)]
    assert not left
