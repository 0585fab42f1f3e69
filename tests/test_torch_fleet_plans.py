"""The port's multi-host fleet under other host plans and ports, on the
CPU:

  * a ``linkkill`` on a link the leader is not on (3 hosts, a chain
    through all three: the follower kills its own proxy), healed
    bit-identically;
  * ``base_port`` and ``REPRO_BRIDGE_PORT`` on ports the OS says are free:
    the listeners bind there, the run is the fault-free fleet's;
  * named hosts with a ``{host: [granules]}`` plan whose host ports live
    on the follower (host I/O forwarded over the control link);
  * no process outlives a closed 2-host fleet: the follower's workers,
    bridge and own forkserver are gone, and ``stop_helpers`` stops the
    leader's forkserver and resource tracker, which the next fleet starts
    anew.

Workers run with ``device="cpu"``.  Tolerance: bit-exact.
"""
import socket

import numpy as np
import pytest

from repro_torch.hw.pipestage import make_chain
from repro_torch.runtime.launcher import helper_pids, stop_helpers

from test_torch_bridge import assert_trees_equal, procs
from test_torch_fleet import CHAIN, closing, fault_free  # noqa: F401 (fixtures)
from test_torch_session_surface import io_script


def test_linkkill_on_a_follower_link(closing):
    """3 hosts, a chain through all three: link 1 joins the two followers,
    so the leader asks h1 (its accept side) to kill its proxy.  Healed
    bit-identically."""
    kw = dict(n_workers=3, partition=[0, 1, 2], K=1, hosts=3)
    ref = procs(make_chain(3, capacity=4), closing,
                **{k: v for k, v in kw.items() if k != "hosts"})
    ref.reset(0)
    want = io_script(ref, n_steps=8, seed=2)
    ref_tree = ref.engine.gather_state(ref.state)
    ref.engine.close()
    sim = procs(make_chain(3, capacity=4), closing, on_fault="recover",
                snapshot_every=2, backoff_s=0.0, fault_plan="linkkill:1@3", **kw)
    assert [(lk.accept, lk.dial) for lk in sim.engine._links] == [("h0", "h1"),
                                                                   ("h1", "h2")]
    assert 1 not in sim.engine._bridge_ids  # the leader has no proxy on link 1
    sim.reset(0)
    got = io_script(sim, n_steps=8, seed=2)
    for step, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, sim.engine.gather_state(sim.state))
    faults = sim.engine.fault_stats()
    assert faults["restarts"] == 1
    assert faults["last_recovery"]["fault"] in ("LinkDownError", "WorkerDiedError")


def _free_port() -> int:
    """A port the OS reports free, with the next one free too (the leader's
    control listener sits at base_port + n_links)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with socket.socket() as s2:
            try:
                s2.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no two adjacent free ports")


@pytest.mark.parametrize("via", ["argument", "env"])
def test_base_port_binds_there(closing, fault_free, monkeypatch, via):
    """``base_port`` (or ``REPRO_BRIDGE_PORT``): link 0's accept side
    listens on the base port and the leader's control listener on the next
    one; the run is the fault-free fleet's."""
    port = _free_port()
    kw = dict(CHAIN, hosts="a,b")
    if via == "argument":
        kw["base_port"] = port
    else:
        monkeypatch.setenv("REPRO_BRIDGE_PORT", str(port))
    sim = procs(make_chain(3, capacity=4), closing, **kw)
    sim.reset(0)
    eng = sim.engine
    assert eng.host_plan.hosts == ("a", "b") and eng._base_port == port
    assert eng._accept_ports == {0: port}
    assert eng._ctl_listener.getsockname()[1] == port + 1
    trace = io_script(sim, n_steps=8, seed=1)
    for step, (a, b) in enumerate(zip(fault_free[0], trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")


def test_dict_plan_places_granules(closing):
    """A ``{host: [granules]}`` plan: the ports' home granule on the
    follower, so host I/O is forwarded over the control link; traffic as
    the single-host fleet's."""
    kw = dict(n_workers=4, partition=[0, 1, 2, 3], K=1)
    ref = procs(make_chain(4, capacity=4), closing, **kw)
    ref.reset(0)
    want = io_script(ref, n_steps=6, seed=3)
    ref.engine.close()
    sim = procs(make_chain(4, capacity=4), closing,
                hosts={"lead": [1, 2], "far": [0, 3]}, **kw)
    eng = sim.engine
    assert eng.host == "lead" and eng._local_ws == (1, 2)
    assert {eng._ext_home_host(c) for c, _ in eng.graph.ext_ports().values()} == {"far"}
    sim.reset(0)
    got = io_script(sim, n_steps=6, seed=3)
    for step, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    st = sim.stats()
    assert {r["host"] for r in st["bridges"]} == {"lead", "far"}
    # the far host's rings, read over the control link
    ports = eng.port_stats(sim.state)
    assert ports["tx"]["tx"]["home"] == 0 and ports["rx"]["rx"]["home"] == 3
    assert st["ports"]["rx"]["rx"]["credit"] == ports["rx"]["rx"]["credit"]


def _alive(pid: int) -> bool:
    """``pid`` is a live process (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_no_process_outlives_the_fleet(closing, fault_free):
    """Closing a 2-host fleet leaves none of the follower's processes (its
    forkserver among them: the follower reports it at rendezvous and stops
    it before it leaves); ``stop_helpers`` then stops this process's
    forkserver and resource tracker and waits for them, and the next fleet
    starts both anew and runs the fault-free trace."""
    sim = procs(make_chain(3, capacity=4), closing, hosts=2, **CHAIN)
    sim.reset(0)
    io_script(sim, n_steps=4, seed=1)
    pids = sim.engine._follower_hello["h1"]["pids"]
    follower = sim.engine._follower_procs["h1"]
    assert len(pids) == 3  # its worker, its bridge and its forkserver
    sim.engine.close()
    assert follower.exitcode == 0
    assert not [p for p in pids if _alive(p)]
    helpers = helper_pids()
    assert helpers and stop_helpers() == helpers
    assert not [p for p in helpers if _alive(p)] and helper_pids() == []
    again = procs(make_chain(3, capacity=4), closing, **CHAIN)
    trace = io_script(again.reset(0), n_steps=8, seed=1)
    for step, (a, b) in enumerate(zip(fault_free[0], trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
