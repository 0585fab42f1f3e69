"""The port's multi-host fleet beyond ``tests/test_bridge.py``'s cases, on
the CPU:

  * one 2-host port fleet against the JAX package's 2-host fleet on the
    same chain and host script: Rx traffic equal, ``gather_state`` equal
    leaf for leaf in flatten order;
  * the link drills under ``on_fault="recover"`` (``linkcorrupt`` healed
    with one restart, ``linkslow`` absorbed with none, both bit-identical
    to the fault-free fleet), under ``raise`` (``linkkill`` ->
    ``LinkDownError`` naming the link, ``linkcorrupt`` ->
    ``RingCorruptionError``).

Plans beyond two hosts, named hosts and fixed ports are in
``tests/test_torch_fleet_plans.py``.

Workers run with ``device="cpu"``.  Tolerance: bit-exact.
"""
import numpy as np
import pytest

from repro_torch.core.struct import tree_paths
from repro_torch.hw.pipestage import make_chain
from repro_torch.runtime import LinkDownError, RingCorruptionError

from test_torch_bridge import assert_trees_equal, procs
from test_torch_procs_parity import _jax_leaves
from test_torch_session_surface import io_script


@pytest.fixture
def closing():
    sims = []
    yield sims.append
    for sim in sims:
        sim.engine.close()


CHAIN = dict(n_workers=2, partition=[0, 0, 1], K=1)


@pytest.fixture(scope="module")
def fault_free():
    """The single-host port fleet's io_script trace and final tree (seed 1)."""
    sim = make_chain(3, capacity=4).build(engine="procs", device="cpu", timeout=60.0,
                                          **CHAIN)
    try:
        sim.reset(0)
        trace = io_script(sim, n_steps=8, seed=1)
        return trace, sim.engine.gather_state(sim.state)
    finally:
        sim.engine.close()


def test_two_host_fleet_matches_jax_two_host_fleet(closing):
    """The JAX package's 2-host fleet and the port's, the same chain, plan
    and host script: the same Rx traffic, ``gather_state`` equal leaf for
    leaf (paths, shapes, dtypes, values), and one bridge row a side."""
    from repro.hw.pipestage import make_chain as j_chain

    kw = dict(n_workers=3, partition=[0, 1, 2], K=2, hosts=2, timeout=60.0)
    jsim = j_chain(3, capacity=4).build(engine="procs", **kw)
    closing(jsim)
    tsim = procs(make_chain(3, capacity=4), closing, **kw)
    traffic = {}
    for tag, sim in (("jax", jsim), ("port", tsim)):
        sim.reset(0)
        traffic[tag] = io_script(sim, n_steps=8, seed=4)
        sim.tx("tx").send_many([[7.0, 1.0], [8.0, 2.0]])  # left resident
    assert len(traffic["jax"]) == len(traffic["port"])
    for step, (a, b) in enumerate(zip(traffic["jax"], traffic["port"])):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    want = _jax_leaves(jsim.engine.gather_state(jsim.state))
    got = [(p, np.asarray(x)) for p, x in tree_paths(tsim.engine.gather_state(tsim.state))]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        assert np.array_equal(a, b), p
    jrows, trows = jsim.engine.bridge_stats(), tsim.engine.bridge_stats()
    assert [(r["link"], r["host"], r["role"]) for r in trows] == [
        (r["link"], r["host"], r["role"]) for r in jrows]
    for jr, tr in zip(jrows, trows):
        for k in ("slabs_tx", "slabs_rx", "credits_tx", "credits_rx", "bytes_tx"):
            assert jr[k] == tr[k], k


@pytest.mark.parametrize("plan,fault,restarts", [
    ("linkcorrupt:0@3", "RingCorruptionError", 1),
    ("linkslow:0@3:0.05", None, 0),
])
def test_link_drill_under_recover(closing, fault_free, plan, fault, restarts):
    """A byte flipped on the wire trips the far consumer's crc32 and is
    healed like any corruption; a paused pump only adds latency.  Either
    way the trace and the final tree are the fault-free fleet's."""
    ref_trace, ref_tree = fault_free
    sim = procs(make_chain(3, capacity=4), closing, hosts=2, on_fault="recover",
                snapshot_every=2, backoff_s=0.0, fault_plan=plan, **CHAIN)
    sim.reset(0)
    trace = io_script(sim, n_steps=8, seed=1)
    for step, (a, b) in enumerate(zip(ref_trace, trace)):
        np.testing.assert_array_equal(a, b, err_msg=f"boundary {step}")
    assert_trees_equal(ref_tree, sim.engine.gather_state(sim.state))
    faults = sim.engine.fault_stats()
    assert faults["restarts"] == restarts
    assert (faults["last_recovery"] or {}).get("fault") == fault


@pytest.mark.parametrize("plan,exc", [("linkkill:0@3", LinkDownError),
                                      ("linkcorrupt:0@3", RingCorruptionError)])
def test_link_drill_under_raise(closing, plan, exc):
    sim = procs(make_chain(3, capacity=4), closing, hosts=2, fault_plan=plan, **CHAIN)
    sim.reset(0)
    with pytest.raises(exc) as ei:
        sim.run(cycles=8 * sim.period)
    if exc is LinkDownError:
        assert "link0:h0<->h1" in str(ei.value)
    assert sim.engine._closed
