"""Multi-host fleets with every worker on the card: a chain sharded over
two launcher processes joined by a TCP ring bridge, bit-identical to the
single-host fleet, and one ``linkkill`` drill healed bit-identically; the
follower launcher itself never initialises CUDA (only its workers do).

This file imports no JAX.  The tests need a CUDA device and skip without
one; run them there with
``python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py``.
Tolerance: bit-exact (host trace, final ``gather_state``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.struct import tree_paths
from repro_torch.hw.pipestage import make_chain

from test_torch_procs_cuda import io_script

TIMEOUT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the workers' captured cycle graphs run "
                    "only there")
    return torch.device("cuda")


def _run(**kw):
    sim = make_chain(3, capacity=4).build(
        engine="procs", device="cuda", n_workers=2, partition=[0, 0, 1], K=1,
        timeout=TIMEOUT, **kw)
    try:
        sim.reset(0)
        trace = io_script(sim, n_steps=8)
        eng = sim.engine
        hosts = {h: r.get("cuda_initialized") for h, r in
                 eng.launch_stats.get("hosts", {}).items()}
        devices = {r["device"] for r in eng.worker_stats()}
        return trace, eng.gather_state(sim.state), eng.fault_stats(), hosts, devices
    finally:
        sim.engine.close()


def _same(want, got):
    assert len(got[0]) == len(want[0])
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(a, b)
    pa, pb = tree_paths(want[1]), tree_paths(got[1])
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p


@pytest.mark.cuda
def test_two_host_chain_on_the_card(cuda):
    want = _run()
    got = _run(hosts=2)
    _same(want, got)
    assert got[3] == {"h1": False}  # the follower launcher left CUDA alone
    assert all(d.startswith("cuda") for d in got[4])


@pytest.mark.cuda
def test_linkkill_heals_on_the_card(cuda):
    want = _run()
    got = _run(hosts=2, on_fault="recover", snapshot_every=2, backoff_s=0.0,
               fault_plan="linkkill:0@3")
    _same(want, got)
    faults = got[2]
    assert faults["restarts"] == 1 and faults["incarnation"] == 1
    assert faults["last_recovery"]["fault"] == "LinkDownError"
