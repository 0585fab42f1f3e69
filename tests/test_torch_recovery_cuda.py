"""Self-healing procs fleets with every worker on the card: the kill and
corruption drills of ``tests/test_torch_recovery.py`` (the reference's
``_drill`` scenario: a 3-stage chain on 2 workers, K = 1,
``snapshot_every=2``), each worker capturing its cycle graphs anew at
every respawn.

This file imports no JAX.  The tests need a CUDA device and skip without
one; run them there with
``python -m pytest -q -m cuda tests/test_torch_recovery_cuda.py``.
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
        return trace, sim.engine.gather_state(sim.state), sim.engine.fault_stats()
    finally:
        sim.engine.close()


@pytest.mark.cuda
@pytest.mark.parametrize("plan,fault", [("kill:1@5", "WorkerDiedError"),
                                        ("corrupt:0@3", "RingCorruptionError")])
def test_drill_heals_on_the_card(cuda, plan, fault):
    want, want_tree, _ = _run()
    got, tree, faults = _run(on_fault="recover", snapshot_every=2, backoff_s=0.0,
                             fault_plan=plan)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    pa, pb = tree_paths(want_tree), tree_paths(tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p
    assert faults["restarts"] == 1 and faults["incarnation"] == 1
    assert faults["last_recovery"]["fault"] == fault
