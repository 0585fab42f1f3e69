"""``granule_step.cu``'s PipeStage device step on the card: the fused
host-I/O path (``make_chain`` / ``make_ring`` on ``FusedEngine``), the
``fused-io`` cases of ``chip_smoke.py`` as tests.

This file imports no JAX, so it runs where JAX is absent (the CPU tests
hold the fused engine against the JAX package, and the kernel's one-pass
schedule against the plain cycle in ``tests/test_torch_granule_schedule.py``).
The tests need a CUDA device and skip without one; run them there with
``python -m pytest -q -m cuda tests/test_torch_fused_io_cuda.py``.
Tolerance: bit-exact (every state leaf, every packet).
"""
import numpy as np
import pytest
import torch

from repro_torch.hw.pipestage import make_chain, make_ring
from repro_torch.kernels import fused_checks as fc
from repro_torch.kernels import granule_step

from test_torch_procs_cuda import io_script


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: granule_step.cu has no CPU mode")
    return torch.device("cuda")


def _chain(n, capacity, K, granules):
    kw = dict(K=K)
    if granules > 1:
        kw.update(partition=(np.arange(n) * granules // n).tolist(),
                  tiers=[(("g",), K)], batch_axes={"g": granules})
    return make_chain(n, capacity=capacity, delta=0.5).build(
        engine="fused", session=False, device="cuda", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("K,granules", [(1, 1), (2, 1), (2, 2), (4, 4)])
def test_pipestage_epochs_match_plain_version(cuda, K, granules):
    """A host-fed 16-stage chain: every epoch through the kernel against
    ``epoch_program_ref`` on a copy on the card, every leaf bit-exact, the
    popped packets equal, one launch an epoch."""
    assert fc.check_io(_chain(16, 4, K, granules), 40, seed=K + granules) > 0


@pytest.mark.cuda
def test_pipestage_ring_matches_plain_version(cuda):
    """A closed 12-stage ring on 2 batched granules at K = 2, its registers
    seeded with packets: every epoch bit-exact against the plain version."""
    eng = make_ring(12, capacity=4).build(
        engine="fused", session=False, device="cuda", K=2,
        partition=[0] * 6 + [1] * 6, tiers=[(("g",), 2)], batch_axes={"g": 2})
    kern = fc.seed_registers(eng.init(0), every=2)
    plain = fc.clone(kern)
    before = granule_step.launches
    for _ in range(12):
        kern = eng.run_epochs(kern, 1)
        plain = fc.plain_epochs(eng, plain)
        torch.cuda.synchronize()
        fc.compare(kern, plain)
    assert granule_step.launches - before == 12
    assert int(kern.block_states[0].count.sum()) > 0


@pytest.mark.cuda
def test_chain_io_matches_netlist_k1(cuda):
    """make_chain(4, capacity=2) at K = 1 through the session on
    ``FusedEngine`` and on ``NetworkSim``, both on the card: the host trace
    bit-identical at every boundary."""
    want = io_script(make_chain(4, capacity=2).build(device="cuda").reset(0))
    sim = make_chain(4, capacity=2).build(engine="fused", device="cuda", K=1)
    before = granule_step.launches
    got = io_script(sim.reset(0))
    assert granule_step.launches > before
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
