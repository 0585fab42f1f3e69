"""The port's fused engine against the JAX engine's own Pallas kernel.

The JAX ``FusedEngine`` with ``fuse="pallas", pallas_interpret=True`` runs
``granule_step.pallas_program`` — the TPU kernel the port's Hopper kernel
replaces — in the Pallas interpreter.  The port's plain version must match
it bit for bit after every epoch, as the Hopper kernel must match the
plain version on the card (``tests/test_torch_kernel.py``,
``chip_smoke.py``).
"""
import jax
import pytest

from test_torch_graph import assert_same_state, jax_state_dict, wafer_pair

TIERS = [(("pod",), 2), (("g",), 4)]


@pytest.fixture(scope="module")
def pallas_ref():
    je, te, vals = wafer_pair(8, 8, TIERS, 8, fuse="pallas", pallas_interpret=True)
    st = je.place(je.init(jax.random.key(0)))
    states = [jax_state_dict(st)]
    for _ in range(7):
        st = je.run_epochs(st, 1, donate=False)
        states.append(jax_state_dict(st))
    return te, states, vals


def test_plain_version_matches_pallas_kernel_epoch_by_epoch(pallas_ref):
    te, states, vals = pallas_ref
    st = te.init(0)
    for ep, want in enumerate(states[1:]):
        st = te.run_epochs(st, 1)
        assert_same_state(want, st, ep)
    assert (te.gather_group(st, 0).total == vals.sum()).all()


@pytest.mark.parametrize("n_epochs", [1, 3, 7])
def test_multi_epoch_runs_match_pallas_kernel(pallas_ref, n_epochs):
    """One ``run_epochs(n)`` call equals n single-epoch calls."""
    te, states, _ = pallas_ref
    assert_same_state(states[n_epochs], te.run_epochs(te.init(0), n_epochs),
                      n_epochs)
