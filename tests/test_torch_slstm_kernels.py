"""The port's sLSTM kernel module against the JAX package on the CPU:
its plain version (what the wrapper runs on CPU tensors) against the JAX
Pallas kernel in interpret mode and against the JAX oracle, and the port's
oracle against the JAX oracle, at every case of
``kernels.lm_checks.SLSTM_CASES``.  A file of its own, so that a
distributed run spreads these cases (one takes minutes in the Pallas
interpreter) and the other LM kernel tests over separate workers.

Tolerances as in ``tests/test_torch_lm_kernels.py``: f32 at 1e-5
relative, with an absolute 1e-5 times the largest magnitude for values
near 0 (the two packages sum in other orders).
"""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.slstm_scan import slstm_scan as j_slstm
from repro_torch.kernels import lm_checks
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_scan as sl

from test_torch_lm_kernels import close


@pytest.mark.parametrize("case,bt", [
    (lm_checks.SLSTM_CASES[0], 128),   # T = 1, the decode step
    (lm_checks.SLSTM_CASES[1], 16),
    (lm_checks.SLSTM_CASES[2], 128),
    (lm_checks.SLSTM_CASES[3], 128),   # T = 1, R in bf16
    (lm_checks.SLSTM_CASES[4], 32),    # R in bf16, as the model stores it
    (lm_checks.SLSTM_CASES[5], 128),   # T = 1 at xlstm-125m's width, hd = 192
    (lm_checks.SLSTM_CASES[6], 128),   # xlstm-125m's width over 512 steps
    (lm_checks.SLSTM_CASES[7], 64),    # its width with R in f32
    (lm_checks.SLSTM_CASES[8], 64),    # one batch row
    (lm_checks.SLSTM_CASES[9], 16),    # five batch rows
    (lm_checks.SLSTM_CASES[10], 64),   # 32 batch rows at xlstm-125m's width
    (lm_checks.SLSTM_CASES[11], 32),   # 23 batch rows from a zero carry
    (lm_checks.SLSTM_CASES[12], 16)])  # 64 batch rows
def test_slstm_plain_matches_pallas_and_oracle(case, bt):
    r, pre, carry0 = lm_checks.slstm_inputs(case, seed=case[1], device="cpu")
    jdt = jnp.bfloat16 if case[4] == torch.bfloat16 else jnp.float32
    jr = {g: jnp.asarray(r[g].float().numpy(), jdt) for g in r}
    jpre = jnp.asarray(pre.numpy())
    jc = tuple(jnp.asarray(c.numpy()) for c in carry0)
    out_pl = j_slstm(jr, jpre, jc, block_t=bt, interpret=True)
    out_jr = jref.slstm_scan_ref(jr, jpre, jc)
    out = sl.slstm_scan(r, pre, carry0, block_t=bt)
    out_tr = tref.slstm_scan_ref(r, pre, carry0)

    def leaves(o):
        hs, seqs, fin = o
        return [hs, *seqs, *fin]

    names = ("hs", "cs", "ns", "ms", "c", "n", "h", "m")
    for got, want, tag in ((out, out_pl, "plain vs Pallas"),
                           (out, out_jr, "plain vs JAX oracle"),
                           (out_tr, out_jr, "oracle vs JAX oracle")):
        for g, w, name in zip(leaves(got), leaves(want), names):
            close(g, w, f"{tag} {name}")
