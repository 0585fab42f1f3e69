"""The plain reference of the systolic matmul (``configs/systolic-1M.json``).

Two answers, each worked out from the configuration and the run's inputs
alone, never from the program under test:

* :func:`product` -- ``Y = A @ B`` as the array computes it: column c of
  row m is the chain ``y = fma(A[m, r], B[r, c], y)`` down the rows
  r = 0 .. R-1 from ``y = 0``, one rounding a step in float32 (a fused
  multiply-add, ``torch.addcmul``), so the comparison is exact;
* :func:`stop_cycle` -- the cycle at which ``run(until=every south cell
  collected M outputs)`` stops: a cycle-level model of the grid that
  tracks only what decides timing (each west cell's stream index, each
  south cell's collect count and the valid bit of every channel).  A cell
  fires when its A input (the west stream, or the register from the west)
  and its partial sum (0 at the north edge, or the register from the
  north) are valid and its east and south registers are empty (always, at
  the east and south edges).  Every channel is a register of depth 1 (one
  tile: the configuration's ``tiles`` is (1, 1)); the run checks its
  predicate before every epoch of ``K`` cycles.

This file imports nothing of the program: plain PyTorch on any device.
"""
from __future__ import annotations

import torch


def product(A: torch.Tensor, B: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(M, C) ``Y`` of (M, R) ``A`` and (R, C) ``B``: the fused
    multiply-add chain down the rows, in ``dtype`` (float32 is the
    configuration's; bfloat16 is the control's)."""
    A = A.to(dtype)
    B = B.to(dtype)
    y = torch.zeros((A.shape[0], B.shape[1]), dtype=dtype, device=A.device)
    for r in range(A.shape[1]):
        y = torch.addcmul(y, A[:, r:r + 1], B[r:r + 1, :])
    return y


def stop_cycle(M: int, R: int, C: int, K: int, max_epochs: int,
               device="cpu") -> int:
    """The cycle at which the run stops (see the module's docstring)."""
    a_idx = torch.zeros((R,), dtype=torch.int32, device=device)  # west column
    y_idx = torch.zeros((C,), dtype=torch.int32, device=device)  # south row
    e_v = torch.zeros((R, C), dtype=torch.bool, device=device)  # (r, c) -> (r, c+1)
    s_v = torch.zeros((R, C), dtype=torch.bool, device=device)  # (r, c) -> (r+1, c)
    true_col = torch.ones((R, 1), dtype=torch.bool, device=device)
    true_row = torch.ones((1, C), dtype=torch.bool, device=device)
    cycle = 0
    for _ in range(max_epochs + 1):
        if bool((y_idx >= M).all()) or cycle // K >= max_epochs:
            return cycle
        for _ in range(K):
            a_valid = torch.cat([(a_idx < M)[:, None], e_v[:, :-1]], 1)
            p_valid = torch.cat([true_row, s_v[:-1, :]], 0)
            e_rdy = torch.cat([~e_v[:, :-1], true_col], 1)
            s_rdy = torch.cat([~s_v[:-1, :], true_row], 0)
            fire = a_valid & p_valid & e_rdy & s_rdy
            pop_e = torch.cat([fire[:, 1:], ~true_col], 1)  # the cell east pops
            pop_s = torch.cat([fire[1:, :], ~true_row], 0)  # the cell south pops
            push_e = torch.cat([fire[:, :-1], ~true_col], 1)
            push_s = torch.cat([fire[:-1, :], ~true_row], 0)
            e_v = (e_v & ~pop_e) | push_e
            s_v = (s_v & ~pop_s) | push_s
            a_idx = a_idx + fire[:, 0].to(torch.int32)
            y_idx = y_idx + fire[-1, :].to(torch.int32)
            cycle += 1
    raise AssertionError("unreachable")
