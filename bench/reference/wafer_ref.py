"""The plain reference of the wafer allreduce (``configs/wafer-1M.json``).

Two answers, each worked out from the configuration and the run's inputs
alone, never from the program under test:

* :func:`totals` -- what every core holds when the allreduce has ended:
  the exact sum of the core values.  The values are whole numbers from 1
  to 8, so every partial sum of 1,048,576 of them stays below 2**24 and
  float32 holds it exactly, whatever order a ring adds them in.
* :func:`stop_cycle` -- the cycle at which ``run(until=every core done)``
  stops: a cycle-level model of the two-phase ring protocol on the
  partitioned torus that tracks only what decides timing (phase, sent,
  received, the forward register's valid bit, the occupancy of every
  channel and the credits of every boundary channel).  The protocol's
  timing does not depend on the values, so the model carries none.

Semantics modelled, as the configuration and the engine's traffic file
state them:

* a channel inside a granule is a register of depth 1 (``"register"``:
  the producer may push only into an empty one) or a queue of
  ``queue_capacity`` slots that holds ``capacity - 1`` packets
  (``"queue"``); the consumer sees what the channel held before the cycle,
  and a packet pushed in cycle t is seen in cycle t + 1;
* a channel across granules is an egress queue at the sender and an
  ingress queue at the receiver, both of ``queue_capacity`` slots.  Every
  ``period`` cycles of its tier the exchange moves ``min(egress, E,
  credit)`` packets, ``E = min(period, capacity - 1)``, and the credit
  becomes the ingress queue's free space; credits start at
  ``capacity - 1``.  Tiers are nested tiles of the torus, outermost first
  (``tiered_grid_partition``'s layout): a channel belongs to the
  outermost tier whose tile its two ends do not share;
* the run checks its predicate before every epoch (``k_inner * k_outer``
  cycles), so it stops at the first epoch boundary at which every core has
  finished both ring phases.

This file imports nothing of the program: plain PyTorch on any device.
"""
from __future__ import annotations

import torch


def totals(values: torch.Tensor) -> int:
    """The allreduce's answer: the exact sum of the core values."""
    return int(values.to(torch.int64).sum())


def totals_bf16(values: torch.Tensor) -> float:
    """The control: the allreduce's two ring phases accumulated in
    bfloat16 (each row's ring, then the row sums around a column), the
    precision below the configuration's float32.  ``values`` is (R, C)."""
    v = values.to(torch.bfloat16)
    acc = v[:, 0].clone()
    for c in range(1, v.shape[1]):
        acc = acc + v[:, c]
    total = acc[0].clone()
    for r in range(1, acc.shape[0]):
        total = total + acc[r]
    return float(total)


def _tiles(R: int, C: int, tiles, device) -> list:
    """Per tier, each core's tile id at that tier (nested, outermost
    first), as ``tiered_grid_partition`` carves the torus."""
    rr = torch.arange(R, device=device)[:, None].expand(R, C)
    cc = torch.arange(C, device=device)[None, :].expand(R, C)
    gid = torch.zeros((R, C), dtype=torch.int64, device=device)
    out, Rrem, Crem = [], R, C
    for tr, tc in tiles:
        br, bc = Rrem // tr, Crem // tc
        gid = gid * (tr * tc) + (rr // br) * tc + (cc // bc)
        rr, cc = rr % br, cc % bc
        Rrem, Crem = br, bc
        out.append(gid.clone())
    return out


def _channel_tier(ids: list, shift: tuple) -> torch.Tensor:
    """Each channel's tier index + 1 (0: inside a granule) for the
    channels from every core to its neighbour at ``shift``."""
    tier = torch.zeros_like(ids[0])
    for t in reversed(range(len(ids))):
        other = torch.roll(ids[t], shifts=shift, dims=(0, 1))
        tier = torch.where(ids[t] != other, t + 1, tier)
    return tier


def stop_cycle(R: int, C: int, tiles, ks, capacity: int, intra: str,
               max_epochs: int, device="cpu") -> int:
    """The cycle at which the run stops (see the module's docstring).

    ``tiles``: per tier (rows, cols) splits, outermost first; ``ks``: per
    tier the sub-rounds of a round (``(k_outer, k_inner)``); ``intra``:
    ``"register"`` or ``"queue"``."""
    if intra not in ("register", "queue"):
        raise ValueError(f"intra must be 'register' or 'queue', not {intra!r}")
    n_t = len(ks)
    periods = [1] * n_t
    p = 1
    for t in reversed(range(n_t)):
        p *= int(ks[t])
        periods[t] = p
    epoch = periods[0]
    lim = capacity - 1
    intra_lim = 1 if intra == "register" else lim
    E = [min(per, lim) for per in periods]

    ids = _tiles(R, C, tiles, device)
    i32 = dict(dtype=torch.int32, device=device)
    z = lambda: torch.zeros((R, C), **i32)  # noqa: E731
    phase, sent, rcvd = z(), z(), z()
    fwd_v = torch.zeros((R, C), dtype=torch.bool, device=device)
    # per direction (0 east, 1 south), indexed by the producing core
    shifts = ((0, -1), (-1, 0))  # where the consumer sits, as a roll
    tier = [_channel_tier(ids, s) for s in shifts]
    intra_m = [t == 0 for t in tier]
    eg = [z(), z()]
    ig = [z(), z()]
    cr = [torch.full((R, C), lim, **i32), torch.full((R, C), lim, **i32)]

    def exchange(t: int) -> None:
        for d in (0, 1):
            m = tier[d] == t + 1
            moved = torch.minimum(torch.minimum(eg[d], cr[d]),
                                  torch.full_like(eg[d], E[t]))
            moved = torch.where(m, moved, torch.zeros_like(moved))
            eg[d] -= moved
            ig[d] += torch.minimum(moved, lim - ig[d])
            cr[d] = torch.where(m, lim - ig[d], cr[d])

    cycle = 0
    for _ in range(max_epochs + 1):
        if bool((phase == 2).all()):
            return cycle
        if cycle // epoch >= max_epochs:
            return cycle
        for _ in range(epoch):
            in_row = phase == 0
            live = phase < 2
            need = torch.where(in_row, C - 1, R - 1).to(torch.int32)
            # what each core sees on its in-ports: the channel from the
            # west (east channel of the core to the west) and from the north
            w_valid = torch.roll(ig[0], shifts=(0, 1), dims=(0, 1)) > 0
            n_valid = torch.roll(ig[1], shifts=(1, 0), dims=(0, 1)) > 0
            ready = [torch.where(intra_m[d], ig[d] < intra_lim, eg[d] < lim)
                     for d in (0, 1)]
            in_valid = live & torch.where(in_row, w_valid, n_valid)
            out_ready = torch.where(in_row, ready[0], ready[1])

            can_send = live & (sent < need) & ((sent == 0) | fwd_v)
            did_send = can_send & out_ready
            fwd_freed = did_send & (sent > 0)
            will_fwd = rcvd < need - 1
            may_accept = live & (rcvd < need) & (~will_fwd | ~fwd_v | fwd_freed)
            accept = may_accept & in_valid

            sent = sent + did_send.to(torch.int32)
            rcvd = rcvd + accept.to(torch.int32)
            fwd_v = (fwd_v & ~fwd_freed) | (accept & will_fwd)
            done_phase = live & (sent == need) & (rcvd == need)
            phase = phase + done_phase.to(torch.int32)
            sent = torch.where(done_phase, torch.zeros_like(sent), sent)
            rcvd = torch.where(done_phase, torch.zeros_like(rcvd), rcvd)

            push = [(did_send & in_row).to(torch.int32),
                    (did_send & ~in_row).to(torch.int32)]
            # a pop empties the channel that feeds the accepting core
            pop = [torch.roll((accept & in_row).to(torch.int32), (0, -1), (0, 1)),
                   torch.roll((accept & ~in_row).to(torch.int32), (-1, 0), (0, 1))]
            for d in (0, 1):
                ig[d] = ig[d] - pop[d] + torch.where(intra_m[d], push[d], 0)
                eg[d] = eg[d] + torch.where(intra_m[d], 0, push[d])
            cycle += 1
            # exchanges at the end of each tier's round, innermost first
            for t in reversed(range(n_t)):
                if cycle % periods[t] == 0:
                    exchange(t)
    raise AssertionError("unreachable")
