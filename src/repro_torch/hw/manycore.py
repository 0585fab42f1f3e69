"""Wafer-scale many-core fabric — message-passing mini-cores on a torus
(paper §IV-B), as in ``repro.hw.manycore``.

A uniform R×C **torus** of ``ManycoreCell`` blocks runs a two-phase
ring-allreduce entirely in the data plane:

  phase 0 (row rings, east links):   every core circulates its value around
          its row and accumulates the row sum;
  phase 1 (column rings, south links): row sums circulate around each
          column, accumulating the global sum.

When a core's ``phase`` reaches 2, ``total`` holds the sum of every core's
``value``.  All traffic is ready/valid handshaked, so results are bit-exact
for any partition and any per-tier sync rate.

Protocol per ring of length L (phase 0: L = C, phase 1: L = R): a core
sends ``L-1`` packets — its own contribution first, then the first ``L-2``
values it receives, forwarded in arrival order through a 1-deep elastic
register — and accumulates the ``L-1`` values it receives.

``kernels/csrc/granule_step.cu`` carries the same step as a device
function; any change here must be made there too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block
from ..core.struct import tensor_dataclass

PAYLOAD_WORDS = 2  # [value, hop tag]

#: The state leaves the device step takes, with their dtypes (``value`` is
#: never touched), and those other threads read within a cycle (the kernel
#: keeps two buffers of each, by cycle parity).
DEVICE_LEAVES = {
    "own": torch.float32, "acc": torch.float32, "total": torch.float32,
    "phase": torch.int32, "sent": torch.int32, "rcvd": torch.int32,
    "fwd": torch.float32, "fwd_v": torch.bool, "fires": torch.int32,
}
PAIRED_LEAVES = ("phase", "sent", "rcvd", "fwd_v")


@tensor_dataclass
class CoreState:
    value: torch.Tensor   # (n,) f32 — this core's contribution (from params)
    own: torch.Tensor     # (n,) f32 — value this core injects in the current phase
    acc: torch.Tensor     # (n,) f32 — running accumulator for the current phase
    total: torch.Tensor   # (n,) f32 — global sum (valid once phase == 2)
    phase: torch.Tensor   # (n,) int32: 0 = row ring, 1 = column ring, 2 = done
    sent: torch.Tensor    # (n,) int32 packets sent this phase
    rcvd: torch.Tensor    # (n,) int32 packets received this phase
    fwd: torch.Tensor     # (n,) f32 — 1-deep forward register
    fwd_v: torch.Tensor   # (n,) bool
    fires: torch.Tensor   # (n,) int32 — total handshakes (perf counter, §II-C)


@tensor_dataclass
class CoreParams:
    """Per-instance parameters (stacked leading dim)."""

    value: torch.Tensor  # (n,) f32


class ManycoreCell(Block):
    """Message-passing mini-core for an R×C torus (ports match
    ``ChannelGraph.torus``: west/north in, east/south out)."""

    in_ports = ("w_in", "n_in")
    out_ports = ("e_out", "s_out")
    payload_words = PAYLOAD_WORDS

    def __init__(self, R: int, C: int):
        self.R = int(R)
        self.C = int(C)

    def init_state(self, n: int, params: CoreParams | None = None, *,
                   generator=None, device=None) -> CoreState:
        """The cell draws no random numbers, so ``generator`` is unused."""
        if params is None:
            raise ValueError("ManycoreCell requires per-instance params")
        v = torch.as_tensor(params.value, dtype=torch.float32, device=device)
        v = v.reshape(n)
        zf = torch.zeros((n,), dtype=torch.float32, device=v.device)
        zi = torch.zeros((n,), dtype=torch.int32, device=v.device)
        return CoreState(
            value=v.clone(), own=v.clone(), acc=v.clone(), total=zf.clone(),
            phase=zi.clone(), sent=zi.clone(), rcvd=zi.clone(),
            fwd=zf.clone(), fwd_v=torch.zeros((n,), dtype=torch.bool, device=v.device),
            fires=zi.clone(),
        )

    def step(self, state: CoreState, rx, tx_ready):
        (w_pay, w_valid) = rx["w_in"]
        (n_pay, n_valid) = rx["n_in"]
        in_row = state.phase == 0  # else column ring (or done)
        live = state.phase < 2
        # packets to send == packets to receive this phase: ring length - 1
        need = torch.where(in_row, self.C - 1, self.R - 1).to(torch.int32)

        in_val = torch.where(in_row, w_pay[:, 0], n_pay[:, 0])
        in_valid = live & torch.where(in_row, w_valid, n_valid)
        out_ready = torch.where(in_row, tx_ready["e_out"], tx_ready["s_out"])

        # ---- send: own value first, then forwards, in arrival order
        out_val = torch.where(state.sent == 0, state.own, state.fwd)
        can_send = live & (state.sent < need) & ((state.sent == 0) | state.fwd_v)
        did_send = can_send & out_ready
        fwd_freed = did_send & (state.sent > 0)

        # ---- receive: accept unless the forward register is (still) busy
        will_fwd = state.rcvd < need - 1  # the last arrival is not re-sent
        may_accept = live & (state.rcvd < need) & (
            ~will_fwd | ~state.fwd_v | fwd_freed
        )
        accept = may_accept & in_valid

        sent = state.sent + did_send.to(torch.int32)
        rcvd = state.rcvd + accept.to(torch.int32)
        acc = state.acc + torch.where(accept, in_val, torch.zeros_like(in_val))
        fwd_v = (state.fwd_v & ~fwd_freed) | (accept & will_fwd)
        fwd = torch.where(accept & will_fwd, in_val, state.fwd)

        # ---- phase transition: all sent and all received => ring complete
        done_phase = live & (sent == need) & (rcvd == need)
        finishing = done_phase & (state.phase == 1)
        new_phase = state.phase + done_phase.to(torch.int32)

        payload = torch.stack([out_val, state.sent.to(torch.float32)], dim=1)
        tx = {
            "e_out": (payload, did_send & in_row),
            "s_out": (payload, did_send & ~in_row),
        }
        rx_ready = {
            "w_in": may_accept & in_row,
            "n_in": may_accept & ~in_row,
        }
        zero = torch.zeros_like(sent)
        new_state = CoreState(
            value=state.value,
            own=torch.where(done_phase, acc, state.own),
            acc=acc,
            total=torch.where(finishing, acc, state.total),
            phase=new_phase,
            sent=torch.where(done_phase, zero, sent),
            rcvd=torch.where(done_phase, zero, rcvd),
            fwd=fwd,
            fwd_v=fwd_v,
            fires=state.fires + did_send.to(torch.int32) + accept.to(torch.int32),
        )
        return new_state, rx_ready, tx


def make_core_params(values: np.ndarray) -> CoreParams:
    """Stacked per-core params from an (R, C) value array (row-major).
    The params stay numpy until an engine places them on its device."""
    v = np.asarray(values, np.float32)
    return CoreParams(value=v.reshape(-1))


def allreduce_done(cell_states: CoreState, active=None) -> torch.Tensor:
    """() bool — every (active) core finished both ring phases.

    ``active`` masks padding slots when the partition is uneven (pass
    ``local.tables.active[0]`` from a ``run_until`` predicate).
    """
    done = cell_states.phase >= 2
    if active is not None:
        done = done | ~active
    return done.all()


def expected_total(values: np.ndarray) -> float:
    """The invariant every core must converge to: the global sum."""
    return float(np.asarray(values, np.float64).sum())
