"""A minimal latency-insensitive pipeline stage (paper §II-A's "DUT"), as
in ``repro.hw.pipestage``.

The simplest useful Block: forward the inbound packet, adding ``delta``
to word 0, under a full ready/valid handshake.  One block type, arbitrary
chain/ring topologies — the unit cell for host-I/O scenarios and the
engine-parity checks.
"""
from __future__ import annotations

import torch

from ..core.block import Block
from ..core.network import Network
from ..core.struct import tensor_dataclass


@tensor_dataclass
class PipeStageState:
    count: torch.Tensor  # (n,) int32 — handshakes forwarded


#: The state leaves ``granule_step.cu``'s PipeStage step reads and writes,
#: with their dtypes; none needs a second buffer (only its owner touches
#: ``count``).
DEVICE_LEAVES = {"count": torch.int32}
PAIRED_LEAVES = ()


class PipeStage(Block):
    """Forward ``in`` -> ``out``, adding ``delta`` to word 0 on the way."""

    in_ports = ("in",)
    out_ports = ("out",)
    payload_words = 2

    def __init__(self, delta: float = 1.0):
        self.delta = float(delta)

    def init_state(self, n: int, params=None, *, generator=None, device=None):
        """The stage has no parameters and draws no random numbers."""
        return PipeStageState(count=torch.zeros((n,), dtype=torch.int32, device=device))

    def step(self, state, rx, tx_ready):
        pay, valid = rx["in"]
        fire = valid & tx_ready["out"]
        out = pay.clone()
        out[:, 0] += self.delta
        return (
            state.replace(count=state.count + fire.to(torch.int32)),
            {"in": fire},
            {"out": (out, fire)},
        )


def make_chain(n: int, capacity: int = 8, delta: float = 1.0) -> Network:
    """n-stage chain with host ports "tx" (into stage 0) and "rx" (out of
    stage n-1) — the canonical host-I/O scenario."""
    net = Network(payload_words=2, capacity=capacity)
    blk = PipeStage(delta)
    insts = [net.instantiate(blk, name=f"s{i}") for i in range(n)]
    net.external_in(insts[0]["in"], "tx")
    for a, b in zip(insts, insts[1:]):
        net.connect(a["out"], b["in"])
    net.external_out(insts[-1]["out"], "rx")
    return net


def make_ring(n: int, capacity: int = 8, delta: float = 1.0) -> Network:
    """n-stage closed ring — one block type, perfectly uniform topology."""
    net = Network(payload_words=2, capacity=capacity)
    blk = PipeStage(delta)
    insts = [net.instantiate(blk, name=f"s{i}") for i in range(n)]
    for i in range(n):
        net.connect(insts[i]["out"], insts[(i + 1) % n]["in"])
    return net
