"""Hardware-block protocol (paper §II, Fig. 1), as in ``repro.core.block``.

A *block* is a cycle-stepped state machine whose only connection to the rest
of the system is a set of latency-insensitive ports carrying ready/valid
handshakes:

  * On each cycle the RX bridge presents the front packet of the inbound
    queue as ``(payload, valid)`` (from the pre-cycle queue snapshot); the
    block answers with ``ready``; ``valid & ready`` pops the queue.
  * The TX bridge presents ``ready = ~full`` (pre-cycle snapshot); the block
    answers with ``(payload, valid)``; ``valid & ready`` pushes.

Blocks declare ``in_ports`` / ``out_ports`` (names) and implement
``init_state`` and ``step``.  Where the JAX package vmaps a per-instance
``step``, here ``step`` acts on a leading instance dimension written out:
every tensor it receives and returns carries ``n`` instances first.  A
network steps all instances of one block object with one call (the
paper's "prebuilt simulator per unique block").
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

Tree = Any


class Block:
    """Base class for hardware blocks.

    Subclasses define:
      in_ports:  sequence of input-port names
      out_ports: sequence of output-port names
      payload_words / payload_dtype: packet payload signature
      init_state(n, params=None, *, generator=None, device=None)
          -> state tree with leading (n,) dims; ``params`` has the same
          leading dim (stacked per-instance parameters) or is None.
      step(state, rx, tx_ready) -> (state, rx_ready, tx)
        rx:       {port: (payload (n, W), valid (n,))} — pre-cycle queue fronts
        tx_ready: {port: ready (n,)}                   — pre-cycle queue fullness
        rx_ready: {port: ready (n,)}                   — pop enables
        tx:       {port: (payload (n, W), valid (n,))} — push requests
    ``clock_divider``: this block's simulated clock runs 1/divider as fast
    as the network base clock (rate control, §II-C) — the block is only
    stepped on cycles where ``cycle % divider == 0``.
    """

    in_ports: Sequence[str] = ()
    out_ports: Sequence[str] = ()
    payload_words: int = 1
    payload_dtype: Any = None  # default float32, set in network
    clock_divider: int = 1

    # -- required overrides -------------------------------------------------
    def init_state(self, n: int, params: Tree = None, *,
                   generator: torch.Generator | None = None,
                   device=None) -> Tree:
        raise NotImplementedError

    def step(
        self,
        state: Tree,
        rx: Mapping[str, tuple[torch.Tensor, torch.Tensor]],
        tx_ready: Mapping[str, torch.Tensor],
    ) -> tuple[Tree, Mapping[str, torch.Tensor], Mapping[str, tuple[torch.Tensor, torch.Tensor]]]:
        raise NotImplementedError

    # -- identity -----------------------------------------------------------
    @property
    def type_name(self) -> str:
        return type(self).__name__
