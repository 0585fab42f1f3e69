"""Sharded engine states: the port's counterpart of a state placed on a
``jax.sharding.Mesh`` (``repro.core.distributed.GraphEngine.place``).

The reference shards every state leaf over its leading *real* mesh axes
and runs one program on the whole mesh (``shard_map``).  The port keeps a
single controller: one Python process holds every shard, and shard ``r``
(row-major over the real axes) is its own set of tensors on its own
device, in the single-shard layout (the real dims of size 1).  Each
shard's epoch launches its own kernels; what crosses shards is a copy
from the sender's tensor into the receiver's — device-local when the two
share a card, a peer copy across cards — and a receiver with no sender
gets zeros, as ``jax.lax.ppermute`` gives it.

:func:`gather` assembles shards into the reference's global layout (the
leading real dims, as ``jax.device_get`` of a placed reference state
gives them); :func:`split` is its inverse, the body of
:meth:`Placement.place`, which the sharded engines share with the rest
of their placement (``shardings``, the per-shard view of a state).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .struct import static_field, tensor_dataclass, tree_map

Tree = Any


@tensor_dataclass
class ShardedState:
    """An engine state split over the real mesh axes: ``shards[r]`` is
    shard ``r``'s state (row-major over ``real_shape``), its leaves with
    leading dims ``(1,) * len(real_shape)``.  ``cycle`` and ``epoch`` read
    shard 0's, as every granule steps in lockstep."""

    shards: tuple
    real_shape: tuple = static_field(default=())

    @property
    def cycle(self):
        return self.shards[0].cycle

    @property
    def epoch(self):
        return self.shards[0].epoch


def split(state: Tree, real_shape: Sequence[int], devices: Sequence) -> ShardedState:
    """A global-layout state (leaves with leading ``real_shape`` dims) as
    one state a shard, each leaf copied to its own tensor on its shard's
    device."""
    real_shape = tuple(int(s) for s in real_shape)
    nd, n = len(real_shape), int(np.prod(real_shape))

    def take(r):
        def leaf(x):
            rest = tuple(x.shape[nd:])
            part = x.reshape((n,) + rest)[r].reshape((1,) * nd + rest)
            return torch.empty(part.shape, dtype=x.dtype,
                               device=devices[r]).copy_(part)
        return leaf

    return ShardedState(shards=tuple(tree_map(take(r), state) for r in range(n)),
                        real_shape=real_shape)


def gather(parts: Sequence[Tree], real_shape: Sequence[int],
           device="cpu") -> Tree:
    """Per-shard trees (leaves with leading ``(1,) * nd`` dims) assembled
    into the global layout on ``device``."""
    real_shape = tuple(int(s) for s in real_shape)
    nd = len(real_shape)

    def leaf(*xs):
        body = [x.reshape(x.shape[nd:]).to(device) for x in xs]
        return torch.stack(body).reshape(real_shape + tuple(body[0].shape))

    return tree_map(leaf, parts[0], *parts[1:])


class Placement:
    """Where an engine's shards live, for an engine with ``_sharded``
    (more than one shard), ``real_shape``, ``devices`` (one a shard) and
    ``device``: the counterpart of the reference's ``shardings``/``place``,
    and the per-shard view the engine's runs take."""

    def shardings(self) -> tuple:
        """The device of each shard, row-major over the real axes."""
        return self.devices

    def place(self, state):
        """A state in the global layout (every leaf with the leading real
        dims, on any device) as the engine runs it: split into one state a
        shard, each on its own device (:class:`ShardedState`), when there
        are several shards, else on the engine's device.  A placed state
        passes through."""
        if isinstance(state, ShardedState):
            return state
        if self._sharded:
            return split(state, self.real_shape, self.devices)
        return tree_map(lambda x: x.to(self.device), state)

    def _shards(self, state) -> tuple:
        """The per-shard states of ``state`` (one on an unsharded engine)."""
        return self.place(state).shards if self._sharded else (state,)

    def _join(self, shards):
        """The engine state of per-shard states (inverse of ``_shards``)."""
        if self._sharded:
            return ShardedState(shards=tuple(shards), real_shape=self.real_shape)
        return shards[0]


def all_shards(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """() bool on the first shard's device: every shard's () bool flag
    holds (the reference's ``psum`` of not-done over the real axes).  No
    host read."""
    if len(flags) == 1:
        return flags[0]
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def require_one_card(devices: Sequence) -> None:
    """Raise ``NotImplementedError`` where shards lie on several cards:
    the device loop captures an until-run into one CUDA graph, which holds
    one card's work (``run_epochs`` runs such shards)."""
    cards = {d for d in devices if d.type == "cuda"}
    if len(cards) > 1:
        raise NotImplementedError(
            f"run_until on shards over {len(cards)} cards: one CUDA graph holds "
            "one card's work, so the device loop cannot capture this state "
            "(ROADMAP.md: the mesh's until-run on several cards is open); "
            "run_epochs runs it, or place every shard on one card")


def unshard(state: Tree) -> Tree:
    """``state`` in the global layout: a :class:`ShardedState` gathered to
    the CPU, any other state as it is."""
    if isinstance(state, ShardedState):
        return gather(state.shards, state.real_shape)
    return state


__all__ = ["Placement", "ShardedState", "all_shards", "gather", "require_one_card",
           "split", "unshard"]
