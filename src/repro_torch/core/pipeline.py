"""Pipeline parallelism as a Switchboard network, as ``repro.core.pipeline``.

Pipeline *stages are blocks* and the stage-to-stage activation stream is a
latency-insensitive *channel*: a GPipe fill/drain wavefront of ``M + S - 1``
ticks, each moving every microbatch one hop, a stage computing where a
microbatch is present (the valid handshake).  Stage 0 is fed microbatch
``x[clip(t)]``, a stage not yet (or no longer) active holds zeros, and the
last stage collects the finished microbatches.

The reference runs the ticks inside ``shard_map``, the hop a ``ppermute``.
The port keeps a single controller (``core/mesh.py``): stage ``s`` is shard
``s``, its parameters and activations on its own device (one card may hold
every stage), and the hop is a copy to the next stage's device.  The
backward needs no code of its own: autograd through the tick loop reverses
the hops, the mirrored drain/fill wavefront.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .device import shard_devices
from .mesh import ShardedState, split
from .struct import tree_map

Tree = Any


class Pipeline:
    """Run ``stage_fn`` as an S-stage pipeline over ``mesh[axis]`` stages.

    ``stage_fn(stage_params, h) -> h'`` keeps h's shape (the homogeneous
    stage pipeline: embedding and head live outside).  Stage s holds
    ``params[s]`` of leaves stacked on a leading S dim, or shard s of
    :meth:`place`'s ``ShardedState``.  ``device`` is one device for every
    stage or one a stage (``core.device.shard_devices``)."""

    def __init__(self, stage_fn: Callable, mesh: dict, axis: str = "stage",
                 device="cuda"):
        self.stage_fn = stage_fn
        self.axis = axis
        self.S = int(mesh[axis])
        self.devices = shard_devices(device, self.S)

    def place(self, stage_params: Tree) -> ShardedState:
        """Stacked parameters as one state a stage, each on its stage's
        device (``jax.device_put`` against :func:`stage_shardings`)."""
        if isinstance(stage_params, ShardedState):
            return stage_params
        return split(stage_params, (self.S,), self.devices)

    def _stage(self, stage_params: Tree, s: int) -> Tree:
        if isinstance(stage_params, ShardedState):
            return tree_map(lambda p: p[0], stage_params.shards[s])
        return tree_map(lambda p: p[s].to(self.devices[s]), stage_params)

    def __call__(self, stage_params: Tree, x: torch.Tensor) -> torch.Tensor:
        """x: (M, mb, ...) microbatches -> (M, mb, ...) outputs on x's
        device."""
        S, M = self.S, x.shape[0]
        params = [self._stage(stage_params, s) for s in range(S)]
        h = [torch.zeros(x.shape[1:], dtype=x.dtype, device=d) for d in self.devices]
        outs: list = [None] * M
        for t in range(M + S - 1):
            # the channel hop: stage s receives stage s - 1's last output;
            # stage 0 loads its microbatch instead
            h_in = [x[min(t, M - 1)].to(self.devices[0])] + [
                h[s - 1].to(self.devices[s]) for s in range(1, S)]
            for s in range(S):
                m = t - s
                active = 0 <= m < M
                h[s] = (self.stage_fn(params[s], h_in[s]) if active
                        else torch.zeros_like(h_in[s]))
                if active and s == S - 1:
                    outs[m] = h[s]
        return torch.stack([o.to(x.device) for o in outs])


def stage_shardings(devices: Sequence, params_stacked: Tree) -> Tree:
    """Each leaf's placement: the stage devices along its leading dim (the
    reference's ``NamedSharding(mesh, P(axis))`` a leaf)."""
    devs = tuple(torch.device(d) for d in devices)
    return tree_map(lambda _: devs, params_stacked)


__all__ = ["Pipeline", "stage_shardings"]
