"""AdamW with a warmup-cosine schedule and global-norm clipping, as
``repro.optim.optimizer``.

``init(params)`` builds the state, ``update(grads, state, params)`` applies
one step and returns (params, new state, metrics).  The moments are f32
whatever the parameters' dtype; the update runs in f32 on the f32 parameter
and is cast back, with the reference's order of operations.  The update is
in place, under ``torch.no_grad``: ``params``, ``mu`` and ``nu`` are
overwritten (the trainer replays from checkpoints, so it never needs the
old values back).

:class:`AdamWState` flattens as the reference's ``AdamWState`` (step, mu,
nu) does, and ``checkpoint/checkpointing.py`` renders it as the same
pytree node, so a checkpoint written by the JAX trainer restores into it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.struct import tensor_dataclass, tree_leaves, tree_map

Tree = Any


@tensor_dataclass
class AdamWState:
    """step: () int32; mu, nu: f32 trees shaped like the parameters."""

    step: torch.Tensor
    mu: Any
    nu: Any

    #: the reference's pytree node, as ``jax.tree.structure`` prints it
    #: (``checkpointing.reference_treedef``)
    reference_node = "namedtuple[AdamWState]"


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a () tensor), in f32: linear warmup
        to ``lr``, then a cosine down to ``min_lr_ratio * lr``."""
        step = step.to(torch.float32)
        warm = step / max(self.warmup_steps, 1)
        decay_t = (step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1)
        decay_t = decay_t.clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                                  device=step.device) * decay_t))
        cos = self.min_lr_ratio + (1.0 - self.min_lr_ratio) * cos
        return self.lr * torch.where(step < self.warmup_steps, warm, cos)

    def init(self, params: Tree) -> AdamWState:
        first = tree_leaves(params)[0]
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                          mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree):
        """One step, in place on ``params``, ``state.mu`` and ``state.nu``:
        returns (params, the state with its step advanced, {"grad_norm",
        "lr"} as () f32 tensors)."""
        g_leaves = tree_leaves(grads)
        gnorm = torch.zeros((), dtype=torch.float32, device=g_leaves[0].device)
        for g in g_leaves:
            gf = g.to(torch.float32)
            gnorm = gnorm + (gf * gf).sum()
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        step = state.step + 1
        lr = self.schedule(step)
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.tensor(self.b1, dtype=torch.float32, device=step.device) ** stepf
        b2c = 1.0 - torch.tensor(self.b2, dtype=torch.float32, device=step.device) ** stepf
        for p, g, m, v in zip(tree_leaves(params), g_leaves, tree_leaves(state.mu),
                              tree_leaves(state.nu)):
            gf = g.to(torch.float32) * scale
            m.copy_(self.b1 * m + (1 - self.b1) * gf)
            v.copy_(self.b2 * v + (1 - self.b2) * gf * gf)
            pf = p.to(torch.float32)
            u = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) + self.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
        return params, state.replace(step=step), {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamW", "AdamWState"]
