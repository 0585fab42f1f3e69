"""Step builders, as ``repro.launch.steps``: the train step.

The reference's ``abstract_*``, ``jit_*`` and ``lower_cell`` build jitted,
sharded steps for its dry-run; they have no counterpart here yet.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.struct import tree_leaves, tree_map
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.optimizer import AdamW, AdamWState

Tree = Any


def value_and_grad(cfg: ModelConfig, params: Tree, batch: dict):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), grads a tree shaped like ``params`` (zeros for a leaf the loss
    does not reach)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = M.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    constrain: Callable | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, then one AdamW update (in
    place on ``params`` and the moments).  ``metrics``: ``nll``, ``z_loss``,
    ``moe_aux``, ``grad_norm``, ``lr`` and ``loss``, () tensors.

    ``constrain`` is the reference's sharding hook; a port of
    ``sharding/partition.py`` has not been decided, so one that is given
    raises ``NotImplementedError``."""
    if constrain is not None:
        raise NotImplementedError(
            "sharding constraints: the port has no sharding/partition.py yet")

    def train_step(params: Tree, opt_state: AdamWState, batch: dict):
        (loss, metrics), grads = value_and_grad(cfg, params, batch)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


__all__ = ["make_train_step", "value_and_grad"]
