"""Step builders, as ``repro.launch.steps``: the train step, the abstract
trees of a cell and the step of a cell.

``abstract_*`` build the reference's ``jax.eval_shape`` trees as tensors
on the ``meta`` device: shapes and dtypes, nothing allocated or drawn.
``cell_step`` takes the place of the reference's ``jit_train_step``,
``jit_prefill``, ``jit_decode_step`` and ``lower_cell``: it returns the
eager step of the cell's kind and its inputs on a device.  Nothing is
jitted; capturing the LM steps into CUDA graphs is ROADMAP's P1.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..configs.registry import ShapeSpec
from ..core.device import resolve_device
from ..core.struct import tree_leaves, tree_map
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.optimizer import AdamW, AdamWState
from ..sharding import partition as SP

Tree = Any


# ------------------------------------------------------------- abstractions
def abstract_params(cfg: ModelConfig) -> Tree:
    return M.init_params(cfg, device="meta")


def abstract_opt_state(cfg: ModelConfig, opt: AdamW, params_shapes: Tree) -> AdamWState:
    return opt.init(params_shapes)


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec, batch: int | None = None) -> dict:
    """A train batch's leaves; ``batch`` rows in place of the shape's
    global batch where given."""
    b, s = batch or shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        inputs = torch.empty((b, s, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                             device="meta")
    else:
        inputs = torch.empty((b, s), dtype=torch.int32, device="meta")
    return {"inputs": inputs, "labels": torch.empty((b, s), dtype=torch.int32,
                                                    device="meta")}


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int) -> list:
    return M.init_decode_state(cfg, batch, max_seq, "meta")


# ------------------------------------------------------------- train step
def value_and_grad(cfg: ModelConfig, params: Tree, batch: dict,
                   constrain: Callable | None = None):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), grads a tree shaped like ``params`` (zeros for a leaf the loss
    does not reach)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = M.loss_fn(params, cfg, batch, constrain or M.no_constraint)
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

    ``constrain`` is the reference's sharding hook; the port's
    ``sharding.partition.make_constrain`` builds one for a mesh of one
    device (it resolves each spec and leaves the tensor as it is)."""

    def train_step(params: Tree, opt_state: AdamWState, batch: dict):
        (loss, metrics), grads = value_and_grad(cfg, params, batch, constrain)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------- cell steps
STEP_KINDS = {"train": "train_step", "prefill": "prefill", "decode": "serve_step"}


def cell_step(cfg: ModelConfig, shape: ShapeSpec, mesh, strategy: SP.Strategy,
              device="cuda", *, batch: int | None = None, seed: int = 0,
              opt: AdamW | None = None):
    """The eager step of the cell ``(cfg, shape)`` and its inputs on
    ``device``: (step, args, kind), ``step(*args)`` one train step
    (``train_step(params, opt_state, batch)``, which updates ``params``
    and the moments in place), one ``prefill(params, inputs)`` at
    ``max_seq = seq_len`` or one ``serve_step(params, states, token,
    pos)`` at the last position of a ``seq_len`` cache.  Random weights,
    tokens (or embeddings) and labels from ``seed``; ``batch`` rows in
    place of the shape's global batch where given.  The constrain hook is
    built for ``mesh`` and ``strategy`` (a mesh of one device)."""
    dev = resolve_device(device)
    b, s = batch or shape.global_batch, shape.seq_len
    kind = STEP_KINDS[shape.step]
    constrain = SP.make_constrain(strategy, mesh,
                                  seq_len=None if shape.step == "decode" else s)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = M.init_params(cfg, seed, device=dev)

    def tokens(*lead):
        return torch.randint(0, cfg.vocab, lead, generator=gen, device=dev,
                             dtype=torch.int32)

    def inputs():
        if cfg.input_mode == "embeddings":
            return torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                               dtype=getattr(torch, cfg.dtype))
        return tokens(b, s)

    if shape.step == "train":
        opt = opt or AdamW()
        return (make_train_step(cfg, opt, constrain),
                (params, opt.init(params), {"inputs": inputs(), "labels": tokens(b, s)}),
                kind)
    if shape.step == "prefill":
        @torch.no_grad()
        def prefill_step(params, inputs):
            return M.prefill(params, cfg, inputs, max_seq=s, constrain=constrain)

        return prefill_step, (params, inputs()), kind

    @torch.no_grad()
    def serve_step(params, states, token, pos):
        return M.decode_step(params, cfg, states, token, pos, constrain=constrain)

    states = M.init_decode_state(cfg, b, s, dev)
    return serve_step, (params, states, tokens(b), s - 1), kind


__all__ = ["STEP_KINDS", "abstract_batch", "abstract_decode_state", "abstract_opt_state",
           "abstract_params", "cell_step", "make_train_step", "value_and_grad"]
