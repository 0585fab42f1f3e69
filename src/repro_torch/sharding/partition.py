"""Sharding rules, as ``repro.sharding.partition``: logical parameter and
activation axes -> mesh partition specs.

The pure part of the reference, over the port's trees and a mesh that is
a mapping of axis names to sizes (``launch.mesh``):

  * ``Strategy``, ``param_specs``, ``batch_specs`` and
    ``decode_state_specs`` give, leaf for leaf, the entries of the
    reference's ``PartitionSpec``s as tuples (``P()`` is ``()``,
    ``P(None, 'data')`` is ``(None, 'data')``).  The rules match the
    reference's leaf paths: the port's dotted paths rendered with ``/``
    (``segments/0/1/mix/wq``), as ``_path_str`` renders the reference's;
  * ``local_shape`` and ``argument_bytes`` (new here) give a leaf's shard
    and the bytes one device holds of a tree under its specs, the sum the
    reference's ``memory_analysis().argument_size_in_bytes`` reports for a
    step's arguments;
  * ``make_constrain`` keeps the reference's signature.  The port has no
    SPMD partitioner and runs an LM on one card, so on a mesh of one
    device the hook resolves each spec as the reference does (raising
    where it would) and returns ``x`` unchanged, as XLA's constraint does
    on one device; a larger mesh raises ``NotImplementedError``.

``named_shardings`` is not ported: it places arrays on a JAX mesh.

Rules (FSDP x TP: the large matrices sharded over both axis groups):

  embed (V, d)          : (tp, dp)       vocab over model, d over data
  attn wq/wk/wv (d, HD) : (dp, tp)
  attn wo (HD, d)       : (tp, dp)
  mlp wi/wg (d, f)      : (dp, tp)
  mlp wo (f, d)         : (tp, dp)
  moe router (d, E)     : (dp, None)
  moe wi/wg (E, d, f)   : (tp, dp, None)  EP: experts over model
  moe wo (E, f, d)      : (tp, None, dp)
  rglru/mlstm/slstm mats: (dp, tp) input-major, (tp, dp) output-major
  norms / scalars       : replicated

An axis that does not divide its dim falls back to None; a leaf stacked
over stages gets a leading None.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping

from ..core.struct import tree_leaves, tree_map, tree_map_with_path
from ..models.layers import no_constraint
from ..optim.optimizer import AdamWState

Tree = Any
Mesh = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """How a given (arch, shape, mesh) is partitioned."""

    dp: tuple[str, ...] = ("data",)   # batch + FSDP axes
    tp: str | None = "model"          # tensor/expert axis
    seq_shard: bool = False           # Megatron-style sequence sharding (SP)
    fsdp: bool = True                 # shard the non-tp dim of matrices over dp

    def dp_size(self, mesh: Mesh) -> int:
        n = 1
        for a in self.dp:
            n *= mesh[a]
        return n

    def tp_size(self, mesh: Mesh) -> int:
        return mesh[self.tp] if self.tp else 1


def _canon(entry):
    """A 1-tuple of axes means the axis itself and an empty one None, as
    the reference's ``PartitionSpec`` holds its entries."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _div(n: int, axes, mesh: Mesh):
    """``axes`` if they evenly divide ``n``, else None."""
    if axes is None:
        return None
    size = 1
    for a in _axes(axes):
        size *= mesh[a]
    return axes if n % size == 0 else None


# --------------------------------------------------------------- params
_RULES: list[tuple[str, Any]] = [
    # (regex on 'path/like/this', axes of the leaf without its stage dim)
    (r"embed$", ("tp", "dp")),
    (r"lm_head$", ("dp", "tp")),
    (r"(norm1|norm2|final_norm).*scale$", (None,)),
    (r"mix/w[qkv]$", ("dp", "tp")),
    (r"mix/wo$", ("tp", "dp")),
    (r"mlp/(wi|wg)$", ("dp", "tp")),
    (r"mlp/wo$", ("tp", "dp")),
    (r"mlp/router$", ("dp", None)),
    (r"mlp/shared/(wi|wg)$", ("dp", "tp")),
    (r"mlp/shared/wo$", ("tp", "dp")),
    # rglru
    (r"mix/(wx|wg)$", ("dp", "tp")),
    (r"mix/conv$", (None, "tp")),
    (r"mix/(wa|wi)$", ("dp", "tp")),
    (r"mix/lam$", ("tp",)),
    (r"mix/wo$", ("tp", "dp")),
    # mlstm
    (r"mix/(w_up|w_gate)$", ("dp", "tp")),
    (r"mix/w_if$", ("dp", None)),
    (r"mix/w_down$", ("tp", "dp")),
    (r"mix/skip$", ("tp",)),
    (r"mix/b_if$", (None,)),
    # slstm
    (r"mix/(w|r)_[ifzo]$", ("dp", "tp")),
    (r"mix/b_[ifzo]$", (None,)),
    (r"mix/ff_(wi|wg)$", ("dp", "tp")),
    (r"mix/ff_wo$", ("tp", "dp")),
]

# MoE expert tensors (3-D) handled specially.
_MOE_3D = [
    (r"mlp/(wi|wg)$", ("tp", "dp", None)),
    (r"mlp/wo$", ("tp", None, "dp")),
]


def path_str(path: str) -> str:
    """A dotted tree path (``core.struct.tree_paths``) as the reference's
    ``_path_str`` renders the same leaf: ``segments/0/1/mix/wq``."""
    return path.replace(".", "/")


def param_specs(params_shapes: Tree, strategy: Strategy, mesh: Mesh) -> Tree:
    """A spec tuple for each leaf of a params tree (tensors, meta tensors
    included)."""

    def resolve(tag, dim):
        if tag == "dp":
            axes = strategy.dp if strategy.fsdp else None
        elif tag == "tp":
            axes = strategy.tp
        else:
            axes = tag
        return _div(dim, axes, mesh)

    def spec_for(path, leaf) -> tuple:
        ps = path_str(path)
        shape = tuple(leaf.shape)
        in_segments = "segments" in ps
        eff_shape = shape[1:] if in_segments else shape  # strip stage dim

        rules = _MOE_3D + _RULES if len(eff_shape) == 3 else _RULES
        for pat, axes in rules:
            if re.search(pat, ps):
                if len(axes) != len(eff_shape):
                    continue
                resolved = tuple(_canon(resolve(a, d)) for a, d in zip(axes, eff_shape))
                return (None,) + resolved if in_segments else resolved
        return ()  # replicate by default

    return tree_map_with_path(spec_for, params_shapes)


def opt_specs(param_spec_tree: Tree):
    """The optimizer state's specs: the moments shard like their params,
    the step counter is replicated (the reference's ``_opt_shardings``)."""
    return AdamWState(step=(), mu=param_spec_tree, nu=param_spec_tree)


# --------------------------------------------------------------- activations
def make_constrain(strategy: Strategy, mesh: Mesh | None, seq_len: int | None = None):
    """``constrain(x, kind)``: the reference's activation hook.  Without a
    mesh it is ``models.layers.no_constraint``.  On a mesh of one device
    the axes of ``strategy`` are looked up once, here (an axis missing from
    the mesh raises ``KeyError``, as the reference's first call does), and
    each call resolves the spec of ``kind`` for ``x`` as the reference does
    (a spec longer than ``x``'s rank raises ``ValueError``) and returns
    ``x`` unchanged, as XLA's constraint does on one device.  A mesh of
    more than one device raises ``NotImplementedError``: the port has no
    SPMD partitioner (README, the port's tooling)."""
    if mesh is None:
        return no_constraint
    if math.prod(mesh.values()) > 1:
        raise NotImplementedError(
            f"sharding over a mesh of {math.prod(mesh.values())} devices: the port "
            "runs an LM on one card and has no SPMD partitioner")
    dp, tp = strategy.dp, strategy.tp
    for axes in (dp, tp):
        _div(1, axes, mesh)
    ranks = {"activation": 3, "residual": 3, "dispatch": 4, "combine": 4, "logits": 3}

    def constrain(x, kind: str):
        if kind not in ranks or (kind in ("activation", "residual") and x.dim() != 3):
            return x
        if ranks[kind] > x.dim():
            raise ValueError(f"spec for {kind!r} has {ranks[kind]} entries, more than "
                             f"x's rank {x.dim()}")
        return x

    return constrain


# --------------------------------------------------------------- batch/cache
def batch_specs(cfg, shape, strategy: Strategy, mesh: Mesh) -> dict:
    """Input specs of a train batch."""
    dp = _canon(_div(shape.global_batch, strategy.dp, mesh))
    if cfg.input_mode == "embeddings":
        return {"inputs": (dp, None, None), "labels": (dp, None)}
    return {"inputs": (dp, None), "labels": (dp, None)}


def decode_state_specs(state_shapes: Tree, cfg, strategy: Strategy, mesh: Mesh) -> Tree:
    """Specs of the decode caches (stage-stacked): batch over dp; heads or
    features over tp, falling back to head_dim, then to replication."""

    def spec_for(path, leaf) -> tuple:
        shape = tuple(leaf.shape)
        ps = path_str(path)
        eff = shape[1:]  # decode states are always stacked over stages
        if len(eff) == 4 and ps.endswith(("k", "v")):  # (B, S, Hkv, hd)
            b, s, hkv, hd = eff
            tp_on_heads = _div(hkv, strategy.tp, mesh)
            tp_on_hd = _div(hd, strategy.tp, mesh) if tp_on_heads is None else None
            return (None, _canon(_div(b, strategy.dp, mesh)), None,
                    _canon(tp_on_heads), _canon(tp_on_hd))
        # recurrent states: (B, ...) — batch over dp, last dim over tp
        resolved = [None, _canon(_div(eff[0], strategy.dp, mesh))]
        resolved.extend(None for _ in eff[1:-1])
        if len(eff) > 1:
            resolved.append(_canon(_div(eff[-1], strategy.tp, mesh)))
        return tuple(resolved)

    return tree_map_with_path(spec_for, state_shapes)


# --------------------------------------------------------------- bytes
def local_shape(shape, spec: tuple, mesh: Mesh) -> tuple:
    """The shape of one device's shard of a leaf of ``shape`` under
    ``spec`` (an entry past the spec's length is unsharded; an axis that
    does not divide its dim gives the padded, ceiling, shard)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = 1
        for a in _axes(entry):
            n *= mesh[a]
        out.append(-(-int(dim) // n))
    return tuple(out)


def argument_bytes(tree: Tree, specs: Tree, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors or meta tensors) under
    ``specs`` (a spec tree of the same structure): the sum over the leaves
    of their local shards' bytes."""
    sizes = tree_map(lambda leaf, spec: math.prod(local_shape(leaf.shape, spec, mesh))
                     * leaf.element_size(), tree, specs)
    return int(sum(tree_leaves(sizes)))


__all__ = ["Strategy", "argument_bytes", "batch_specs", "decode_state_specs",
           "local_shape", "make_constrain", "opt_specs", "param_specs", "path_str"]
