"""Carry state and parameters across from the JAX package.

For this simulator the "weights" are the per-instance block parameters and
the engine state.  Both cross as numpy arrays, so this module imports
nothing of JAX:

  * ``params_from_numpy`` turns numpy parameter leaves (e.g. the JAX
    ``CoreParams`` fields) into the port's parameter dataclass;
  * ``fused_state_from_numpy`` / ``fused_state_to_numpy`` map a fused
    engine state to and from a dict of numpy arrays keyed by dotted field
    path (``"reg_val"``, ``"queues.buf"``, ``"block_states.0.acc"``,
    ``"credits.0"``, ``"cycle"``, ``"epoch"``), all in the global view —
    the layout the JAX ``FusedEngine`` keeps with ``batch_axes``; a grid
    engine built without params (the JAX ``FusedEngine.grid``) takes its
    group params as well;
  * ``graph_state_from_numpy`` / ``graph_state_to_numpy`` do the same for
    a ``GraphEngine`` (or ``GridEngine``) state (``"queues.buf"``,
    ``"block_states.0.acc"``, ``"credits.0"``, ``"cycle"``, ...), the JAX
    ``GraphState``'s leaves in its global view;
  * ``register_state_from_numpy`` / ``register_state_to_numpy`` do the
    same for a register engine state (``"cell.a_reg"``, ``"west_slab"``,
    ``"credit_e"``, ``"cycle"``, ...), leaves with leading ``(Dr, Dc)``
    tile dims — the JAX ``RegisterGridEngine`` layout on a ``(Dr, Dc)``
    mesh.

That lets a test start both packages from one state, including mid-run.
Tables are not state: the target engine builds its own.  A sharded
engine's state (``core.mesh.ShardedState``) crosses in the global layout
too — the reference's arrays with their leading real mesh dims, as
``jax.device_get`` of a placed state gives them — gathered from the
shards by ``*_to_numpy`` and placed onto them by ``*_from_numpy``.

For the LM stack the weights are the model's parameters, and the state is
the decode state:

  * ``lm_params_from_numpy`` maps the JAX ``init_params`` tree, flattened
    by dotted path (``"embed"``, ``"segments.0.2.mix.wq"``,
    ``"final_norm.scale"``; segment leaves keep their leading stage dim),
    onto the port's parameters.  bf16 leaves cross as f32 numpy arrays and
    are cast back here, which is exact;
  * ``lm_state_from_numpy`` does the same for a decode state
    (``"0.1.conv"``, ``"0.2.k"``: segment, pattern position, leaf), so a
    test can start both packages mid-decode.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.device import resolve_device, to_tensor
from .core.distributed import GraphEngine, GraphState
from .core.fastgrid import RegGridState, RegisterGridEngine
from .core.fused import FusedEngine, FusedState
from .core.mesh import unshard
from .core.struct import tree_map_with_path, tree_paths


def params_from_numpy(params_cls, arrays: Mapping[str, np.ndarray], device="cuda"):
    """``params_cls(**{field: tensor})`` from numpy leaves by field name, on
    ``device`` (``"cuda"`` by default; raises without CUDA — pass
    ``device="cpu"``)."""
    dev = resolve_device(device)
    return params_cls(**{k: to_tensor(v, dev) for k, v in arrays.items()})


#: LM parameter and state leaves that are f32 whatever the model dtype.
LM_F32_PARAMS = frozenset({"lam", "b_if", "b_i", "b_f", "b_z", "b_o", "router"})
LM_MODEL_DTYPE_STATE = frozenset({"conv", "k", "v"})


def _nest(flat: dict) -> dict:
    """{dotted path: leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def _seq(node: dict, cls=list):
    """A dict keyed "0", "1", ... -> ``cls`` of its values in order."""
    if sorted(node, key=int) != [str(i) for i in range(len(node))]:
        raise KeyError(f"expected keys 0..{len(node) - 1}, got {sorted(node)}")
    return cls(node[str(i)] for i in range(len(node)))


def lm_params_from_numpy(cfg, arrays: Mapping[str, np.ndarray], device="cuda") -> dict:
    """The port's parameters for ``cfg`` from the JAX ``init_params`` leaves
    by dotted path, on ``device`` (``"cuda"`` by default; raises without
    CUDA — pass ``device="cpu"``).  Leaves of ``LM_F32_PARAMS`` stay f32,
    every other one is cast to ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def leaf(path: str, arr) -> torch.Tensor:
        name = path.rsplit(".", 1)[-1]
        dt = torch.float32 if name in LM_F32_PARAMS else dtype
        return torch.tensor(np.asarray(arr, np.float32), device=dev).to(dt)

    tree = _nest({p: leaf(p, a) for p, a in arrays.items()})
    tree["segments"] = [_seq(seg, tuple) for seg in _seq(tree["segments"])]
    return tree


def lm_state_from_numpy(cfg, arrays: Mapping[str, np.ndarray], device="cuda") -> list:
    """A decode state (per segment, a tuple of stage-stacked per-layer
    dicts) from numpy leaves keyed ``"<segment>.<position>.<leaf>"``, on
    ``device``.  KV caches and conv carries take ``cfg.dtype``, the rest
    f32."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def leaf(path: str, arr) -> torch.Tensor:
        name = path.rsplit(".", 1)[-1]
        dt = dtype if name in LM_MODEL_DTYPE_STATE else torch.float32
        return torch.tensor(np.asarray(arr, np.float32), device=dev).to(dt)

    tree = _nest({p: leaf(p, a) for p, a in arrays.items()})
    return [_seq(seg, tuple) for seg in _seq(tree)]


def _from_numpy(template, arrays: Mapping[str, np.ndarray], device):
    """``template``'s tree holding ``arrays`` (by dotted path, dtypes and
    shapes of the template) on ``device``; extra keys are ignored."""
    missing = [p for p, _ in tree_paths(template) if p not in arrays]
    if missing:
        raise KeyError(f"state arrays missing {missing}")

    def take(path: str, leaf: torch.Tensor) -> torch.Tensor:
        arr = np.asarray(arrays[path])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(leaf.shape)}")
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return torch.tensor(arr.astype(np_dtype), device=device)

    return tree_map_with_path(take, template)


def _state_to_numpy(state) -> dict[str, np.ndarray]:
    """Every leaf of an engine state except its tables, by dotted path, in
    the global layout."""
    return {
        path: leaf.detach().cpu().numpy()
        for path, leaf in tree_paths(unshard(state).replace(tables=None))
    }


def fused_state_to_numpy(state: FusedState) -> dict[str, np.ndarray]:
    """Every leaf of a fused state except its tables, by dotted path."""
    return _state_to_numpy(state)


def fused_state_from_numpy(engine: FusedEngine,
                           arrays: Mapping[str, np.ndarray],
                           group_params: dict | None = None) -> FusedState:
    """A state of ``engine`` holding ``arrays`` (see ``fused_state_to_numpy``
    for the keys), on the engine's device.  Every leaf must be present with
    the engine's shape; extra keys (e.g. the source's tables) are ignored.
    ``group_params`` are the ``init`` overrides of an engine whose IR holds
    no params (the JAX ``FusedEngine.grid``'s stacked cell params, from
    ``params_from_numpy``)."""
    template = unshard(engine.init(0, group_params=group_params))
    body = _from_numpy(template.replace(tables=None), arrays, engine.device)
    return engine.place(body.replace(tables=template.tables))


def graph_state_to_numpy(state: GraphState) -> dict[str, np.ndarray]:
    """Every leaf of a graph engine state except its tables, by dotted path."""
    return _state_to_numpy(state)


def graph_state_from_numpy(engine: GraphEngine,
                           arrays: Mapping[str, np.ndarray],
                           group_params: dict | None = None) -> GraphState:
    """A state of ``engine`` (a ``GraphEngine`` or ``GridEngine``) holding
    ``arrays`` (see ``graph_state_to_numpy`` for the keys), on the engine's
    device.  Every leaf must be present with the engine's shape; extra keys
    are ignored.  ``group_params`` are the ``init`` overrides of an engine
    whose IR holds no params (a ``GridEngine``'s flat cell params)."""
    template = unshard(GraphEngine.init(engine, 0, group_params=group_params))
    body = _from_numpy(template.replace(tables=None), arrays, engine.device)
    return engine.place(body.replace(tables=template.tables))


def register_state_to_numpy(state: RegGridState) -> dict[str, np.ndarray]:
    """Every leaf of a register engine state, by dotted path, in the
    global layout."""
    return {path: leaf.detach().cpu().numpy()
            for path, leaf in tree_paths(unshard(state))}


def register_state_from_numpy(engine: RegisterGridEngine,
                              arrays: Mapping[str, np.ndarray]) -> RegGridState:
    """A state of ``engine`` holding ``arrays`` (see
    ``register_state_to_numpy`` for the keys), on the engine's device.
    Every leaf must be present with the engine's shape."""
    zeros = (np.zeros((engine.M, engine.R), np.float32),
             np.zeros((engine.R, engine.C), np.float32))
    return engine.place(_from_numpy(unshard(engine.init(*zeros)), arrays,
                                    engine.device))
