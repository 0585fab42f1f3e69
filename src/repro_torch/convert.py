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
    the layout the JAX ``FusedEngine`` keeps with ``batch_axes``.

That lets a test start both packages from one state, including mid-run.
Tables are not state: the target engine builds its own.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.device import to_tensor
from .core.fused import FusedEngine, FusedState
from .core.struct import tree_map_with_path, tree_paths


def params_from_numpy(params_cls, arrays: Mapping[str, np.ndarray], device="cpu"):
    """``params_cls(**{field: tensor})`` from numpy leaves by field name."""
    return params_cls(**{k: to_tensor(v, device) for k, v in arrays.items()})


def fused_state_to_numpy(state: FusedState) -> dict[str, np.ndarray]:
    """Every leaf of a fused state except its tables, by dotted path."""
    return {
        path: leaf.detach().cpu().numpy()
        for path, leaf in tree_paths(state.replace(tables=None))
    }


def fused_state_from_numpy(engine: FusedEngine,
                           arrays: Mapping[str, np.ndarray]) -> FusedState:
    """A state of ``engine`` holding ``arrays`` (see ``fused_state_to_numpy``
    for the keys), on the engine's device.  Every leaf must be present with
    the engine's shape; extra keys (e.g. the source's tables) are ignored."""
    template = engine.init(0)
    missing = [p for p, _ in tree_paths(template.replace(tables=None))
               if p not in arrays]
    if missing:
        raise KeyError(f"state arrays missing {missing}")

    def take(path: str, leaf: torch.Tensor) -> torch.Tensor:
        arr = np.asarray(arrays[path])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(leaf.shape)}")
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return torch.tensor(arr.astype(np_dtype), device=engine.device)

    body = tree_map_with_path(take, template.replace(tables=None))
    return body.replace(tables=template.tables)
