"""Checkpointing: atomic, async-capable, template-checked (the port's
``repro.checkpoint.checkpointing``, with the same on-disk layout).

Layout per step::

    <dir>/step_<N>.tmp/      (written, then atomically renamed)
    <dir>/step_<N>/
        tree.json            leaf paths + dtypes + metadata
        arrays.npz           all leaves (copied to the host)

A tree is flattened with ``core.struct.tree_paths``; its dotted leaf
paths go into ``tree.json`` where the reference writes its treedef
string, and ``restore`` refuses a checkpoint whose paths, leaf count or
shapes differ from its template's.  A checkpoint of the JAX package (a
treedef, no paths) restores only on request (``from_reference``, as the
trainer asks) and where the template renders to the same treedef
(``reference_treedef``), its leaves read in the reference's flatten
order.  numpy has no bfloat16: such a leaf is stored as its raw
``uint16`` bits with ``"bfloat16"`` recorded as its dtype, as the
reference stores an ml_dtypes leaf.

  * ``save_async`` copies the leaves to the host on the caller's thread,
    so a later in-place update of the live tensors cannot reach the
    checkpoint; only the write runs on the background thread.  A failure
    mid-write never corrupts the latest checkpoint (tmp + rename).
  * ``restore`` puts each leaf on its template leaf's device, as its dtype.
  * ``keep_last`` garbage-collects old steps.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from ..core.struct import tree_map, tree_paths

Tree = Any
_executor = ThreadPoolExecutor(max_workers=1)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array (bf16 as its uint16 bits)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _jsonable(obj):
    """Coerce checkpoint metadata to plain JSON types (numpy scalars and
    arrays sneak in via the session's port buffers)."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def save(path: str, step: int, tree: Tree, meta: dict | None = None,
         keep_last: int = 3) -> str:
    """Synchronous checkpoint write. Returns the final directory."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    items = tree_paths(tree)
    dtypes = [_dtype_name(x) for _, x in items]
    host_leaves = [_to_host(x) for _, x in items]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(host_leaves)})
    spec = {
        "n_leaves": len(host_leaves),
        "dtypes": dtypes,
        "paths": [p for p, _ in items],
        "step": step,
        "meta": _jsonable(meta or {}),
    }
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(spec, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep_last)
    return final


def save_async(path: str, step: int, tree: Tree, meta: dict | None = None,
               keep_last: int = 3) -> Future:
    """Asynchronous save: the leaves are copied to the host now (so the
    caller may update the live tensors in place at once) and written on
    a background thread.  Returns the write's future."""
    host = tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else np.array(x), tree)
    return _executor.submit(save, path, step, host, meta, keep_last)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(path: str, template: Tree, step: int | None = None,
            from_reference: bool = False) -> tuple[Tree, dict]:
    """Restore into the structure of ``template``: each leaf goes to its
    template leaf's device, as its dtype.  Returns (tree, meta).  Raises
    ``ValueError`` where the checkpoint's leaf count, paths or shapes
    differ from the template's.  A checkpoint of the JAX package is
    refused unless ``from_reference``, and then read only where its
    treedef is the template's ``reference_treedef``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    final = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(final, "tree.json")) as f:
        spec = json.load(f)
    reference = "paths" not in spec
    if reference:
        # the JAX package writes its treedef string: its leaves are read
        # only on request, and only where the template renders to the
        # same string, in the reference's order
        want = reference_treedef(template) if from_reference else None
        if want is None or spec.get("treedef") != want:
            raise ValueError(
                f"{final} has no leaf paths (a checkpoint of the JAX package, "
                f"which records {'a treedef' if 'treedef' in spec else 'none'}"
                + ("" if want is None else f" other than the template's {want!r}")
                + "); carry a reference state across with repro_torch.convert's "
                "*_state_from_numpy instead")
    t_paths = [p for p, _ in tree_paths(template)]
    if len(t_paths) != spec["n_leaves"]:
        raise ValueError(
            f"checkpoint has {spec['n_leaves']} leaves, template {len(t_paths)}"
        )
    if not reference and spec["paths"] != t_paths:
        bad = next(i for i, (a, b) in enumerate(zip(spec["paths"], t_paths)) if a != b)
        raise ValueError(f"tree mismatch at leaf {bad}: checkpoint "
                         f"{spec['paths'][bad]!r}, template {t_paths[bad]!r}")
    with np.load(os.path.join(final, "arrays.npz")) as data:
        saved = [data[f"a{i}"] for i in range(spec["n_leaves"])]
    it = iter(zip(saved, spec["dtypes"]))

    def put(tmpl):
        a, dtype = next(it)
        if a.shape != tuple(np.shape(tmpl)):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(np.shape(tmpl))}")
        if isinstance(tmpl, torch.Tensor):
            return _from_host(a, dtype).to(device=tmpl.device, dtype=tmpl.dtype)
        return a.astype(np.asarray(tmpl).dtype)

    fill = _map_sorted if reference else tree_map
    return fill(put, template), spec["meta"]


# ------------------------------------------------- the JAX package's trees
def reference_treedef(tree: Tree) -> str:
    """``str(jax.tree.structure(tree))`` of the JAX package's counterpart
    of ``tree``: dicts with sorted keys, lists, tuples, and the dataclasses
    that name their reference node (``reference_node``, e.g. the
    optimizer state's ``"namedtuple[AdamWState]"``); a leaf is ``*``.
    Raises ``ValueError`` for a node with no reference form."""
    def render(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {render(x[k])}" for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(render(v) for v in x) + "]"
        if isinstance(x, tuple):
            body = ", ".join(render(v) for v in x)
            return f"({body},)" if len(x) == 1 else f"({body})"
        node = getattr(type(x), "reference_node", None)
        if node is not None:
            kids = ", ".join(render(getattr(x, n)) for n in type(x)._data_fields)
            return f"CustomNode({node}, [{kids}])"
        if hasattr(type(x), "_data_fields"):
            raise ValueError(f"{type(x).__name__} has no reference pytree node")
        return "*"

    return f"PyTreeDef({render(tree)})"


def _map_sorted(fn, tree: Tree) -> Tree:
    """``tree_map(fn, tree)`` visiting the leaves in the JAX package's
    flatten order (dict keys sorted); the structure is ``tree``'s own."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_sorted(fn, v) for v in tree)
    if hasattr(type(tree), "_data_fields"):
        return tree.replace(**{n: _map_sorted(fn, getattr(tree, n))
                               for n in type(tree)._data_fields})
    return fn(tree)


def _gc(path: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(path) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(path, d))


__all__ = ["latest_step", "reference_treedef", "restore", "save", "save_async"]
