"""Frozen dataclasses of tensors and a small tree-map helper.

The counterpart of ``repro.core.struct.pytree_dataclass``: every core data
structure (queues, block states, engine state) is a frozen dataclass whose
fields are tensors, nested dataclasses, tuples, lists or dicts.  Fields
declared with ``static_field`` are configuration (a queue's capacity) and
are copied, not mapped.  ``tree_map`` walks any such tree; ``tree_paths``
names every leaf by its dotted field path (``"queues.buf"``,
``"block_states.0.acc"``), the key ``repro_torch.convert`` uses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

_T = TypeVar("_T")


def tensor_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: freeze ``cls`` and give it ``replace`` (like a pytree
    dataclass).  Fields are tree children unless declared with
    ``static_field``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls._data_fields = tuple(
        f.name for f in fields if not f.metadata.get("static", False)
    )

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def static_field(**kwargs: Any) -> Any:
    """A dataclass field that tree maps copy instead of visiting."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def _is_node(x: Any) -> bool:
    return hasattr(type(x), "_data_fields") and dataclasses.is_dataclass(x)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over one or more trees of the same shape.
    ``None`` is an empty subtree and maps to ``None``."""
    if tree is None:
        return None
    if _is_node(tree):
        return tree.replace(**{
            n: tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest))
            for n in type(tree)._data_fields
        })
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(dotted path, leaf), ...]`` in field order."""
    if tree is None:
        return []
    if _is_node(tree):
        items = [(n, getattr(tree, n)) for n in type(tree)._data_fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    else:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for name, sub in items:
        out.extend(tree_paths(sub, f"{prefix}.{name}" if prefix else name))
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's dotted
    path (the names ``tree_paths`` gives)."""
    if tree is None:
        return None
    join = (lambda name: f"{prefix}.{name}" if prefix else name)  # noqa: E731
    if _is_node(tree):
        return tree.replace(**{
            n: tree_map_with_path(fn, getattr(tree, n), join(n))
            for n in type(tree)._data_fields
        })
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, join(str(i)))
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(str(k))) for k, v in tree.items()}
    return fn(prefix, tree)


def tree_leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in tree_paths(tree)]
