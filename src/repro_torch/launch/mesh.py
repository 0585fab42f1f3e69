"""Meshes, as ``repro.launch.mesh``.

A mesh here is a mapping of axis names to sizes, the form the port's
engines take (``GraphEngine(mesh=...)``, ``GridEngine(mesh=...)``) and the
form ``sharding.partition`` reads (``mesh[axis]``).  Axis semantics follow
the reference: ``data`` and ``model`` are the intra-pod axes, ``pod`` the
inter-pod tier; ``gr``/``gc`` tile the manycore grid.  A mapping names a
layout and holds no device: the port runs an LM on one card
(``make_host_mesh``), and the production meshes feed the specs and the
per-device byte counts of ``launch.dryrun``.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """{"data": 16, "model": 16}, or with ``multi_pod`` {"pod": 2, "data":
    16, "model": 16}: the reference's 256- and 512-chip meshes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_grid_mesh(rows: int, cols: int) -> dict[str, int]:
    """The manycore grid's device tiling (granule tiles)."""
    return {"gr": rows, "gc": cols}


def make_host_mesh() -> dict[str, int]:
    """The one card: {"data": 1, "model": 1}."""
    return {"data": 1, "model": 1}


def mesh_size(mesh) -> int:
    """Devices a mesh spans: the product of its axis sizes."""
    n = 1
    for size in mesh.values():
        n *= int(size)
    return n


__all__ = ["make_grid_mesh", "make_host_mesh", "make_production_mesh", "mesh_size"]
