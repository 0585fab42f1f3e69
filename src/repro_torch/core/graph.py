"""Channel-graph intermediate representation, as in ``repro.core.graph``.

The IR sits between the user-facing ``Network`` builder and every execution
backend.  It is a flat, engine-agnostic table of

    (block group, instance slot, port)  ->  channel id

plus the channel endpoint table and the external-port maps.  Everything is
plain numpy — no tensors, no device state — so a graph can be built once
and handed to any engine:

    NetworkSim           interprets the whole graph as one netlist
                         (``repro_torch.core.network``),
    FusedEngine          partitions instances into granules, lowers the
                         intra-granule channels onto depth-1 registers and
                         runs the epoch-batched protocol over arbitrary
                         granule adjacency (``repro_torch.core.fused``).

Conventions shared by all consumers:

  * Channel ids 0 and 1 are sentinels: ``NULL_RX`` (reads never valid) and
    ``NULL_TX`` (writes always accepted and dropped).  Unwired input ports
    map to ``NULL_RX``; unwired output ports map to ``NULL_TX``.
  * Instances of the same ``Block`` *object* form one group and are stepped
    by a single batched call (the paper's "one prebuilt simulator per
    unique block", §III-F).  ``rx_idx[g][i, p]`` / ``tx_idx[g][i, p]`` give
    the channel driven by member ``i``'s ``p``-th in/out port.
  * Channels are SPSC: each channel has exactly one producer port and one
    consumer port (checked at build time).

The numbering of every table equals the JAX package's on the same build,
so states of the two packages compare leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .block import Block
from .struct import tree_map

Tree = Any

NULL_RX = 0
NULL_TX = 1
_N_SENTINELS = 2


def _dtype_str(dtype: Any) -> str:
    """numpy-style type string (``"<f4"``) of a torch or numpy dtype, so
    granule signatures read as they do in the JAX package."""
    if dtype is None:
        return "f4"
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype.str
    return np.dtype(dtype).str


@dataclasses.dataclass
class GroupDef:
    """One unique block type and its instances (in instantiation order)."""

    block: Block
    members: np.ndarray  # (n_m,) int32 global instance ids
    names: tuple[str, ...]
    params: Tree | None  # stacked per-member params (leading n_m dim) or None

    @property
    def n_members(self) -> int:
        return int(self.members.shape[0])


class ChannelGraph:
    """Flat channel-graph IR — the single source of truth for all engines."""

    NULL_RX = NULL_RX
    NULL_TX = NULL_TX

    def __init__(
        self,
        *,
        payload_words: int,
        dtype: Any,
        capacity: int,
        groups: list[GroupDef],
        rx_idx: list[np.ndarray],
        tx_idx: list[np.ndarray],
        chan_src: np.ndarray,
        chan_dst: np.ndarray,
        ext_in: Mapping[str, int],
        ext_out: Mapping[str, int],
    ):
        self.payload_words = payload_words
        self.dtype = dtype
        self.capacity = capacity
        self.groups = groups
        self.rx_idx = rx_idx  # per group: (n_m, n_in) int32 global channel ids
        self.tx_idx = tx_idx  # per group: (n_m, n_out) int32 global channel ids
        self.chan_src = np.asarray(chan_src, np.int32)  # (n_channels,) inst or -1
        self.chan_dst = np.asarray(chan_dst, np.int32)  # (n_channels,) inst or -1
        self.ext_in = dict(ext_in)  # name -> channel id (host pushes)
        self.ext_out = dict(ext_out)  # name -> channel id (host pops)
        self.n_channels = int(self.chan_src.shape[0])
        self.n_instances = sum(g.n_members for g in groups)
        # instance id -> (group index, slot within group)
        self.inst_loc = np.zeros((self.n_instances, 2), np.int32)
        for gi, g in enumerate(groups):
            self.inst_loc[g.members, 0] = gi
            self.inst_loc[g.members, 1] = np.arange(g.n_members, dtype=np.int32)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_network(cls, net) -> "ChannelGraph":
        """Extract the IR from a built ``repro.core.network.Network``.

        Channel numbering (sentinels, connections in declaration order, then
        external-in, then external-out) matches the historical single-netlist
        layout so states remain comparable across engine backends.
        """
        insts = net._instances

        by_block: dict[int, list] = {}
        order: list[int] = []
        for inst in insts:
            key = id(inst.block)
            if key not in by_block:
                by_block[key] = []
                order.append(key)
            by_block[key].append(inst)

        groups: list[GroupDef] = []
        for key in order:
            members = by_block[key]
            if any(m.params is not None for m in members):
                params = tree_map(
                    lambda *xs: np.stack([np.asarray(x) for x in xs]),
                    *[m.params for m in members],
                )
            else:
                params = None
            groups.append(
                GroupDef(
                    block=members[0].block,
                    members=np.array([m.inst_id for m in members], np.int32),
                    names=tuple(m.name for m in members),
                    params=params,
                )
            )

        n_channels = _N_SENTINELS
        chan_of_tx: dict[tuple[int, str], int] = {}
        chan_of_rx: dict[tuple[int, str], int] = {}
        src_list: list[int] = [-1, -1]
        dst_list: list[int] = [-1, -1]
        for tx, rx in net._connections:
            if (tx.inst_id, tx.port) in chan_of_tx:
                raise ValueError(f"output port {tx} connected twice (SPSC)")
            if (rx.inst_id, rx.port) in chan_of_rx:
                raise ValueError(f"input port {rx} connected twice (SPSC)")
            chan_of_tx[(tx.inst_id, tx.port)] = n_channels
            chan_of_rx[(rx.inst_id, rx.port)] = n_channels
            src_list.append(tx.inst_id)
            dst_list.append(rx.inst_id)
            n_channels += 1
        ext_in: dict[str, int] = {}
        for name, rx in net._external_in.items():
            if (rx.inst_id, rx.port) in chan_of_rx:
                raise ValueError(f"input port {rx} connected twice (SPSC)")
            chan_of_rx[(rx.inst_id, rx.port)] = n_channels
            ext_in[name] = n_channels
            src_list.append(-1)
            dst_list.append(rx.inst_id)
            n_channels += 1
        ext_out: dict[str, int] = {}
        for name, tx in net._external_out.items():
            if (tx.inst_id, tx.port) in chan_of_tx:
                raise ValueError(f"output port {tx} connected twice (SPSC)")
            chan_of_tx[(tx.inst_id, tx.port)] = n_channels
            ext_out[name] = n_channels
            src_list.append(tx.inst_id)
            dst_list.append(-1)
            n_channels += 1

        rx_idx: list[np.ndarray] = []
        tx_idx: list[np.ndarray] = []
        for g in groups:
            blk = g.block
            rxm = np.full((g.n_members, len(blk.in_ports)), NULL_RX, np.int32)
            txm = np.full((g.n_members, len(blk.out_ports)), NULL_TX, np.int32)
            for i, inst_id in enumerate(g.members):
                for p, port in enumerate(blk.in_ports):
                    rxm[i, p] = chan_of_rx.get((int(inst_id), port), NULL_RX)
                for p, port in enumerate(blk.out_ports):
                    txm[i, p] = chan_of_tx.get((int(inst_id), port), NULL_TX)
            rx_idx.append(rxm)
            tx_idx.append(txm)

        return cls(
            payload_words=net.payload_words,
            dtype=net.dtype,
            capacity=net.capacity,
            groups=groups,
            rx_idx=rx_idx,
            tx_idx=tx_idx,
            chan_src=np.array(src_list, np.int32),
            chan_dst=np.array(dst_list, np.int32),
            ext_in=ext_in,
            ext_out=ext_out,
        )

    @classmethod
    def _uniform_2port(
        cls,
        cell: Block,
        n: int,
        rxm: np.ndarray,
        txm: np.ndarray,
        chan_src: np.ndarray,
        chan_dst: np.ndarray,
        params: Tree | None,
        payload_words: int | None,
        dtype: Any,
        capacity: int | None,
    ) -> "ChannelGraph":
        """Assemble a single-group graph from prebuilt vectorized tables."""
        from . import queue as qmod

        group = GroupDef(
            block=cell,
            members=np.arange(n, dtype=np.int32),
            names=tuple(),  # names elided at this scale
            params=params,
        )
        return cls(
            payload_words=payload_words or cell.payload_words,
            dtype=dtype if dtype is not None else torch.float32,
            capacity=capacity or qmod.DEFAULT_CAPACITY,
            groups=[group],
            rx_idx=[rxm.astype(np.int32)],
            tx_idx=[txm.astype(np.int32)],
            chan_src=chan_src.astype(np.int32),
            chan_dst=chan_dst.astype(np.int32),
            ext_in={},
            ext_out={},
        )

    @classmethod
    def grid(
        cls,
        cell: Block,
        R: int,
        C: int,
        *,
        params: Tree | None = None,
        payload_words: int | None = None,
        dtype: Any = None,
        capacity: int | None = None,
    ) -> "ChannelGraph":
        """Vectorized builder for a uniform R×C grid of ``cell`` instances.

        Dataflow is east (``out_ports[0]`` -> ``in_ports[0]``) and south
        (``out_ports[1]`` -> ``in_ports[1]``), instance ids row-major —
        the §IV-B manycore topology.  O(R*C) numpy, no Python per-instance
        loop, so million-core graphs stay cheap to describe.
        """
        if len(cell.in_ports) != 2 or len(cell.out_ports) != 2:
            raise ValueError("grid() needs a cell with 2 in and 2 out ports")
        n = R * C
        rr, cc = np.divmod(np.arange(n, dtype=np.int64), C)

        n_east = R * (C - 1)
        east_of = lambda r, c: _N_SENTINELS + r * (C - 1) + c  # noqa: E731
        south_of = lambda r, c: _N_SENTINELS + n_east + r * C + c  # noqa: E731
        n_channels = _N_SENTINELS + n_east + (R - 1) * C

        chan_src = np.full((n_channels,), -1, np.int64)
        chan_dst = np.full((n_channels,), -1, np.int64)
        er, ec = np.divmod(np.arange(n_east, dtype=np.int64), C - 1) if C > 1 else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        chan_src[_N_SENTINELS:_N_SENTINELS + n_east] = er * C + ec
        chan_dst[_N_SENTINELS:_N_SENTINELS + n_east] = er * C + ec + 1
        sr, sc = np.divmod(np.arange((R - 1) * C, dtype=np.int64), C)
        chan_src[_N_SENTINELS + n_east:] = sr * C + sc
        chan_dst[_N_SENTINELS + n_east:] = (sr + 1) * C + sc

        rxm = np.empty((n, 2), np.int64)
        txm = np.empty((n, 2), np.int64)
        rxm[:, 0] = np.where(cc > 0, east_of(rr, cc - 1), NULL_RX)
        rxm[:, 1] = np.where(rr > 0, south_of(rr - 1, cc), NULL_RX)
        txm[:, 0] = np.where(cc < C - 1, east_of(rr, cc), NULL_TX)
        txm[:, 1] = np.where(rr < R - 1, south_of(rr, cc), NULL_TX)

        return cls._uniform_2port(
            cell, n, rxm, txm, chan_src, chan_dst,
            params, payload_words, dtype, capacity,
        )

    @classmethod
    def torus(
        cls,
        cell: Block,
        R: int,
        C: int,
        *,
        params: Tree | None = None,
        payload_words: int | None = None,
        dtype: Any = None,
        capacity: int | None = None,
    ) -> "ChannelGraph":
        """Vectorized builder for a uniform R×C 2-D torus of ``cell``.

        Same port convention as ``grid`` (east = ``out_ports[0]`` ->
        ``in_ports[0]``, south = ``out_ports[1]`` -> ``in_ports[1]``) but
        with wrap-around links, so every port is wired and every row/column
        is a ring — the wafer-scale many-core topology
        (``examples/wafer_scale.py``).  O(R*C) numpy, no per-instance loop.
        """
        if len(cell.in_ports) != 2 or len(cell.out_ports) != 2:
            raise ValueError("torus() needs a cell with 2 in and 2 out ports")
        n = R * C
        rr, cc = np.divmod(np.arange(n, dtype=np.int64), C)

        # Channel ids: east ring channels first (one per cell), then south.
        east_of = lambda r, c: _N_SENTINELS + r * C + c  # noqa: E731
        south_of = lambda r, c: _N_SENTINELS + n + r * C + c  # noqa: E731
        n_channels = _N_SENTINELS + 2 * n

        chan_src = np.full((n_channels,), -1, np.int64)
        chan_dst = np.full((n_channels,), -1, np.int64)
        chan_src[_N_SENTINELS:_N_SENTINELS + n] = rr * C + cc
        chan_dst[_N_SENTINELS:_N_SENTINELS + n] = rr * C + (cc + 1) % C
        chan_src[_N_SENTINELS + n:] = rr * C + cc
        chan_dst[_N_SENTINELS + n:] = ((rr + 1) % R) * C + cc

        rxm = np.empty((n, 2), np.int64)
        txm = np.empty((n, 2), np.int64)
        rxm[:, 0] = east_of(rr, (cc - 1) % C)
        rxm[:, 1] = south_of((rr - 1) % R, cc)
        txm[:, 0] = east_of(rr, cc)
        txm[:, 1] = south_of(rr, cc)

        return cls._uniform_2port(
            cell, n, rxm, txm, chan_src, chan_dst,
            params, payload_words, dtype, capacity,
        )

    @classmethod
    def replicate(cls, net, n: int) -> "ChannelGraph":
        """Vectorized builder for ``n`` copies of the small netlist ``net``
        (a ``Network`` without external ports): the tables equal
        ``from_network`` of a network that instantiates and connects
        ``net``'s blocks ``n`` times in turn — copy ``i``'s instance ``k``
        is ``i * m + k``, its channel ``c`` is ``2 + i * n_c + c`` — each
        group holding every copy's members of one block object, copy-major.
        O(n) numpy, no per-instance loop; names elided at this scale."""
        one = cls.from_network(net)
        if one.ext_in or one.ext_out:
            raise ValueError("replicate() takes a netlist without external ports: "
                             "the copies would share their names")
        m, n_c = one.n_instances, one.n_channels - _N_SENTINELS
        copy = np.arange(n, dtype=np.int64)[:, None]

        def wired(t: np.ndarray) -> np.ndarray:
            # (m_g, n_p) channel ids -> (n * m_g, n_p), sentinels kept
            t = t.astype(np.int64)[None]
            out = np.where(t >= _N_SENTINELS, t + copy[..., None] * n_c, t)
            return out.reshape(n * t.shape[1], t.shape[2]).astype(np.int32)

        def tiled(x) -> np.ndarray:
            x = np.asarray(x)
            return np.tile(x, (n,) + (1,) * (x.ndim - 1))

        groups = [
            GroupDef(block=g.block,
                     members=(g.members[None, :] + copy * m).reshape(-1).astype(np.int32),
                     names=(),
                     params=None if g.params is None else tree_map(tiled, g.params))
            for g in one.groups
        ]
        ends = [np.concatenate([e[:_N_SENTINELS],
                                (e[None, _N_SENTINELS:] + copy * m).reshape(-1)])
                for e in (one.chan_src.astype(np.int64), one.chan_dst.astype(np.int64))]
        return cls(
            payload_words=one.payload_words, dtype=one.dtype, capacity=one.capacity,
            groups=groups,
            rx_idx=[wired(t) for t in one.rx_idx],
            tx_idx=[wired(t) for t in one.tx_idx],
            chan_src=ends[0], chan_dst=ends[1], ext_in={}, ext_out={},
        )

    # -- queries -------------------------------------------------------------
    def locate(self, inst_id: int) -> tuple[int, int]:
        """(group index, slot) of a global instance id."""
        gi, slot = self.inst_loc[inst_id]
        return int(gi), int(slot)

    def channel_granules(self, partition: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel (src granule, dst granule); -1 for host/sentinel ends."""
        part = np.asarray(partition, np.int32)
        src_g = np.where(self.chan_src >= 0, part[np.clip(self.chan_src, 0, None)], -1)
        dst_g = np.where(self.chan_dst >= 0, part[np.clip(self.chan_dst, 0, None)], -1)
        return src_g.astype(np.int32), dst_g.astype(np.int32)

    def ext_ports(self) -> dict[str, tuple[int, bool]]:
        """Unified external-port table: name -> (channel id, is_input).

        ``is_input`` means the *host pushes* (an ``external_in`` port); the
        session layer builds its Tx/Rx queue handles from this table so
        every engine exposes the same host-port namespace.
        """
        ports = {name: (cid, True) for name, cid in self.ext_in.items()}
        ports.update({name: (cid, False) for name, cid in self.ext_out.items()})
        return ports

    def ext_home(self, partition: np.ndarray) -> dict[str, int]:
        """Granule that *homes* each external port under ``partition``.

        An external channel has exactly one simulated endpoint (the other
        end is the host, granule -1); its queue lives with that endpoint's
        granule, so host I/O touches only the owning granule's slab — the
        homing rule every distributed engine shares.
        """
        src_g, dst_g = self.channel_granules(partition)
        owner = np.where(src_g >= 0, src_g, dst_g)
        return {
            name: int(owner[cid]) for name, (cid, _) in self.ext_ports().items()
        }

    def summary(self) -> str:
        return (
            f"ChannelGraph({self.n_instances} instances in {len(self.groups)} "
            f"groups, {self.n_channels - _N_SENTINELS} channels, "
            f"{len(self.ext_in)} ext-in, {len(self.ext_out)} ext-out)"
        )


# -- partition maps ----------------------------------------------------------

def normalize_partition(graph: ChannelGraph, partition, n_granules: int) -> np.ndarray:
    """Canonicalize a partition map to a (n_instances,) int32 granule vector.

    Accepts ``None`` (everything on granule 0), a sequence of granule ids in
    instance order, or a ``{instance_name: granule}`` mapping (unlisted
    instances default to granule 0).
    """
    if partition is None:
        part = np.zeros((graph.n_instances,), np.int32)
    elif isinstance(partition, Mapping):
        part = np.zeros((graph.n_instances,), np.int32)
        name_to_inst = {
            name: int(inst)
            for g in graph.groups
            for name, inst in zip(g.names, g.members)
        }
        for name, gran in partition.items():
            if name not in name_to_inst:
                raise KeyError(f"partition names unknown instance {name!r}")
            part[name_to_inst[name]] = int(gran)
    else:
        part = np.asarray(partition, np.int32)
        if part.shape != (graph.n_instances,):
            raise ValueError(
                f"partition has shape {part.shape}, expected ({graph.n_instances},)"
            )
    if part.size and (part.min() < 0 or part.max() >= n_granules):
        raise ValueError(
            f"partition assigns granules outside [0, {n_granules}): "
            f"[{part.min()}, {part.max()}]"
        )
    return part


def grid_partition(R: int, C: int, Dr: int, Dc: int) -> np.ndarray:
    """Block-tile partition of a row-major R×C grid onto Dr×Dc granules."""
    if R % Dr or C % Dc:
        raise ValueError(f"grid {R}x{C} not divisible by device tile {Dr}x{Dc}")
    Tr, Tc = R // Dr, C // Dc
    rr, cc = np.divmod(np.arange(R * C, dtype=np.int64), C)
    return ((rr // Tr) * Dc + (cc // Tc)).astype(np.int32)


# -- hierarchical partitions (DESIGN.md §3) ----------------------------------

@dataclasses.dataclass(frozen=True)
class Tier:
    """One level of the partition tree: a group of mesh axes + a sync rate.

    axes: the mesh axes this tier spans (e.g. ``("pod",)`` for the DCI tier,
          ``("gr", "gc")`` for the intra-pod ICI tier).
    K:    sync rate.  For the innermost tier, the number of granule-local
          cycles per tier round; for an outer tier, the number of
          next-inner-tier rounds per round of this tier.  A tier-t boundary
          channel is therefore synchronized every ``prod(K_t .. K_inner)``
          cycles (its *period*).
    name: optional label for diagnostics.
    """

    axes: tuple[str, ...]
    K: int = 1
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        if self.K < 1:
            raise ValueError(f"tier K must be >= 1, got {self.K}")
        if not self.axes:
            raise ValueError("tier needs at least one mesh axis")


def normalize_tiers(tiers) -> tuple[Tier, ...]:
    """Canonicalize a tier spec: a sequence of ``Tier`` or ``(axes, K)``
    pairs (axes a name or tuple of names), outermost (slowest) first."""
    out: list[Tier] = []
    for t in tiers:
        if isinstance(t, Tier):
            out.append(t)
        else:
            axes, K = t
            if isinstance(axes, str):
                axes = (axes,)
            out.append(Tier(axes=tuple(axes), K=int(K)))
    seen: set[str] = set()
    for t in out:
        for a in t.axes:
            if a in seen:
                raise ValueError(f"mesh axis {a!r} appears in two tiers")
            seen.add(a)
    if not out:
        raise ValueError("need at least one tier")
    return tuple(out)


class PartitionTree:
    """Hierarchical instance -> granule assignment over tiered mesh axes.

    The *leaf granule* id of an instance is the row-major flattening of its
    per-axis device coordinates, axes ordered outermost tier first — i.e.
    ``part`` is exactly the flat granule vector the engines consume, plus
    the tree structure needed to classify boundary channels by the
    outermost tier they cross and to derive per-tier sync periods.

    part:       (n_instances,) int32 leaf granule ids.
    tiers:      outermost-first ``Tier`` sequence (see ``Tier``).
    axis_sizes: mesh-axis name -> size, for every axis named by a tier.
    """

    def __init__(self, part, tiers, axis_sizes: Mapping[str, int]):
        self.tiers = normalize_tiers(tiers)
        self.axes = tuple(a for t in self.tiers for a in t.axes)
        missing = [a for a in self.axes if a not in axis_sizes]
        if missing:
            raise ValueError(f"axis_sizes missing sizes for axes {missing}")
        self.dev_shape = tuple(int(axis_sizes[a]) for a in self.axes)
        self.n_granules = int(np.prod(self.dev_shape))
        self.part = np.asarray(part, np.int32)
        if self.part.ndim != 1:
            raise ValueError("part must be a 1-D granule vector")
        if self.part.size and (
            self.part.min() < 0 or self.part.max() >= self.n_granules
        ):
            raise ValueError(
                f"part assigns granules outside [0, {self.n_granules})"
            )
        # tier t covers axis indices [_axis_start[t], _axis_start[t+1])
        self._axis_start = np.cumsum([0] + [len(t.axes) for t in self.tiers])

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def K_tiers(self) -> tuple[int, ...]:
        return tuple(t.K for t in self.tiers)

    def periods(self) -> tuple[int, ...]:
        """Cycles between tier-t synchronizations: prod(K_t .. K_inner)."""
        ps, acc = [], 1
        for t in reversed(self.tiers):
            acc *= t.K
            ps.append(acc)
        return tuple(reversed(ps))

    @property
    def cycles_per_epoch(self) -> int:
        return self.periods()[0]

    def tier_of_edges(self, src_g: np.ndarray, dst_g: np.ndarray) -> np.ndarray:
        """Outermost tier crossed by each (src granule, dst granule) edge.

        Returns (n,) int32: the smallest tier index t such that the two
        granules differ in one of tier t's axes, or -1 when the granules
        are identical (or either end is a host/sentinel, id < 0).
        """
        src_g = np.asarray(src_g, np.int64)
        dst_g = np.asarray(dst_g, np.int64)
        valid = (src_g >= 0) & (dst_g >= 0)
        sc = np.stack(
            np.unravel_index(np.clip(src_g, 0, None), self.dev_shape), axis=0
        )  # (n_axes, n)
        dc = np.stack(
            np.unravel_index(np.clip(dst_g, 0, None), self.dev_shape), axis=0
        )
        tier = np.full(src_g.shape, -1, np.int32)
        # innermost first so the outermost differing tier wins the overwrite
        for t in reversed(range(self.n_tiers)):
            lo, hi = self._axis_start[t], self._axis_start[t + 1]
            diff = (sc[lo:hi] != dc[lo:hi]).any(axis=0)
            tier = np.where(diff, t, tier)
        return np.where(valid, tier, -1).astype(np.int32)

    def summary(self) -> str:
        parts = ", ".join(
            f"{t.name or '/'.join(t.axes)}:K={t.K}" for t in self.tiers
        )
        return (
            f"PartitionTree({self.part.size} instances -> {self.n_granules} "
            f"granules, tiers [{parts}], periods {self.periods()})"
        )


# -- partition lowering (engine-independent) ---------------------------------

def _rank_within(groups: np.ndarray, n_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """For each element, its rank among elements of the same group value.

    Returns (rank, counts).  Stable: earlier elements get lower ranks.
    """
    counts = np.bincount(groups, minlength=n_groups) if groups.size else np.zeros(
        (n_groups,), np.int64
    )
    order = np.argsort(groups, kind="stable")
    starts = np.zeros((n_groups,), np.int64)
    if n_groups > 1:
        starts[1:] = np.cumsum(counts[:-1])
    rank = np.empty((groups.size,), np.int64)
    rank[order] = np.arange(groups.size, dtype=np.int64) - np.repeat(starts, counts)
    return rank, counts


class PartitionLowering:
    """Mesh-independent lowering of (ChannelGraph, PartitionTree) to
    per-granule tables (DESIGN.md §3, §Runtime).

    This is the shared front half of every partitioned backend: the
    engines (``distributed.GraphEngine`` and subclasses) stack these
    tables into device tensors and add the exchange-class schedule.
    Keeping the queue-id assignment here — in exactly one place — is what
    makes the engines' granule-local state layouts (and therefore their
    simulated traffic) bit-identical.

    Local queue id assignment: every channel owns one queue per granule it
    touches — internal/external channels one queue in their owner granule;
    boundary channels an egress queue (sender side) and an ingress queue
    (receiver side).  Ids 0/1 are the NULL_RX / NULL_TX sentinels.
    """

    def __init__(self, graph: "ChannelGraph", ptree: "PartitionTree"):
        if ptree.part.shape != (graph.n_instances,):
            raise ValueError(
                f"PartitionTree covers {ptree.part.size} instances, "
                f"graph has {graph.n_instances}"
            )
        self.graph = graph
        self.ptree = ptree
        g, G = graph, ptree.n_granules
        self.G = G
        part = ptree.part
        NRX, NTX = g.NULL_RX, g.NULL_TX
        src_g, dst_g = g.channel_granules(part)
        self.src_g, self.dst_g = src_g, dst_g
        owner = np.where(src_g >= 0, src_g, dst_g)  # ext channels live with
        boundary = (src_g >= 0) & (dst_g >= 0) & (src_g != dst_g)  # their block
        cids = np.arange(g.n_channels, dtype=np.int64)
        self.boundary = boundary

        loc = (owner >= 0) & ~boundary
        ent_g = np.concatenate([owner[loc], src_g[boundary], dst_g[boundary]])
        ent_c = np.concatenate([cids[loc], cids[boundary], cids[boundary]])
        n_loc = int(loc.sum())
        n_bnd = int(boundary.sum())
        ent_kind = np.concatenate(
            [np.zeros(n_loc, np.int8), np.ones(n_bnd, np.int8), np.full(n_bnd, 2, np.int8)]
        )
        rank, counts = _rank_within(ent_g.astype(np.int64), G)
        lid = 2 + rank
        self.n_local = int(2 + (counts.max() if counts.size else 0))

        # channel -> local queue id on its producer/consumer side
        tx_local = np.full((g.n_channels,), NTX, np.int64)
        rx_local = np.full((g.n_channels,), NRX, np.int64)
        tx_local[ent_c[ent_kind == 0]] = lid[ent_kind == 0]
        rx_local[ent_c[ent_kind == 0]] = lid[ent_kind == 0]
        tx_local[ent_c[ent_kind == 1]] = lid[ent_kind == 1]  # egress
        rx_local[ent_c[ent_kind == 2]] = lid[ent_kind == 2]  # ingress
        tx_local[NTX], rx_local[NRX] = NTX, NRX
        self.tx_local, self.rx_local = tx_local, rx_local
        self.chan_owner = owner
        # entity table (granule, channel, kind 0=local 1=egress 2=ingress,
        # local queue id) — FusedEngine re-lowers it onto registers + queues
        self.ent = (ent_g.astype(np.int64), ent_c, ent_kind, lid)

        # Per-group member placement + local port tables (padded to n_slot).
        rx_t, tx_t, act_t = [], [], []
        self.member_of: list[np.ndarray] = []  # (G, n_slot) member index
        self.member_granule: list[np.ndarray] = []  # (n_m,)
        self.member_slot: list[np.ndarray] = []  # (n_m,)
        self.n_slot: list[int] = []
        for gi, grp in enumerate(g.groups):
            gm = part[grp.members].astype(np.int64)
            slot, counts = _rank_within(gm, G)
            n_slot = int(max(counts.max() if counts.size else 0, 1))
            member_of = np.zeros((G, n_slot), np.int64)
            active = np.zeros((G, n_slot), bool)
            member_of[gm, slot] = np.arange(grp.n_members, dtype=np.int64)
            active[gm, slot] = True
            rxm = np.full((G, n_slot, g.rx_idx[gi].shape[1]), NRX, np.int64)
            txm = np.full((G, n_slot, g.tx_idx[gi].shape[1]), NTX, np.int64)
            rxm[gm, slot] = rx_local[g.rx_idx[gi]]
            txm[gm, slot] = tx_local[g.tx_idx[gi]]
            rx_t.append(rxm.astype(np.int32))
            tx_t.append(txm.astype(np.int32))
            act_t.append(active)
            self.member_of.append(member_of)
            self.member_granule.append(gm)
            self.member_slot.append(slot)
            self.n_slot.append(n_slot)
        self.rx_tables, self.tx_tables, self.act_tables = rx_t, tx_t, act_t

        # Boundary channels, classified by the outermost tier they cross,
        # grouped into directed granule-pair routes (tier, src, dst).
        self.chan_tier = ptree.tier_of_edges(src_g, dst_g)  # -1 when local
        routes: dict[tuple[int, int, int], list[int]] = {}
        for c in cids[boundary]:
            key = (int(self.chan_tier[c]), int(src_g[c]), int(dst_g[c]))
            routes.setdefault(key, []).append(int(c))
        self.routes = routes
        self._signatures: list[str] | None = None

    # -- per-granule views ---------------------------------------------------
    def tier_channels(self, t: int, granule: int) -> tuple[list[int], list[int]]:
        """Tier-t boundary channels of one granule: (egress, ingress) channel
        ids in deterministic (channel-id) order.  Exchange order within a
        tier is semantically free — every channel owns disjoint queues — so
        channel-id order is simply the canonical one."""
        eg = [c for (tt, s, d), cs in sorted(self.routes.items())
              for c in cs if tt == t and s == granule]
        ing = [c for (tt, s, d), cs in sorted(self.routes.items())
               for c in cs if tt == t and d == granule]
        return sorted(eg), sorted(ing)

    def ext_channels(self, granule: int) -> list[tuple[str, int, bool]]:
        """External ports homed on ``granule``: (name, channel id, is_input),
        in the graph's declaration order."""
        out = []
        for name, (cid, is_input) in self.graph.ext_ports().items():
            if int(self.chan_owner[cid]) == granule:
                out.append((name, cid, is_input))
        return out

    def granule_signature(self, granule: int) -> str:
        """Stable signature of one granule's *compiled shape* — the prebuilt
        simulator cache key (paper §III-F: one prebuilt simulator per unique
        block; here per unique granule shape).

        Two granules share a signature iff their epoch steppers have the
        same shape: same block types/configs, same slot counts, same local
        queue count and payload signature, same per-tier exchange shapes.
        Table *values* (port wirings, member placement) are runtime inputs
        to the compiled stepper, not constants, so they are excluded —
        that is exactly what lets N instances of one block compile once.
        """
        g = self.graph
        parts: list[str] = [
            f"W={g.payload_words}", f"cap={g.capacity}",
            f"dtype={_dtype_str(g.dtype)}",
            f"n_local={self.n_local}",
            f"K={self.ptree.K_tiers}",
        ]
        for gi, grp in enumerate(g.groups):
            blk = grp.block
            cfg = {
                k: (f"<{v.shape}:{v.dtype}>" if isinstance(v, np.ndarray)
                    else repr(v))
                for k, v in sorted(vars(blk).items())
                if not k.startswith("_")
            }
            parts.append(
                f"g{gi}:{type(blk).__module__}.{type(blk).__qualname__}"
                f":{cfg}:slots={self.n_slot[gi]}:n_m={grp.n_members}"
                f":div={blk.clock_divider}"
            )
        for t in range(self.ptree.n_tiers):
            n_eg = sum(len(cs) for (tt, s, _), cs in self.routes.items()
                       if tt == t)
            # per-granule egress/ingress counts shape the drain/fill fns
            eg, ing = self.tier_channels(t, granule)
            parts.append(f"t{t}:eg={len(eg)}:in={len(ing)}:all={n_eg}")
        parts.append(f"ext={len(self.ext_channels(granule))}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    # -- signature batching --------------------------------------------------
    def granule_signatures(self) -> list[str]:
        """``granule_signature`` of every granule, computed once and cached
        (the signature walk scans the route table, so the cache matters for
        wide meshes)."""
        if self._signatures is None:
            self._signatures = [
                self.granule_signature(g) for g in range(self.G)
            ]
        return self._signatures

    def signature_groups(self) -> dict[str, list[int]]:
        """Granules grouped by compiled-shape signature.

        Signature -> ascending granule ids.  All granules in one group
        share the *same* stepper shape, so they can be stacked on one
        leading batch axis and stepped by a single dispatch — the batching
        lowering consumed by the engines (``batch_axes``)."""
        groups: dict[str, list[int]] = {}
        for g, sig in enumerate(self.granule_signatures()):
            groups.setdefault(sig, []).append(g)
        return groups

    def batch_plan(self) -> tuple[list[list[int]], dict[int, tuple[int, int]]]:
        """Signature-batch membership + inverse scatter map.

        Returns ``(batches, where)``: ``batches[b]`` lists the granules
        stacked into batch ``b`` (groups in first-granule order, members
        ascending — so batch row == rank within the signature group), and
        ``where[g] = (b, row)`` locates granule ``g``'s slice for
        scatter-back at tier exchange / probe routing."""
        groups = sorted(self.signature_groups().values(), key=lambda m: m[0])
        where = {
            g: (b, r)
            for b, members in enumerate(groups)
            for r, g in enumerate(members)
        }
        return groups, where


def lower_partition(graph: "ChannelGraph", ptree: "PartitionTree") -> PartitionLowering:
    """Lower (graph, partition tree) to per-granule tables — see
    ``PartitionLowering``."""
    return PartitionLowering(graph, ptree)


def tiered_grid_partition(
    R: int, C: int, tiles: Sequence[tuple[int, int]]
) -> np.ndarray:
    """Nested block-tiling of a row-major R×C grid, one tier per level.

    ``tiles`` lists per-tier (rows, cols) device splits outermost first;
    level t carves each level-(t-1) block into ``tr × tc`` sub-blocks.  The
    returned (R*C,) granule vector is flattened with one mesh axis per tier
    of size ``tr * tc`` (outermost first) — i.e. it matches a mesh of shape
    ``tuple(tr * tc for tr, tc in tiles)``.  ``tiles=[(Dr, Dc)]`` reduces to
    ``grid_partition`` modulo the single flattened axis.
    """
    rr, cc = np.divmod(np.arange(R * C, dtype=np.int64), C)
    gid = np.zeros((R * C,), np.int64)
    Rrem, Crem = R, C
    for tr, tc in tiles:
        if Rrem % tr or Crem % tc:
            raise ValueError(
                f"block {Rrem}x{Crem} not divisible by tier tile {tr}x{tc}"
            )
        br, bc = Rrem // tr, Crem // tc
        gid = gid * (tr * tc) + (rr // br) * tc + (cc // bc)
        rr, cc = rr % br, cc % bc
        Rrem, Crem = br, bc
    return gid.astype(np.int32)
