"""Epoch-batched simulation of a partitioned channel graph, as in
``repro.core.distributed`` (paper §II, §IV-B; DESIGN.md §2-§3).

A **hierarchical partition** (``graph.PartitionTree``) assigns every block
instance to a *granule* and groups the granule axes into **tiers**, each
with its own sync rate.  Each granule advances cycles of local simulation
and exchanges the contents of its boundary queues with its peers at its
tier's cadence:

    paper                      | here
    ---------------------------+---------------------------------
    single-netlist granule     | one batch row of the flat layout
    shm queue between granules | egress queue -> slab -> ingress queue
    free-running processes     | K-cycle epochs (bounded staleness)
    TCP bridge between hosts   | outer (slow) tier of the same exchange,
                               | synchronized every K_outer * K_inner cycles
    ready/valid backpressure   | credit return on the reverse gather

Granule axes are *real* (sized by ``mesh``: one shard a position) or
*batch* (``batch_axes``: stacked on one leading axis of a shard).  The
granules of one shard exchange by a slab gather between batch rows
(``bat_fwd``/``bat_rev``).  Real axes are sharded by a single controller
(``core.mesh``): one process holds every shard, each on its own device,
and the part of an exchange class that leaves a shard (its ``real_perm``,
the reference's ``ppermute``) is a copy from the sender shard's slab
columns into the receiver's, zeros where a shard has no sender.  Shards
that share a card still run one epoch each, with the same copies between
them that several cards would make.

``GraphEngine`` is the queue interpreter: every channel a granule touches
is a ring of ``capacity`` slots, and one cycle (:func:`granule_local_cycle`)
steps every block of every granule with the same pre-cycle snapshot,
sentinels and clock-divider gating as ``NetworkSim.step``, the batch of
granules folded into the queue rows and block slots.  It runs any block
type and any capacity, with plain PyTorch ops (the reference's cycle is
plain XLA too: it reaches no Pallas kernel).  An epoch nests the tiers'
rounds and exchanges as the reference's ``_tier_round`` does, or, with
``overlap``, issues each exchange at its window's end and commits it at
the next window's start (``_round_split``); both schedules give the same
bits.  On the card the engine owns its state and writes the queue array
in place (``queue.cycle_``, ``stage_drain_``, ``stage_fill_``): the
functional forms, which the CPU runs, copy the whole buffer each call.
``run_until`` runs its epochs in the device loop (``core.device_loop``).
``GridEngine`` is its uniform-grid preset, and ``fused.FusedEngine``
subclasses it for the fast path.

Routes (one per directed granule pair of a tier) are edge-colored into
**exchange classes** by the König construction, exactly as in the JAX
package — refined per real-axis shift when the engine is batched — so the
per-tier slot layout, and with it every credit and slab table, is the
same on both.

Credit protocol (DESIGN.md §3): the receiver of a boundary channel
advertises ``free(ingress)`` after each fill; the sender drains at most
that many packets at its tier's next exchange.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import device_loop
from . import queue as qmod
from ..kernels import granule_step
from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from .block import Block
from .device import group_generator, resolve_device, shard_devices, to_tensor
from .graph import (
    NULL_RX, NULL_TX, ChannelGraph, PartitionTree, Tier, grid_partition,
    lower_partition, normalize_partition, normalize_tiers,
)
from .mesh import Placement, ShardedState, all_shards, gather, require_one_card
from .struct import tensor_dataclass, tree_map

Tree = Any


@tensor_dataclass
class GraphTables:
    """Per-granule lookup tables (constant over time).

    All leaves carry the leading ``dev_shape`` dims; index values are
    *local* queue ids (0 = NULL_RX sentinel, 1 = NULL_TX sentinel).  The
    exchange tables are concatenated per *tier*: slot ``j`` of tier ``t``
    belongs to the class whose ``[col0, col0+cmax)`` column window holds
    ``j``.  ``bat_fwd[t][real..., bd, col] = bs``: on the *source* shard,
    send-buffer row ``bd`` (the receiver's batch row) reads slab row
    ``bs``; ``bat_rev[t][real..., bs, col] = bd``: on the *dest* shard, the
    credit-return row ``bs`` reads credit row ``bd``.  Both are empty when
    the engine runs unbatched.
    """

    rx_idx: tuple  # per group: (dev..., n_slot, n_in) int32
    tx_idx: tuple  # per group: (dev..., n_slot, n_out) int32
    active: tuple  # per group: (dev..., n_slot) bool — padding slots False
    send_idx: tuple  # per tier: (dev..., S_t) int32 local egress queue ids
    send_mask: tuple  # per tier: (dev..., S_t) bool
    recv_idx: tuple  # per tier: (dev..., S_t) int32 local ingress queue ids
    recv_mask: tuple  # per tier: (dev..., S_t) bool
    bat_fwd: tuple = ()
    bat_rev: tuple = ()


@tensor_dataclass
class GraphState:
    """All leaves carry the leading ``dev_shape`` dims, as in the JAX
    package's global view."""

    queues: qmod.QueueArray  # (dev..., n_local, capacity, W) granule-local queues
    block_states: tuple  # per group: leaves (dev..., n_slot, ...)
    credits: tuple  # per tier: (dev..., S_t) int32 send credits
    cycle: torch.Tensor  # (dev...,) int32 local cycle counters
    epoch: torch.Tensor  # (dev...,) int32
    tables: GraphTables


@dataclasses.dataclass(frozen=True)
class _ExchangeClass:
    """One partial permutation of boundary routes."""

    perm: tuple = ()  # ((src_granule, dst_granule), ...)
    cmax: int = 0  # max channels on any route
    tier: int = 0  # which tier's exchange runs this class
    depth: int = 1  # slab depth E = min(period, cap-1)
    col0: int = 0  # column offset in the tier slab
    # batched engines only: the deduped ((src_shard, dst_shard), ...) map
    # over the real mesh axes; () = the whole class moves between batch
    # rows of one shard.  None on unbatched engines (where ``perm`` itself
    # is the shard map).
    real_perm: tuple | None = None

    def shard_perm(self) -> tuple:
        """The ((src_shard, dst_shard), ...) copies this class makes
        between shards; () when it stays on each shard."""
        return self.perm if self.real_perm is None else self.real_perm


def _perfect_matching(adj: np.ndarray) -> np.ndarray:
    """Perfect matching in a regular bipartite multigraph (Kuhn's algorithm).

    adj[s, d] = remaining parallel-edge count.  Returns match[s] = d.
    A Δ-regular bipartite multigraph always has one (Hall's theorem), so
    failure here means the caller's regularization is broken.
    """
    G = adj.shape[0]
    match_r = np.full((G,), -1, np.int64)  # right node -> matched left node

    def augment(s: int, visited: np.ndarray) -> bool:
        for d in range(G):
            if adj[s, d] > 0 and not visited[d]:
                visited[d] = True
                if match_r[d] < 0 or augment(int(match_r[d]), visited):
                    match_r[d] = s
                    return True
        return False

    for s in range(G):
        if not augment(s, np.zeros((G,), bool)):
            raise AssertionError("regular bipartite graph lost its matching")
    match = np.full((G,), -1, np.int64)
    match[match_r] = np.arange(G, dtype=np.int64)
    return match


def edge_color_routes(
    pairs: Sequence[tuple[int, int]], n_granules: int
) -> list[list[tuple[int, int]]]:
    """Partition directed granule pairs into partial permutations.

    König construction: pad the route digraph (a bipartite graph senders ->
    receivers) with dummy edges until it is Δ-regular, then peel off Δ
    perfect matchings.  The number of classes therefore *equals*
    Δ = max over granules of (out-degree, in-degree) — the optimum, since
    some granule must appear in Δ distinct classes.  Deterministic.
    """
    if not pairs:
        return []
    G = n_granules
    real = np.zeros((G, G), np.int64)
    for s, d in pairs:
        real[s, d] += 1
    out_deg, in_deg = real.sum(axis=1), real.sum(axis=0)
    delta = int(max(out_deg.max(), in_deg.max()))

    # Regularize: total left deficiency == total right deficiency, so the
    # two-pointer pairing below always terminates with both sides at Δ.
    total = real.copy()
    od, idg = out_deg.copy(), in_deg.copy()
    si = di = 0
    while si < G:
        if od[si] >= delta:
            si += 1
            continue
        while idg[di] >= delta:
            di += 1
        add = min(delta - od[si], delta - idg[di])
        total[si, di] += add
        od[si] += add
        idg[di] += add

    classes: list[list[tuple[int, int]]] = []
    for _ in range(delta):
        match = _perfect_matching(total)
        cls: list[tuple[int, int]] = []
        for s in range(G):
            d = int(match[s])
            total[s, d] -= 1
            if real[s, d] > 0:  # prefer consuming a real route over a dummy
                real[s, d] -= 1
                cls.append((s, d))
        if cls:
            classes.append(cls)
    assert real.sum() == 0, "edge coloring failed to cover every route"
    return classes


def merge_compatible_classes(
    classes: Sequence[Sequence[tuple[int, int]]]
) -> list[list[tuple[int, int]]]:
    """Merge exchange classes that compose into one granule permutation.

    Two classes are *compatible* when no granule sends in both and no
    granule receives in both — their union is then still a partial
    permutation, i.e. one collective on a multi-device mesh.  Identical
    (duplicate) classes are collapsed outright: exchanging the same
    permutation twice per sync is never needed, the slab depth already
    covers the traffic.  Greedy, deterministic, order-preserving.

    NOTE: on the König coloring the engine uses this is a *guard*, not an
    optimization — König already emits the optimal Δ classes, and the
    granule realizing Δ appears in every one of them, so nothing merges.
    It is kept so the slot layout equals the JAX package's exactly.
    """
    merged: list[dict[int, int]] = []  # src -> dst maps
    for cls in classes:
        cmap = dict(cls)
        for m in merged:
            if m == cmap:  # duplicate permutation: plain dedup
                break
            if not (m.keys() & cmap.keys()) and not (
                set(m.values()) & set(cmap.values())
            ):
                m.update(cmap)
                break
        else:
            merged.append(cmap)
    return [sorted(m.items()) for m in merged]


def route_shift_groups(
    pairs: Sequence[tuple[int, int]], dev_shape: Sequence[int]
) -> dict[tuple[int, ...], list[tuple[int, int]]]:
    """Group directed granule routes by their coordinate *shift*.

    The shift of a route is the plain per-axis difference of the granule
    coordinates (no modular wrap), so a 2-D torus tiling has exactly four:
    east, east-wrap, south, south-wrap.  A fixed shift is injective, hence
    every group is a partial permutation — one copy a shard.  The
    distinct-shift count therefore bounds the class count any
    decomposition needs from above; König (max in/out degree) is always
    <= it, which ``GraphEngine`` asserts at build time.
    """
    dev_shape = tuple(int(s) for s in dev_shape)
    groups: dict[tuple[int, ...], list[tuple[int, int]]] = {}
    for s, d in pairs:
        sc = np.unravel_index(int(s), dev_shape)
        dc = np.unravel_index(int(d), dev_shape)
        shift = tuple(int(b) - int(a) for a, b in zip(sc, dc))
        groups.setdefault(shift, []).append((int(s), int(d)))
    return groups


def granule_local_cycle(groups, n_local: int, W: int, dtype, st, *,
                        stop: torch.Tensor | None = None,
                        inplace: bool = False):
    """One cycle of a granule-local network, as the reference's
    ``granule_local_cycle``.

    Identical semantics to ``NetworkSim.step`` — same pre-cycle queue
    snapshot, same sentinel handling, same clock-divider rate control —
    driven by granule-local tables read from the state.  ``st`` is any
    tree with ``queues``, ``tables.rx_idx``/``tx_idx`` (per group),
    ``block_states`` (per group) and ``cycle``, for one granule or for B
    granules folded: queue rows ``b * n_local + id`` (so the sentinels of
    granule b sit at ``b * n_local`` + ``NULL_RX``/``NULL_TX``), block
    slots ``b * n_slot + s``, and the port tables holding those flat row
    ids.  ``Block.step`` takes the leading instance dim, so every slot of
    every granule steps in one call a group.

    Every real queue row has one producer and one consumer (SPSC), and
    every unwired port and padding slot points at a sentinel row, so the
    scatters of the pushes and pop-readies write each real row once;
    several writes land only on the sentinel rows, which are reset after,
    and the result does not depend on the scatters' order.

    ``stop`` (the until-loop's () bool tensor) gates the cycle as a clock
    divider gates a block: where it is set no block state, queue or
    counter changes.  ``inplace`` writes the queue array in place
    (``queue.cycle_``) and lets a block with a ``step_`` twin update its
    large leaves in place; the state's owner must not need its input.
    """
    q = st.queues
    tb = st.tables
    n = q.n
    dev = q.buf.device
    fronts, valids = qmod.peek(q)
    readies = ~qmod.full(q)
    valids.view(-1, n_local)[:, NULL_RX] = False
    readies.view(-1, n_local)[:, NULL_TX] = True

    push_payload = torch.zeros((n, W), dtype=dtype, device=dev)
    push_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    pop_ready = torch.zeros((n,), dtype=torch.bool, device=dev)
    cycle0 = st.cycle.reshape(-1)[0]  # granules step in lockstep

    new_states = []
    for gi, grp in enumerate(groups):
        blk = grp.block
        rxm, txm = tb.rx_idx[gi].long(), tb.tx_idx[gi].long()
        f_all, v_all, r_all = fronts[rxm], valids[rxm], readies[txm]
        rx = {port: (f_all[:, p], v_all[:, p]) for p, port in enumerate(blk.in_ports)}
        tx_ready = {port: r_all[:, p] for p, port in enumerate(blk.out_ports)}
        bst = st.block_states[gi]
        en = None
        if blk.clock_divider > 1:
            en = (cycle0 % blk.clock_divider) == 0
        if stop is not None:
            en = ~stop if en is None else en & ~stop
        if inplace and hasattr(blk, "step_"):
            new_st, rx_ready, tx = blk.step_(bst, rx, tx_ready, en)
        else:
            new_st, rx_ready, tx = blk.step(bst, rx, tx_ready)
        if en is not None:
            # a leaf the step handed back untouched needs no select
            new_st = tree_map(lambda a, b: a if a is b else torch.where(en, a, b),
                              new_st, bst)
            rx_ready = {k: v & en for k, v in rx_ready.items()}
            tx = {k: (p, v & en) for k, (p, v) in tx.items()}
        new_states.append(new_st)

        if blk.in_ports:
            pop_ready[rxm.reshape(-1)] = torch.stack(
                [rx_ready[p] for p in blk.in_ports], 1).reshape(-1)
        if blk.out_ports:
            push_payload[txm.reshape(-1)] = torch.stack(
                [tx[p][0] for p in blk.out_ports], 1).reshape(-1, W).to(dtype)
            push_valid[txm.reshape(-1)] = torch.stack(
                [tx[p][1] for p in blk.out_ports], 1).reshape(-1)

    push_valid.view(-1, n_local)[:, NULL_TX] = False
    pop_ready.view(-1, n_local)[:, NULL_RX] = False
    q2, _, _ = (qmod.cycle_ if inplace else qmod.cycle)(
        q, push_payload, push_valid, pop_ready)
    step = 1 if stop is None else (~stop).to(st.cycle.dtype)
    return st.replace(queues=q2, block_states=tuple(new_states),
                      cycle=st.cycle + step)


class GraphEngine(Placement):
    """Epoch-batched queue interpreter of a partitioned ChannelGraph.

    graph:     the channel-graph IR (``Network.graph()`` or a builder).
    partition: a ``graph.PartitionTree`` (carries both the instance ->
               granule map and the tier structure), or any flat instance ->
               granule map ``normalize_partition`` accepts.
    mesh:      ``None`` or ``{axis name: size}`` of the real device axes:
               the granules along them are shards, each a state of its
               own on its own device (``core.mesh``).
    K:         innermost sync rate (ignored when ``partition`` is a
               PartitionTree or ``tiers`` is given).
    tiers:     per-tier spec (``graph.Tier`` or ``(axes, K)`` pairs,
               outermost first).  Default: one tier spanning ``axes`` (or
               the mesh axes then the other batch axes, or one axis
               ``"g"``) with rate ``K``.
    batch_axes: the granule axes stacked on the on-device batch axis — axis
               names (sizes from ``mesh``) or ``{name: size}``.  Must be an
               innermost suffix of the granule axes.
    overlap:   split every tier exchange into issue and commit halves
               ("auto"/bool, ``REPRO_OVERLAP`` env override).  Bit-identical
               to the serial schedule by construction.
    device:    where state and tables live: one device for every shard,
               or a sequence of ``prod(real_shape)`` devices, one a shard
               in row-major order of the real axes (the devices of a
               ``jax.sharding.Mesh``).  ``"cuda"`` by default (the current
               card), and raises without CUDA (pass ``device="cpu"``).
    """

    engine_kind = "graph"

    def __init__(
        self,
        graph: ChannelGraph,
        partition,
        mesh: Mapping[str, int] | None = None,
        K: int = 1,
        axes: Sequence[str] | None = None,
        tiers: Sequence | None = None,
        batch_axes=None,
        overlap: Any = "auto",
        device="cuda",
    ):
        self.graph = graph
        self.mesh = dict(mesh) if mesh is not None else {}
        self.overlap = granule_step.resolve_overlap(overlap)
        if batch_axes is None:
            bmap: dict[str, int | None] = {}
        elif isinstance(batch_axes, Mapping):
            bmap = {str(a): int(s) for a, s in batch_axes.items()}
        else:
            bmap = {str(a): None for a in batch_axes}

        def axis_size(a: str) -> int:
            s = bmap.get(a)
            if s is not None:
                return s
            if a not in self.mesh:
                raise ValueError(
                    f"axis {a!r} is not a mesh axis; pass its size via "
                    f"batch_axes={{{a!r}: size}}"
                )
            return int(self.mesh[a])

        if isinstance(partition, PartitionTree):
            if tiers is not None:
                raise ValueError("pass tiers via the PartitionTree or the "
                                 "tiers kwarg, not both")
            if axes is not None:
                raise ValueError(
                    "axes is derived from the PartitionTree's tiers — "
                    "pass the axis order there"
                )
            ptree = partition
            shape = tuple(
                sz if (a in bmap and bmap[a] is None) or
                (a not in bmap and a not in self.mesh) else axis_size(a)
                for a, sz in zip(ptree.axes, ptree.dev_shape)
            )
            if shape != ptree.dev_shape:
                raise ValueError(
                    f"PartitionTree device shape {ptree.dev_shape} does not "
                    f"match mesh/batch axes {ptree.axes} = {shape}"
                )
            if ptree.part.shape != (graph.n_instances,):
                raise ValueError(
                    f"PartitionTree covers {ptree.part.size} instances, "
                    f"graph has {graph.n_instances}"
                )
        else:
            if tiers is not None:
                if axes is not None:
                    raise ValueError(
                        "axes is derived from the tier spec when tiers is "
                        "given — pass the axis order via the tiers entries"
                    )
                tspec = normalize_tiers(tiers)
            else:
                t_axes = (tuple(axes) if axes is not None
                          else tuple(self.mesh) + tuple(a for a in bmap if a not in self.mesh)
                          or ("g",))
                tspec = (Tier(axes=t_axes, K=int(K)),)
            all_axes = tuple(a for t in tspec for a in t.axes)
            for a in all_axes:  # unnamed axes default to size 1
                if a not in bmap and a not in self.mesh:
                    self.mesh[a] = 1
            n_gran = int(np.prod([axis_size(a) for a in all_axes]))
            part = normalize_partition(graph, partition, n_gran)
            ptree = PartitionTree(
                part, tspec, {a: axis_size(a) for a in all_axes}
            )
        self.ptree = ptree
        self.tiers = ptree.tiers
        self.axes = ptree.axes
        self.dev_shape = ptree.dev_shape
        self.nd = len(self.dev_shape)
        unknown = set(bmap) - set(ptree.axes)
        if unknown:
            raise ValueError(f"batch_axes {sorted(unknown)} are not "
                             f"granule axes {ptree.axes}")
        self.batch_axes = tuple(a for a in ptree.axes if a in bmap)
        self.nd_real = self.nd - len(self.batch_axes)
        if self.batch_axes != tuple(ptree.axes[self.nd_real:]):
            raise ValueError(
                f"batch_axes {self.batch_axes} must be a contiguous "
                f"innermost suffix of the granule axes {ptree.axes}"
            )
        self.real_axes = tuple(ptree.axes[: self.nd_real])
        self.real_shape = ptree.dev_shape[: self.nd_real]
        self.batch_shape = ptree.dev_shape[self.nd_real:]
        self.G_real = int(np.prod(self.real_shape)) if self.real_shape else 1
        self._sharded = self.G_real > 1
        self.devices = shard_devices(device, self.G_real)
        # one shard: its device (a sequence of one is unwrapped)
        self.device = (self.devices[0] if self._sharded or isinstance(device, (list, tuple))
                       else resolve_device(device))
        self.B = int(np.prod(self.batch_shape)) if self.batch_shape else 1
        self.G = ptree.n_granules
        self.K_tiers = ptree.K_tiers
        self.periods = ptree.periods()
        self.cycles_per_epoch = ptree.cycles_per_epoch
        self.K = self.K_tiers[-1]  # innermost rate
        # max packets per boundary channel per *its tier's* exchange
        self.E_tiers = tuple(
            min(p, graph.capacity - 1) for p in self.periods
        )
        self.E = self.E_tiers[-1]
        self.W = graph.payload_words
        self.capacity = graph.capacity
        self.dtype = graph.dtype
        self.part = ptree.part
        self._batched = bool(self.batch_axes)
        # the card's path updates the state it owns in place
        self._inplace = self.device.type == "cuda"
        self._until_cache: dict = {}  # run_until's captured spans
        self._n_row = None  # queue rows a granule (the exchange's row stride)
        self._build_tables()
        self._n_row = self.n_local

    # ------------------------------------------------- host-side lowering
    def _build_tables(self) -> None:
        """Lower (graph, partition) to per-granule tables — all vectorized.

        The mesh-independent half (queue-id assignment, per-group member
        placement, boundary routes) is ``graph.lower_partition``.  This
        method adds the per-tier exchange-class coloring and the
        concatenated slab tables of the batched exchange: per tier, König
        classes, then compatible-permutation merging, then concatenation
        into ONE (G, S_t) slot table.  Under ``batch_axes`` the coloring is
        refined per *real-axis* shift first: every route of a class then
        shares one injective shard->shard map (its ``real_perm``, () when
        the class never leaves a shard), and the within-shard move becomes
        the ``bat_fwd``/``bat_rev`` batch-row gathers.
        """
        g, G, B = self.graph, self.G, self.B
        low = lower_partition(g, self.ptree)
        self.lowering = low
        tx_local, rx_local = low.tx_local, low.rx_local
        self.n_local = low.n_local
        self._tx_local, self._rx_local = tx_local, rx_local
        self._chan_owner = low.chan_owner
        self._ent = low.ent
        self._rx_tables, self._tx_tables = low.rx_tables, low.tx_tables
        self._act_tables = low.act_tables
        self._member_of = low.member_of
        self._member_granule = low.member_granule
        self._member_slot = low.member_slot
        self._n_slot = low.n_slot
        self._gather_idx: dict = {}  # gather_group's index a group, once
        self._member_idx: dict = {}  # init's index a group, on the device, once
        routes = low.routes  # (tier, src granule, dst granule) -> channels

        self.classes: list[_ExchangeClass] = []
        self.tier_classes: list[list[_ExchangeClass]] = []
        send_i, send_m, recv_i, recv_m = [], [], [], []
        bat_f, bat_r = [], []
        G_real = self.G_real
        for t in range(len(self.tiers)):
            pairs = sorted((s, d) for tt, s, d in routes if tt == t)
            if self._batched:
                shift_groups: dict[tuple, list[tuple[int, int]]] = {}
                for s, d in pairs:
                    sc = np.unravel_index(s, self.dev_shape)
                    dc = np.unravel_index(d, self.dev_shape)
                    shift = tuple(
                        int(dc[i]) - int(sc[i]) for i in range(self.nd_real)
                    )
                    shift_groups.setdefault(shift, []).append((s, d))
                colors, rperms = [], []
                for shift in sorted(shift_groups):
                    for color in merge_compatible_classes(
                        edge_color_routes(shift_groups[shift], G)
                    ):
                        colors.append(color)
                        rperms.append(tuple(sorted(
                            {(s // B, d // B) for s, d in color}
                        )) if any(shift) else ())
            else:
                colors = merge_compatible_classes(edge_color_routes(pairs, G))
                rperms = [None] * len(colors)
                if pairs:
                    # a fixed shift is one permutation, so no decomposition
                    # needs more classes than distinct shifts (König: fewer)
                    n_shifts = len(route_shift_groups(pairs, self.dev_shape))
                    if len(colors) > n_shifts:
                        raise AssertionError((len(colors), n_shifts))
            cmaxes = [
                max(len(routes[(t, s, d)]) for s, d in color) for color in colors
            ]
            S_t = sum(cmaxes)
            si = np.zeros((G, S_t), np.int64)
            sm = np.zeros((G, S_t), bool)
            ri = np.zeros((G, S_t), np.int64)
            rm = np.zeros((G, S_t), bool)
            bf = np.zeros((G_real, B, S_t), np.int64)
            br = np.zeros((G_real, B, S_t), np.int64)
            cls_t: list[_ExchangeClass] = []
            col0 = 0
            for color, cmax, rperm in zip(colors, cmaxes, rperms):
                for s, d in color:
                    chans = routes[(t, s, d)]
                    k = len(chans)
                    si[s, col0:col0 + k] = tx_local[chans]
                    sm[s, col0:col0 + k] = True
                    ri[d, col0:col0 + k] = rx_local[chans]
                    rm[d, col0:col0 + k] = True
                    rs, bs = divmod(s, B)
                    rd, bd = divmod(d, B)
                    bf[rs, bd, col0:col0 + k] = bs
                    br[rd, bs, col0:col0 + k] = bd
                cls = _ExchangeClass(
                    perm=tuple(color), cmax=cmax, tier=t,
                    depth=self.E_tiers[t], col0=col0, real_perm=rperm,
                )
                cls_t.append(cls)
                self.classes.append(cls)
                col0 += cmax
            self.tier_classes.append(cls_t)
            send_i.append(si.astype(np.int32))
            send_m.append(sm)
            recv_i.append(ri.astype(np.int32))
            recv_m.append(rm)
            bat_f.append(bf.astype(np.int32))
            bat_r.append(br.astype(np.int32))
        self._send_idx, self._send_mask = send_i, send_m
        self._recv_idx, self._recv_mask = recv_i, recv_m
        self._bat_fwd = bat_f if self._batched else []
        self._bat_rev = bat_r if self._batched else []

        # Trailing tiers with NO exchange classes never synchronize, so
        # their loop nesting is pure overhead: tiers >= _fold_from run as
        # one contiguous inner-cycle block of prod(K_t..K_inner) cycles.
        f = len(self.tiers)
        while f > 0 and not self.tier_classes[f - 1]:
            f -= 1
        self._fold_from = f

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """(G, ...) host table -> (dev_shape..., ...) device tensor."""
        return torch.as_tensor(
            np.ascontiguousarray(arr.reshape(self.dev_shape + arr.shape[1:])),
            device=self.device,
        )

    def _dev_bat(self, arr: np.ndarray) -> torch.Tensor:
        """(G_real, B, S_t) batch-gather table -> (dev_shape..., S_t)."""
        return torch.as_tensor(
            np.ascontiguousarray(
                arr.reshape(self.real_shape + self.batch_shape + arr.shape[2:])
            ),
            device=self.device,
        )

    def tables(self) -> GraphTables:
        """Every granule's tables, in the global layout."""
        return GraphTables(
            rx_idx=tuple(self._dev(t) for t in self._rx_tables),
            tx_idx=tuple(self._dev(t) for t in self._tx_tables),
            active=tuple(self._dev(t) for t in self._act_tables),
            send_idx=tuple(self._dev(t) for t in self._send_idx),
            send_mask=tuple(self._dev(t) for t in self._send_mask),
            recv_idx=tuple(self._dev(t) for t in self._recv_idx),
            recv_mask=tuple(self._dev(t) for t in self._recv_mask),
            bat_fwd=tuple(self._dev_bat(t) for t in self._bat_fwd),
            bat_rev=tuple(self._dev_bat(t) for t in self._bat_rev),
        )

    # ------------------------------------------------------------------ init
    def _init_block_states(self, key, group_params) -> list:
        """Per-group block states in granule layout, shared with
        ``FusedEngine.init``: every member is initialized in global
        instantiation order (the order ``NetworkSim`` uses), then gathered
        into its (granule, slot); padding slots copy member 0, as in the
        JAX package."""
        states = []
        for gi, grp in enumerate(self.graph.groups):
            params = grp.params
            if group_params is not None and gi in group_params:
                params = group_params[gi]
            params = tree_map(lambda x: to_tensor(x, self.device), params)
            st = grp.block.init_state(
                grp.n_members, params, generator=group_generator(key, gi),
                device=self.device,
            )
            n_slot = self._n_slot[gi]
            if gi not in self._member_idx:  # uploaded once, not every reset
                self._member_idx[gi] = torch.as_tensor(self._member_of[gi].reshape(-1),
                                                       device=self.device)
            mo = self._member_idx[gi]
            states.append(tree_map(
                lambda x: x[mo].reshape(self.dev_shape + (n_slot,) + x.shape[1:]),
                st,
            ))
        return states

    def init(self, key=0, group_params: dict | None = None, *,
             into: GraphState | None = None) -> GraphState:
        """Initial state.  ``key`` is an int seed or a ``torch.Generator``
        for block ``init_state``; ``group_params[gi]`` overrides the IR's
        stacked per-member params of group ``gi`` (leading dim =
        n_members, in global instantiation order).  A sharded engine's
        state is a ``core.mesh.ShardedState`` (see :meth:`place`).  Traced
        as the ``init.state`` and ``init.tables`` spans (``obs.trace``).

        ``into``, an earlier state of this engine (``Simulation.reset``
        passes its live one), lends the new state its tables, which no run
        changes, so they are not uploaded again; the caller copies the
        other leaves into its tensors.  A sharded state lends nothing."""
        rec = _trace.recorder()
        into = into if isinstance(into, GraphState) else None
        with rec.session_span("init.state"):
            states = self._init_block_states(key, group_params)
            lead = self.dev_shape
            q = qmod.make_queues(self.n_local, self.W, self.capacity, self.dtype,
                                 self.device)
            zi = lambda shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                           device=self.device)
            fields = dict(
                queues=tree_map(lambda x: x.expand(lead + x.shape).contiguous(), q),
                block_states=tuple(states),
                credits=tuple(
                    torch.full(lead + (si.shape[1],), self.capacity - 1,
                               dtype=torch.int32, device=self.device)
                    for si in self._send_idx
                ),
                cycle=zi(lead),
                epoch=zi(lead),
            )
        with rec.session_span("init.tables"):
            tables = self.tables() if into is None else into.tables
            return self.place(GraphState(**fields, tables=tables))

    # ------------------------------------------------- shards and placement
    def _gathered(self, state, pick: Callable) -> Tree:
        """``pick(shard state)`` of every shard in the global layout, as
        numpy leaves: copies, also of a CPU state, whose tensors the next
        run or reset may overwrite.  A leaf on the card is copied once into
        page-locked host memory from the caching host allocator: into
        pageable memory the copy faults in and zeroes fresh pages every
        read (32 MiB took ~15-19 ms on the H100's host, page-locked ~0.7
        ms).  The arrays are the caller's: each keeps its block until the
        caller drops it, and the block then serves a later read."""
        parts = [pick(s) for s in self._shards(state)]
        tree = gather(parts, self.real_shape) if self._sharded else parts[0]

        def to_host(x: torch.Tensor):
            if x.device.type != "cuda":
                return x.detach().to("cpu", copy=True).numpy()
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x.detach())
            return out.numpy()

        return tree_map(to_host, tree)

    def _locate(self, didx: Sequence[int]) -> tuple[int, tuple]:
        """(shard, index within the shard's leading dims) of the granule at
        ``dev_shape`` coordinates ``didx``."""
        nd = self.nd_real
        r = int(np.ravel_multi_index(tuple(didx[:nd]), self.real_shape)) if nd else 0
        return r, (0,) * nd + tuple(int(i) for i in didx[nd:])

    # -------------------------------------------------- local <-> global view
    def _local_view(self, state: GraphState) -> GraphState:
        """Per-shard view of a shard's state: the batch axes flattened into
        ONE leading (B,) axis, or, unbatched, the (1,)*nd device dims
        stripped (views, no copies)."""
        nd = self.nd
        if not self._batched:
            return tree_map(lambda x: x.reshape(x.shape[nd:]), state)
        return tree_map(lambda x: x.reshape((self.B,) + x.shape[nd:]), state)

    def _global_view(self, local: GraphState) -> GraphState:
        if not self._batched:
            return tree_map(lambda x: x.reshape((1,) * self.nd + x.shape), local)
        lead = (1,) * self.nd_real + self.batch_shape
        return tree_map(lambda x: x.reshape(lead + x.shape[1:]), local)

    def _enter(self, state) -> tuple:
        """The local view of every shard: what an epoch runs on."""
        return tuple(self._local_view(s) for s in self._shards(state))

    def _leave(self, locs: Sequence):
        """The engine state holding the local views ``locs``."""
        return self._join([self._global_view(x) for x in locs])

    def _fold(self, local: GraphState) -> GraphState:
        """An epoch's working form of the local view: the B granules folded
        into the queue rows (``b * n_local + id``) and block slots
        (``b * n_slot + s``), the port tables holding those flat row ids,
        credits, cycle and exchange tables kept per row (B leading)."""
        if not self._batched:
            local = tree_map(lambda x: x.unsqueeze(0), local)
        fold = lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])  # noqa: E731
        tb = local.tables
        base = torch.arange(self.B, device=tb.rx_idx[0].device)[:, None, None] * self.n_local

        def flat(t):  # (B, n_slot, n_port) local ids -> (B*n_slot, n_port) rows
            return (t.long() + base).reshape(t.shape[0] * t.shape[1], t.shape[2])

        return local.replace(
            queues=tree_map(fold, local.queues),
            block_states=tree_map(fold, local.block_states),
            tables=tb.replace(rx_idx=tuple(flat(t) for t in tb.rx_idx),
                              tx_idx=tuple(flat(t) for t in tb.tx_idx)),
        )

    @staticmethod
    def _unfold(work: GraphState, local: GraphState) -> GraphState:
        """The local view holding ``work``'s leaves (the inverse of
        :meth:`_fold`; tables are the local view's own)."""
        out = tree_map(lambda x, ref: x.reshape(ref.shape),
                       work.replace(tables=None), local.replace(tables=None))
        return out.replace(tables=local.tables)

    # ------------------------------------------------------- tier exchange
    @staticmethod
    def _bat_move(x: torch.Tensor, tbl: torch.Tensor | None) -> torch.Tensor:
        """The within-shard slab move: ``out[b, s] = x[tbl[b, s], s]``, the
        whole tier in one gather (the classes' column windows tile the
        slot axis); ``tbl`` None (unbatched: one granule a shard) moves
        nothing.  Garbage rows from the 0-padded tables are killed by the
        send/recv masks downstream."""
        if tbl is None:
            return x
        idx = tbl.long().reshape(tbl.shape + (1,) * (x.ndim - 2)).expand_as(x)
        return torch.gather(x, 0, idx)

    def _shard_move(self, xs: Sequence[torch.Tensor], t: int,
                    rev: bool = False) -> tuple:
        """The part of tier ``t``'s exchange that leaves a shard (the
        reference's ``ppermute``): for every class with a shard map
        (``real_perm``, or ``perm`` unbatched), each shard's column window
        of ``xs`` (per-shard ``(B, S_t, ...)`` tensors, through the local
        gather already) becomes a copy of its sender's — device-local on
        one card, a peer copy across cards — and zeros where no shard
        sends.  ``rev`` runs the reverse maps (the credit return).  The
        columns of classes that stay on a shard keep the local gather."""
        moves = [cl for cl in self.tier_classes[t] if cl.shard_perm()]
        if not moves:
            return tuple(xs)
        out = [x.clone() for x in xs]
        for cl in moves:
            cols = slice(cl.col0, cl.col0 + cl.cmax)
            src_of = {(s if rev else d): (d if rev else s) for s, d in cl.shard_perm()}
            for r, o in enumerate(out):
                if r in src_of:
                    o[:, cols].copy_(xs[src_of[r]][:, cols])
                else:
                    o[:, cols].zero_()
        return tuple(out)

    def _drain_tier(self, q: qmod.QueueArray, n_row: int, credits: tuple,
                    t: int, tb, stop=None, inplace: bool = False):
        """Tier t's issue on one shard, on queue rows flattened as
        ``b * n_row + k``: credit-bounded ``stage_drain`` of every egress
        row, then the local ``bat_fwd`` gather.  Returns ``(q, slab, cnt)``
        (``(B, S_t, E_t, W)``, ``(B, S_t)``); touches egress rows and reads
        this tier's credits only.  Where ``stop`` is set nothing drains;
        ``inplace`` drains with ``stage_drain_``."""
        sidx, smask = tb.send_idx[t], tb.send_mask[t]  # (B, S_t)
        B, S = sidx.shape
        base = torch.arange(B, dtype=sidx.dtype, device=sidx.device)[:, None] * n_row
        zero = torch.zeros_like(credits[t])
        limit = torch.where(smask, credits[t], zero)
        if stop is not None:
            limit = torch.where(stop, zero, limit)
        drain = qmod.stage_drain_ if inplace else qmod.stage_drain
        q, slab, cnt = drain(
            q, (base + sidx).reshape(-1), self.E_tiers[t], limit=limit.reshape(-1)
        )
        bfw = tb.bat_fwd[t] if tb.bat_fwd else None
        return (q, self._bat_move(slab.reshape((B, S) + slab.shape[1:]), bfw),
                self._bat_move(cnt.reshape(B, S), bfw))

    def _fill_tier(self, q: qmod.QueueArray, n_row: int, t: int, tb, pending,
                   inplace: bool = False):
        """Tier t's commit on one shard: ``stage_fill`` of every ingress row
        from the arrived ``(slab_in, cnt_in)``, then each receiver's fresh
        credit (its free space) through the local ``bat_rev`` gather.
        Returns ``(q, cred)``; touches ingress rows only."""
        slab_in, cnt_in = pending
        ridx, rmask = tb.recv_idx[t], tb.recv_mask[t]
        B, S = ridx.shape
        base = torch.arange(B, dtype=ridx.dtype, device=ridx.device)[:, None] * n_row
        fill = qmod.stage_fill_ if inplace else qmod.stage_fill
        q = fill(
            q, (base + ridx).reshape(-1),
            slab_in.reshape((B * S,) + slab_in.shape[2:]), cnt_in.reshape(-1),
        )
        free = qmod.free(q).reshape(B, n_row)
        cred = torch.where(rmask, torch.gather(free, 1, ridx.long()),
                           torch.zeros_like(ridx))
        return q, self._bat_move(cred, tb.bat_rev[t] if tb.bat_rev else None)

    @staticmethod
    def _arrived(cnt: torch.Tensor, tb, t: int) -> torch.Tensor:
        """The receiver's counts: zero where its recv mask is off."""
        return torch.where(tb.recv_mask[t], cnt, torch.zeros_like(cnt))

    @staticmethod
    def _new_credits(credits: tuple, t: int, new: torch.Tensor, stop=None) -> tuple:
        """``credits`` with tier t's replaced by ``new`` (kept where ``stop``
        is set: the slab was empty then)."""
        if stop is not None:
            new = torch.where(stop, credits[t], new)
        return credits[:t] + (new,) + credits[t + 1:]

    # ----------------------------------------------------------- local cycle
    def _in_place(self, st: GraphState) -> bool:
        """Whether ``st``'s queue array is written in place: on the
        engine's own device when it updates in place (the card); a copy
        elsewhere (a CPU copy of a card's state) runs the functional
        forms."""
        return self._inplace and st.queues.buf.device.type == self.device.type

    def _local_cycle(self, st: GraphState, stop=None) -> GraphState:
        """One cycle of every granule of a shard (the folded working
        state)."""
        return granule_local_cycle(self.graph.groups, self.n_local, self.W,
                                   self.dtype, st, stop=stop,
                                   inplace=self._in_place(st))

    # ---------------------------------------------------------------- epoch
    # The schedule below runs on ``sts``: the working state of every shard.
    def _exchange_issue(self, sts: tuple, t: int, stop=None):
        """Tier t's exchange, issue half: every shard drains its egress
        queues (credit-bounded) into the slab, the slab moves to its
        receivers — between batch rows, then between shards.  Returns
        ``(sts, pending)``, pending a ``(slab_in, cnt_in)`` a shard, or
        ``None`` when the tier has no exchange classes."""
        if not self.tier_classes[t]:
            return sts, None
        drained = [self._drain_tier(st.queues, self._n_row, st.credits, t,
                                    st.tables, stop, self._in_place(st))
                   for st in sts]
        slabs = self._shard_move([d[1] for d in drained], t)
        cnts = self._shard_move([d[2] for d in drained], t)
        sts = tuple(st.replace(queues=d[0]) for st, d in zip(sts, drained))
        return sts, tuple((s, self._arrived(c, st.tables, t))
                          for st, s, c in zip(sts, slabs, cnts))

    def _exchange_commit(self, sts: tuple, t: int, pending, stop=None) -> tuple:
        """Tier t's exchange, commit half: every shard lands its slab in
        the ingress queues, and fresh credits return to the senders on the
        reverse maps."""
        if pending is None:
            return sts
        filled = [self._fill_tier(st.queues, self._n_row, t, st.tables, p,
                                  self._in_place(st))
                  for st, p in zip(sts, pending)]
        creds = self._shard_move([f[1] for f in filled], t, rev=True)
        return tuple(st.replace(queues=f[0],
                                credits=self._new_credits(st.credits, t, c, stop))
                     for st, f, c in zip(sts, filled, creds))

    def _exchange_tier(self, sts: tuple, t: int, stop=None) -> tuple:
        """Tier t's serial exchange: commit∘issue, so the serial and
        overlapped schedules share every operation and differ only in
        order."""
        sts, pending = self._exchange_issue(sts, t, stop)
        return self._exchange_commit(sts, t, pending, stop)

    def _inner_cycles(self, sts: tuple, K: int, stop=None, program=None) -> tuple:
        """K granule-local cycles of every shard — the innermost hot loop."""
        out = []
        for st in sts:
            for _ in range(K):
                st = self._local_cycle(st, stop)
            out.append(st)
        return tuple(out)

    def _tier_round(self, sts: tuple, t: int, stop=None, program=None) -> tuple:
        """One round of tier t: K_t sub-rounds (granule-local cycles at the
        innermost tier, tier-(t+1) rounds otherwise), then tier t's
        exchange — so tier t synchronizes every ``periods[t]`` cycles.
        Exchange-free trailing tiers are folded into one contiguous
        inner-cycle block."""
        if t >= self._fold_from:
            return self._inner_cycles(sts, int(np.prod(self.K_tiers[t:])), stop, program)
        if t == len(self.tiers) - 1:
            sts = self._inner_cycles(sts, self.tiers[t].K, stop, program)
        else:
            for _ in range(self.tiers[t].K):
                sts = self._tier_round(sts, t + 1, stop, program)
        return self._exchange_tier(sts, t, stop)

    # --------------------------------------------- overlapped (split) schedule
    def _pend_tiers(self, t0: int) -> tuple:
        """Static tier order of the pending chain ``_round_split(st, t0)``
        returns: the suffix of tiers whose exchanges fire *at the end* of a
        tier-t0 round, deepest first."""
        if t0 >= self._fold_from:
            return ()
        inner = () if t0 == len(self.tiers) - 1 else self._pend_tiers(t0 + 1)
        return inner + ((t0,) if self.tier_classes[t0] else ())

    def _commit_chain(self, sts: tuple, t0: int, pend: tuple, stop=None) -> tuple:
        """Commit a pending chain from ``_round_split(·, t0)`` — fills land
        deepest tier first, the order the serial schedule fills them."""
        tiers = self._pend_tiers(t0)
        if len(tiers) != len(pend):
            raise AssertionError((tiers, len(pend)))
        for t, p in zip(tiers, pend):
            sts = self._exchange_commit(sts, t, p, stop)
        return sts

    def _round_split(self, sts: tuple, t: int, stop=None, program=None):
        """One round of tier t with *split* exchanges: every sub-round's
        boundary transfers are issued at its window's end and committed at
        the start of the next sub-round's window; the final boundary's
        chain is returned *pending* for the caller to commit at its next
        window.  Bit-identical to ``_tier_round``: issue reads egress rows
        and credits[t] only, commit writes ingress rows and credits[t]
        only, those sets are disjoint across tiers, and every commit still
        precedes the first cycle that could consume what it fills."""
        if t >= self._fold_from:
            return self._inner_cycles(sts, int(np.prod(self.K_tiers[t:])), stop,
                                      program), ()
        if t == len(self.tiers) - 1:
            sts, pend = self._inner_cycles(sts, self.tiers[t].K, stop, program), ()
        else:
            sts, pend = self._round_split(sts, t + 1, stop, program)
            for _ in range(self.tiers[t].K - 1):
                sts = self._commit_chain(sts, t + 1, pend, stop)
                sts, pend = self._round_split(sts, t + 1, stop, program)
        if self.tier_classes[t]:
            sts, p_t = self._exchange_issue(sts, t, stop)
            pend = pend + (p_t,)
        return sts, pend

    def _epoch_all(self, locs: tuple, stop=None, program=None) -> tuple:
        """One outermost round of every shard = ``cycles_per_epoch`` local
        cycles, every tier exchanged at its own cadence (the split schedule
        under ``overlap``, its last chain committed before returning: epoch
        boundaries are host-I/O points).  ``locs`` is each shard's local
        view.  Where ``stop`` (the until-loop's () bool tensor) is set, the
        epoch leaves the state as it was; a gated epoch bumps no registry
        counter (``until.epochs`` counts the loop's)."""
        sts = tuple(self._fold(x) for x in locs)
        if self.overlap:
            sts, pend = self._round_split(sts, 0, stop, program)
            sts = self._commit_chain(sts, 0, pend, stop)
        else:
            sts = self._tier_round(sts, 0, stop, program)
        if stop is None:  # the until-loop counts its own epochs
            REGISTRY.inc(f"{self.engine_kind}.dispatch.count")
            REGISTRY.inc(f"{self.engine_kind}.epochs")
        step = 1 if stop is None else (~stop).to(locs[0].epoch.dtype)
        return tuple(self._unfold(st, x).replace(epoch=x.epoch + step)
                     for st, x in zip(sts, locs))

    def _epoch(self, local: GraphState, stop=None) -> GraphState:
        """One epoch of an unsharded engine's local view."""
        return self._epoch_all((local,), stop)[0]

    def _owned(self, state, donate: bool):
        """The state a run may update, placed: the device path updates
        tensors in place, so a caller who keeps its input
        (``donate=False``) gets a copy run instead."""
        if self._sharded and not isinstance(state, ShardedState):
            return self.place(state)  # a copy on the shards already
        if donate or not self._inplace:
            return state
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                        state)

    def run_epochs(self, state, n_epochs: int, *, donate: bool = True):
        """Advance ``n_epochs`` outermost epochs.

        ``donate=True`` (default) lets the CUDA path update the state's
        tensors in place: the *input* state must not be reused afterwards.
        Pass ``donate=False`` to keep the input alive."""
        locs = self._enter(self._owned(state, donate))
        for _ in range(n_epochs):
            locs = self._epoch_all(locs)
        return self._leave(locs)

    def run_cycles(self, state, n_cycles: int, *, donate: bool = True):
        """Advance ``ceil(n_cycles / cycles_per_epoch)`` outermost epochs
        (>= n_cycles local cycles)."""
        return self.run_epochs(state, -(-n_cycles // self.cycles_per_epoch),
                               donate=donate)

    def _done_view(self, local):
        """What ``run_until``'s predicate sees (a shard's local state)."""
        return local

    def _done_all(self, locs: tuple, done_fn: Callable) -> torch.Tensor:
        """() bool: ``done_fn`` holds on every shard — each shard's result
        reduced on its own device (``.all()``, which covers a (B,)-shaped
        batched predicate), then over the shards, the reference's local
        sum and ``psum`` of not-done.  No host read."""
        return all_shards([device_loop.flag(done_fn(self._done_view(x)), x.epoch.device)
                           for x in locs])

    def run_until(
        self,
        state,
        done_fn: Callable[[Any], torch.Tensor],
        max_epochs: int,
        *,
        cache_key: Any = None,
        donate: bool = True,
    ):
        """Run epochs until ``done_fn(self._done_view(local))`` holds on
        every granule of every shard, or at most ``max_epochs`` MORE epochs
        from the input state (a relative budget).  The predicate is checked
        before every epoch, so an already-done state runs zero epochs; it
        sees one shard's local view at a time, and the shards' results are
        combined on the device (``_done_all``).

        The loop runs on the device (``core.device_loop``): on a CUDA state
        spans of epochs replay from a CUDA graph, the predicate reduced and
        the stop decided on the card, and the host waits once a span.  The
        predicate must return a device tensor without reading it back.  The
        captured span is cached per (predicate, ``max_epochs``, ``donate``)
        and the state's tensors (every shard's); the cache pins
        ``cache_key`` if given, else ``done_fn`` — pass ``cache_key`` when
        the predicate is a fresh lambda per call but semantically constant.
        Shards on several cards raise ``NotImplementedError``.

        ``donate=True`` (default) lets the CUDA path update the state's
        tensors in place: the input state must not be reused afterwards.
        ``donate=False`` runs on a clone at new addresses, so every such
        call captures its span anew, where a donated state that is run
        again replays the span it captured."""
        require_one_card(self.devices)
        return device_loop.run_until(
            self._until_cache, self._owned(state, donate),
            enter=self._enter, leave=self._leave,
            epoch=lambda locs, stop: self._epoch_all(locs, stop=stop),
            done=lambda locs: self._done_all(locs, done_fn),
            max_epochs=max_epochs, donate=donate,
            anchor=done_fn if cache_key is None else cache_key,
        )

    def run_until_host(self, state, done_fn: Callable[[Any], torch.Tensor],
                       max_epochs: int, *, donate: bool = True):
        """The plain version of :meth:`run_until`: the predicate read back
        on the host before every epoch (``device_loop.host_loop``), the
        yardstick the device loop is held against."""
        return device_loop.host_loop(
            self._owned(state, donate),
            enter=self._enter, leave=self._leave,
            epoch=lambda locs, stop: self._epoch_all(locs, stop=stop),
            done=lambda locs: self._done_all(locs, done_fn),
            max_epochs=max_epochs,
        )

    def host_done(self, state, done_fn: Callable) -> bool:
        """``done_fn`` read on the host, on the view ``run_until`` shows it."""
        return bool(self._done_all(self._enter(state), done_fn))

    # ------------------------------------------------------- host utilities
    def gather_group(self, state, gi: int) -> Tree:
        """Group ``gi``'s member states in global instantiation order
        (numpy leaves); traced as a ``session.read`` span."""
        n_slot = self._n_slot[gi]
        idx = self._gather_index(gi)
        with _trace.recorder().session_span("session.read", api="gather_group"):
            return tree_map(
                lambda x: x.reshape((self.G * n_slot,) + x.shape[self.nd + 1:])[idx],
                self._gathered(state, lambda s: s.block_states[gi]))

    def _gather_index(self, gi: int):
        """Where group ``gi``'s members sit in its flat (granule, slot)
        rows, in instantiation order, worked out once; a full slice where
        that is every row in order (the members fill their granules in
        turn), so the read takes no second copy."""
        if gi not in self._gather_idx:
            n_slot = self._n_slot[gi]
            idx = self._member_granule[gi] * n_slot + self._member_slot[gi]
            whole = idx.size == self.G * n_slot and np.array_equal(idx, np.arange(idx.size))
            self._gather_idx[gi] = slice(None) if whole else idx
        return self._gather_idx[gi]

    def group_state(self, state, inst) -> Tree:
        """One instance's (unstacked) state — mirrors NetworkSim.group_state."""
        inst_id = inst if isinstance(inst, int) else inst.inst_id
        gi, k = self.graph.locate(inst_id)
        r, idx = self._locate(
            np.unravel_index(int(self._member_granule[gi][k]), self.dev_shape))
        slot = int(self._member_slot[gi][k])
        return tree_map(lambda x: x[idx + (slot,)],
                        self._shards(state)[r].block_states[gi])

    # ---------------------- host-side external ports (PySbTx/PySbRx analogue)
    # External channels are *homed* on the granule that owns their simulated
    # endpoint: host I/O touches only that granule's queue row, on the shard
    # that holds it.
    def _ext_loc(self, cid: int) -> tuple[tuple[int, ...], int]:
        g = int(self._chan_owner[cid])
        didx = tuple(int(i) for i in np.unravel_index(g, self.dev_shape))
        return didx, int(max(self._rx_local[cid], self._tx_local[cid]))

    def _ext_at(self, table: dict, name: str) -> tuple[int, tuple]:
        """(shard, index into the shard's queue leaves) of port ``name``."""
        didx, row = self._ext_loc(table[name])
        r, idx = self._locate(didx)
        return r, idx + (row,)

    def _on_shard(self, state, r: int, fn: Callable):
        """``fn(shard r's state) -> (new shard state, *out)``; returns
        ``(new state, *out)``."""
        shards = list(self._shards(state))
        shards[r], *out = fn(shards[r])
        return (self._join(shards), *out)

    def port_stats(self, state) -> dict:
        """Per external port: occupancy/credit of the queue row homed on
        the owning granule (the ``Simulation.stats()["ports"]`` schema)."""
        size = self._gathered(state, lambda s: qmod.size(s.queues))

        def rec(cid):
            didx, row = self._ext_loc(cid)
            occ = int(size[didx + (row,)])
            return {"occupancy": occ, "credit": self.capacity - 1 - occ}

        return {
            "tx": {n: rec(c) for n, c in self.graph.ext_in.items()},
            "rx": {n: rec(c) for n, c in self.graph.ext_out.items()},
        }

    def _payload(self, payload, sub) -> torch.Tensor:
        return torch.as_tensor(np.asarray(payload), dtype=self.dtype,
                               device=sub.queues.buf.device)

    def host_push(self, state, name: str, payload):
        r, idx = self._ext_at(self.graph.ext_in, name)

        def push(sub):
            q2, ok = qmod.host_push(sub.queues, idx, self._payload(payload, sub))
            return sub.replace(queues=q2), ok

        return self._on_shard(state, r, push)

    def host_pop(self, state, name: str):
        r, idx = self._ext_at(self.graph.ext_out, name)

        def pop(sub):
            q2, front, valid = qmod.host_pop(sub.queues, idx)
            return sub.replace(queues=q2), front, valid

        return self._on_shard(state, r, pop)

    def host_push_many(self, state, name: str, payloads):
        r, idx = self._ext_at(self.graph.ext_in, name)

        def push(sub):
            pays = self._payload(payloads, sub).reshape(-1, self.W)
            q2, n = qmod.host_push_many(sub.queues, idx, pays)
            return sub.replace(queues=q2), n

        return self._on_shard(state, r, push)

    def host_pop_many(self, state, name: str, max_n: int):
        r, idx = self._ext_at(self.graph.ext_out, name)

        def pop(sub):
            q2, pays, cnt = qmod.host_pop_many(sub.queues, idx, max_n)
            return sub.replace(queues=q2), pays, cnt

        return self._on_shard(state, r, pop)

    def push_external(self, state, name: str, payload):
        warnings.warn(
            "push_external is deprecated; use the Simulation session's "
            "tx(name).send(...) (or engine.host_push)",
            DeprecationWarning, stacklevel=2,
        )
        return self.host_push(state, name, payload)

    def pop_external(self, state, name: str):
        warnings.warn(
            "pop_external is deprecated; use the Simulation session's "
            "rx(name).recv() (or engine.host_pop)",
            DeprecationWarning, stacklevel=2,
        )
        return self.host_pop(state, name)


class GridEngine(GraphEngine):
    """Uniform R×C grid preset over GraphEngine (the paper's §IV-B manycore).

    cell: Block with ports in=(w_in, n_in), out=(e_out, s_out).
    R, C: global grid shape; K: cycles per epoch.  The granule tile is
    ``Dr x Dc``, each the axis's size in ``batch_axes`` (a mapping) or
    ``mesh``, 1 where neither names it, as ``FusedEngine.grid`` takes it.

    The grid is lowered by ``ChannelGraph.grid`` and partitioned block-tile
    onto the granules; the exchange-class coloring reduces to the east +
    south slab schedule.
    """

    def __init__(
        self,
        cell: Block,
        R: int,
        C: int,
        mesh: Mapping[str, int] | None = None,
        K: int = 1,
        payload_words: int = 2,
        capacity: int = qmod.DEFAULT_CAPACITY,
        dtype: Any = torch.float32,
        axis_r: str = "gr",
        axis_c: str = "gc",
        *,
        batch_axes=None,
        overlap: Any = "auto",
        device="cuda",
    ):
        sizes = {**(mesh or {}),
                 **(batch_axes if isinstance(batch_axes, Mapping) else {})}
        Dr, Dc = int(sizes.get(axis_r, 1)), int(sizes.get(axis_c, 1))
        if R % Dr or C % Dc:
            raise ValueError(f"grid {R}x{C} not divisible by device tile {Dr}x{Dc}")
        graph = ChannelGraph.grid(cell, R, C, payload_words=payload_words,
                                  dtype=dtype, capacity=capacity)
        super().__init__(graph, grid_partition(R, C, Dr, Dc), mesh, K=K,
                         axes=(axis_r, axis_c), batch_axes=batch_axes,
                         overlap=overlap, device=device)
        self.cell = cell
        self.R, self.C = R, C
        self.Dr, self.Dc = Dr, Dc
        self.Tr, self.Tc = R // Dr, C // Dc

    def init(self, key=0, cell_params: Tree = None, *,
             into: GraphState | None = None) -> GraphState:
        """cell_params: a tree with leading (R, C) dims (global), numpy or
        tensors; ``into`` as in :meth:`GraphEngine.init`."""
        flat = tree_map(
            lambda x: x.reshape((self.R * self.C,) + tuple(x.shape[2:])),
            cell_params,
        )
        return super().init(key, group_params={0: flat}, into=into)

    def _done_view(self, local):
        """``run_until`` predicates see the granule-local cell states,
        leaves (Tr*Tc, ...) — (B, Tr*Tc, ...) when batched — not the whole
        GraphState."""
        return local.block_states[0]

    def gather_cells(self, state: GraphState) -> Tree:
        """Cell states reassembled to the global (R, C, ...) layout (numpy
        leaves)."""
        return tree_map(lambda x: x.reshape((self.R, self.C) + x.shape[1:]),
                        self.gather_group(state, 0))
