"""The single-device half of the partitioned engine, as in
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

This port runs every granule on one device, stacked on one batch axis
(``batch_axes``): a tier exchange is then a slab gather between batch
rows (``bat_fwd``/``bat_rev``), with no collective.  A real (non-batch)
granule axis larger than 1 needs the multi-GPU exchange and raises
``NotImplementedError``.  ``GraphEngine`` here is the shared base of
``fused.FusedEngine``: partition, tier and batch resolution, the exchange
tables, the batched exchange halves, the run loops and the host
utilities.  Its own queue-interpreter cycle (``granule_local_cycle``) is
not ported yet.

Routes (one per directed granule pair of a tier) are edge-colored into
**exchange classes** by the König construction, exactly as in the JAX
package, so the per-tier slot layout — and with it every credit and slab
table — is the same on both.

Credit protocol (DESIGN.md §3): the receiver of a boundary channel
advertises ``free(ingress)`` after each fill; the sender drains at most
that many packets at its tier's next exchange.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import device_loop
from . import queue as qmod
from ..kernels import granule_step
from .device import resolve_device
from .graph import (
    ChannelGraph, PartitionTree, Tier, lower_partition, normalize_partition,
    normalize_tiers,
)
from .struct import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class _ExchangeClass:
    """One partial permutation of boundary routes."""

    perm: tuple = ()  # ((src_granule, dst_granule), ...)
    cmax: int = 0  # max channels on any route
    tier: int = 0  # which tier's exchange runs this class
    depth: int = 1  # slab depth E = min(period, cap-1)
    col0: int = 0  # column offset in the tier slab


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


class GraphEngine:
    """Epoch-batched interpreter of a partitioned ChannelGraph, with every
    granule on one device.

    graph:     the channel-graph IR (``Network.graph()`` or a builder).
    partition: a ``graph.PartitionTree`` (carries both the instance ->
               granule map and the tier structure), or any flat instance ->
               granule map ``normalize_partition`` accepts.
    mesh:      ``None`` or ``{axis name: size}`` of the real device axes.
               The port runs on one device, so a real axis larger than 1
               raises ``NotImplementedError``; axes of size 1 may be named.
    K:         innermost sync rate (ignored when ``partition`` is a
               PartitionTree or ``tiers`` is given).
    tiers:     per-tier spec (``graph.Tier`` or ``(axes, K)`` pairs,
               outermost first).  Default: one tier spanning ``axes`` (or
               the mesh axes, or one axis ``"g"``) with rate ``K``.
    batch_axes: the granule axes stacked on the on-device batch axis — axis
               names (sizes from ``mesh``) or ``{name: size}``.  Must be an
               innermost suffix of the granule axes.
    overlap:   split every tier exchange into issue and commit halves
               ("auto"/bool, ``REPRO_OVERLAP`` env override).  Bit-identical
               to the serial schedule by construction.
    device:    where state and tables live; ``"cuda"`` by default, and
               raises without CUDA (pass ``device="cpu"``).
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
        self.device = resolve_device(device)
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
                          else tuple(self.mesh) or ("g",))
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
        if int(np.prod(self.real_shape)) > 1:
            raise NotImplementedError(
                f"real granule axes {dict(zip(self.real_axes, self.real_shape))} "
                "span several devices; the multi-GPU tier exchange is ROADMAP "
                "Queue 1 item 8 — stack the granules on batch_axes instead"
            )
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
        self._until_cache: dict = {}  # run_until's captured spans
        self._build_tables()

    # ------------------------------------------------- host-side lowering
    def _build_tables(self) -> None:
        """Lower (graph, partition) to per-granule tables — all vectorized.

        The mesh-independent half (queue-id assignment, per-group member
        placement, boundary routes) is ``graph.lower_partition``.  This
        method adds the per-tier exchange-class coloring and the
        concatenated slab tables of the batched exchange: per tier, König
        classes, then compatible-permutation merging, then concatenation
        into ONE (G, S_t) slot table, with the batch-row gathers
        ``bat_fwd``/``bat_rev`` of the on-device slab move.
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
        routes = low.routes  # (tier, src granule, dst granule) -> channels

        self.classes: list[_ExchangeClass] = []
        self.tier_classes: list[list[_ExchangeClass]] = []
        send_i, send_m, recv_i, recv_m = [], [], [], []
        bat_f, bat_r = [], []
        for t in range(len(self.tiers)):
            # every granule sits on one device, so every route has the zero
            # real-axis shift: one coloring per tier
            pairs = sorted((s, d) for tt, s, d in routes if tt == t)
            colors = merge_compatible_classes(edge_color_routes(pairs, G))
            cmaxes = [
                max(len(routes[(t, s, d)]) for s, d in color) for color in colors
            ]
            S_t = sum(cmaxes)
            si = np.zeros((G, S_t), np.int64)
            sm = np.zeros((G, S_t), bool)
            ri = np.zeros((G, S_t), np.int64)
            rm = np.zeros((G, S_t), bool)
            bf = np.zeros((1, B, S_t), np.int64)
            br = np.zeros((1, B, S_t), np.int64)
            cls_t: list[_ExchangeClass] = []
            col0 = 0
            for color, cmax in zip(colors, cmaxes):
                for s, d in color:
                    chans = routes[(t, s, d)]
                    k = len(chans)
                    si[s, col0:col0 + k] = tx_local[chans]
                    sm[s, col0:col0 + k] = True
                    ri[d, col0:col0 + k] = rx_local[chans]
                    rm[d, col0:col0 + k] = True
                    bf[0, d, col0:col0 + k] = s
                    br[0, s, col0:col0 + k] = d
                cls = _ExchangeClass(
                    perm=tuple(color), cmax=cmax, tier=t,
                    depth=self.E_tiers[t], col0=col0,
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
        self._bat_fwd, self._bat_rev = bat_f, bat_r

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
        """(1, B, S_t) batch-gather table -> (dev_shape..., S_t)."""
        return torch.as_tensor(
            np.ascontiguousarray(
                arr.reshape(self.real_shape + self.batch_shape + arr.shape[2:])
            ),
            device=self.device,
        )

    # ------------------------------------------------ batched tier exchange
    @staticmethod
    def _bat_move(x: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
        """The on-device slab move: ``out[b, s] = x[tbl[b, s], s]``.

        Every class of a tier moves between batch rows of one device, and
        the classes' column windows tile the tier's slot axis, so the whole
        tier is one gather.  Garbage rows from the 0-padded tables are
        killed by the send/recv masks downstream."""
        idx = tbl.long().reshape(tbl.shape + (1,) * (x.ndim - 2)).expand_as(x)
        return torch.gather(x, 0, idx)

    def _exchange_issue_batched(self, q: qmod.QueueArray, n_row: int,
                                credits: tuple, t: int, tb):
        """Tier t's exchange, ISSUE half, on queue rows flattened as
        ``b * n_row + k``: credit-bounded ``stage_drain`` of every egress
        row + the forward ``bat_fwd`` slab move.  Returns
        ``(q, (slab_in, cnt_in))``; touches egress rows and reads this
        tier's credits only."""
        sidx, smask = tb.send_idx[t], tb.send_mask[t]  # (B, S_t)
        B, S = sidx.shape
        base = torch.arange(B, dtype=sidx.dtype, device=sidx.device)[:, None] * n_row
        limit = torch.where(smask, credits[t], torch.zeros_like(credits[t]))
        q, slab, cnt = qmod.stage_drain(
            q, (base + sidx).reshape(-1), self.E_tiers[t], limit=limit.reshape(-1)
        )
        slab = slab.reshape((B, S) + slab.shape[1:])
        cnt = cnt.reshape(B, S)
        bfw = tb.bat_fwd[t]
        slab_in = self._bat_move(slab, bfw)
        cnt_in = torch.where(tb.recv_mask[t], self._bat_move(cnt, bfw),
                             torch.zeros_like(cnt))
        return q, (slab_in, cnt_in)

    def _exchange_commit_batched(self, q: qmod.QueueArray, n_row: int,
                                 credits: tuple, t: int, tb, pending):
        """COMMIT half: ``stage_fill`` of every ingress row + the
        ``bat_rev`` credit return.  Returns ``(q, credits)``; touches
        ingress rows and this tier's credits only."""
        slab_in, cnt_in = pending
        ridx, rmask = tb.recv_idx[t], tb.recv_mask[t]
        B, S = ridx.shape
        base = torch.arange(B, dtype=ridx.dtype, device=ridx.device)[:, None] * n_row
        q = qmod.stage_fill(
            q, (base + ridx).reshape(-1),
            slab_in.reshape((B * S,) + slab_in.shape[2:]), cnt_in.reshape(-1),
        )
        free = qmod.free(q).reshape(B, n_row)
        cred = torch.where(rmask, torch.gather(free, 1, ridx.long()),
                           torch.zeros_like(ridx))
        credits = (credits[:t] + (self._bat_move(cred, tb.bat_rev[t]),)
                   + credits[t + 1:])
        return q, credits

    # ------------------------------------------------------------ the loop
    def _local_view(self, state):
        raise NotImplementedError

    def _global_view(self, local):
        raise NotImplementedError

    def _epoch(self, local, stop=None):
        """One outermost epoch on the local view, a no-op where ``stop``
        (the until-loop's () bool tensor) is set.  The queue-interpreter
        cycle of this class (``granule_local_cycle``) is not ported yet;
        ``FusedEngine`` supplies the epoch."""
        raise NotImplementedError(
            "GraphEngine's own cycle (granule_local_cycle) is not ported yet "
            "(ROADMAP Queue 1 item 5); use FusedEngine"
        )

    def _owned(self, state, donate: bool):
        """The state a run may update: the device path updates tensors in
        place, so a caller who keeps its input (``donate=False``) gets a
        copy run instead."""
        if donate or self.device.type == "cpu":
            return state
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                        state)

    def run_epochs(self, state, n_epochs: int, *, donate: bool = True):
        """Advance ``n_epochs`` outermost epochs.

        ``donate=True`` (default) lets the CUDA path update the state's
        tensors in place: the *input* state must not be reused afterwards.
        Pass ``donate=False`` to keep the input alive."""
        local = self._local_view(self._owned(state, donate))
        for _ in range(n_epochs):
            local = self._epoch(local)
        return self._global_view(local)

    def run_cycles(self, state, n_cycles: int, *, donate: bool = True):
        """Advance ``ceil(n_cycles / cycles_per_epoch)`` outermost epochs
        (>= n_cycles local cycles)."""
        return self.run_epochs(state, -(-n_cycles // self.cycles_per_epoch),
                               donate=donate)

    def _done_view(self, local):
        """What ``run_until``'s predicate sees (the local state)."""
        return local

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
        every granule, or at most ``max_epochs`` MORE epochs from the input
        state (a relative budget).  The predicate is checked before every
        epoch, so an already-done state runs zero epochs.

        The loop runs on the device (``core.device_loop``): on a CUDA state
        spans of epochs replay from a CUDA graph, the predicate reduced and
        the stop decided on the card, and the host waits once a span.  The
        predicate must return a device tensor without reading it back.  The
        captured span is cached per (predicate, ``max_epochs``, ``donate``)
        and the state's tensors; the cache pins ``cache_key`` if given,
        else ``done_fn`` — pass ``cache_key`` when the predicate is a fresh
        lambda per call but semantically constant.

        ``donate=True`` (default) lets the CUDA path update the state's
        tensors in place: the input state must not be reused afterwards.
        ``donate=False`` runs on a clone at new addresses, so every such
        call captures its span anew, where a donated state that is run
        again replays the span it captured."""
        return device_loop.run_until(
            self._until_cache, self._owned(state, donate),
            enter=self._local_view, leave=self._global_view,
            epoch=lambda local, stop: self._epoch(local, stop=stop),
            done=lambda local: done_fn(self._done_view(local)),
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
            enter=self._local_view, leave=self._global_view,
            epoch=lambda local, stop: self._epoch(local, stop=stop),
            done=lambda local: done_fn(self._done_view(local)),
            max_epochs=max_epochs,
        )

    # ------------------------------------------------------- host utilities
    def gather_group(self, state, gi: int) -> Tree:
        """Group ``gi``'s member states in global instantiation order
        (numpy leaves)."""
        n_slot = self._n_slot[gi]
        idx = self._member_granule[gi] * n_slot + self._member_slot[gi]

        def pick(x):
            x = x.detach().cpu().numpy()
            return x.reshape((self.G * n_slot,) + x.shape[self.nd + 1:])[idx]

        return tree_map(pick, state.block_states[gi])

    def group_state(self, state, inst) -> Tree:
        """One instance's (unstacked) state — mirrors NetworkSim.group_state."""
        inst_id = inst if isinstance(inst, int) else inst.inst_id
        gi, k = self.graph.locate(inst_id)
        didx = np.unravel_index(int(self._member_granule[gi][k]), self.dev_shape)
        slot = int(self._member_slot[gi][k])
        return tree_map(lambda x: x[tuple(int(i) for i in didx) + (slot,)],
                        state.block_states[gi])

    # ---------------------- host-side external ports (PySbTx/PySbRx analogue)
    # External channels are *homed* on the granule that owns their simulated
    # endpoint: host I/O touches only that granule's queue row.
    def _ext_loc(self, cid: int) -> tuple[tuple[int, ...], int]:
        raise NotImplementedError

    def _ext_idx(self, table: dict, name: str) -> tuple:
        didx, row = self._ext_loc(table[name])
        return didx + (row,)

    def port_stats(self, state) -> dict:
        """Per external port: occupancy/credit of the queue row homed on
        the owning granule (the ``Simulation.stats()["ports"]`` schema)."""
        size = qmod.size(state.queues).cpu().numpy()

        def rec(cid):
            didx, row = self._ext_loc(cid)
            occ = int(size[didx + (row,)])
            return {"occupancy": occ, "credit": self.capacity - 1 - occ}

        return {
            "tx": {n: rec(c) for n, c in self.graph.ext_in.items()},
            "rx": {n: rec(c) for n, c in self.graph.ext_out.items()},
        }

    def _payload(self, payload) -> torch.Tensor:
        return torch.as_tensor(np.asarray(payload), dtype=self.dtype,
                               device=self.device)

    def host_push(self, state, name: str, payload):
        q2, ok = qmod.host_push(
            state.queues, self._ext_idx(self.graph.ext_in, name),
            self._payload(payload),
        )
        return state.replace(queues=q2), ok

    def host_pop(self, state, name: str):
        q2, front, valid = qmod.host_pop(
            state.queues, self._ext_idx(self.graph.ext_out, name)
        )
        return state.replace(queues=q2), front, valid

    def host_push_many(self, state, name: str, payloads):
        payloads = self._payload(payloads).reshape(-1, self.W)
        q2, n = qmod.host_push_many(
            state.queues, self._ext_idx(self.graph.ext_in, name), payloads
        )
        return state.replace(queues=q2), n

    def host_pop_many(self, state, name: str, max_n: int):
        q2, pays, cnt = qmod.host_pop_many(
            state.queues, self._ext_idx(self.graph.ext_out, name), max_n
        )
        return state.replace(queues=q2), pays, cnt
