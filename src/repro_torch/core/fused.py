"""Fused-epoch engine — the fast path for ANY channel graph, as in
``repro.core.fused``.

The engine lowers a partitioned ``ChannelGraph`` to a *fused* per-granule
epoch:

  * **intra-granule channels are depth-1 elastic registers** — a
    (value, valid) pair per channel — so the per-cycle state shrinks from
    ``(n_local, capacity, W)`` queues to ``(n_reg, W)`` registers;
  * **boundary + external channels stay real queues** (a small
    ``(n_q, capacity, W)`` array), so the batched tier exchange, slab
    depths and credit protocol are bit-identical to the JAX engines;
  * the granules of a shard are stacked on one batch axis and **folded
    into the channel/slot axes** (the flat layout): row r's registers live
    at ``r*n_reg + c``, its queue rows at ``B*n_reg + r*n_q + k`` in the
    combined id space, its block slots at ``r*n_slot + s``, so one cycle
    body steps every granule of the shard with plain gathers;
  * the tiers from ``_resident_from`` on, whose exchange classes all stay
    on a shard, run as ONE resident op program a shard
    (``kernels.granule_step``): their cycle blocks and the on-shard tier
    exchanges in between.  On a CUDA state that program is the
    hand-written Hopper kernel; on the CPU it is the plain PyTorch version
    built from :meth:`FusedEngine._cycle_body` and the exchange halves
    below.  The tiers above it exchange across shards between those
    programs (``distributed.GraphEngine``'s schedule, ``core.mesh``): with
    the pods real and the granules batched, the inner tier runs resident
    on each shard and the pod tier crosses shards; with every axis real,
    each shard's program is its cycle blocks and every exchange crosses.

Correctness contract (held against the JAX ``FusedEngine`` in
``tests/test_torch_fused.py`` and, for the ``grid`` preset and networks of
several groups and block types, ``tests/test_torch_fused_grid.py``): after
every epoch the state equals the JAX engine's leaf for leaf, for any
partition tree and per-tier rates, with ``overlap`` on or off; with
``capacity=2`` and K=(1,1) the engine tracks the single-netlist
``NetworkSim`` cycle by cycle.

The JAX package splits the flat state into per-row carries for XLA:CPU's
caches; that split changes nothing in the results and is not ported.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import queue as qmod
from ..kernels import granule_step
from ..obs import trace as _trace
from .distributed import GraphEngine
from .graph import ChannelGraph, _rank_within, grid_partition
from .struct import tensor_dataclass, tree_map

Tree = Any


@tensor_dataclass
class FusedTables:
    """Fused-engine lookup tables (constant over time), global layout.

    Port and inverse tables are FLAT (the batch folded into the slot and
    channel axes, ``real_shape`` leading dims; unbatched, the per-granule
    tables, which are the same); because channels are SPSC,
    every combined channel id has at most one local producer and one local
    consumer, so the per-cycle commit is three gathers (producer payload,
    producer valid, consumer ready) through the inverse maps.  Exchange
    tables keep the per-granule ``dev_shape`` layout.
    """

    rx_idx: tuple  # per group: (real..., B*n_slot, n_in) int32 combined ids
    tx_idx: tuple  # per group: (real..., B*n_slot, n_out) int32 combined ids
    active: tuple  # per group: (dev..., n_slot) bool
    send_idx: tuple  # per tier: (dev..., S_t) int32 queue rows
    send_mask: tuple  # per tier: (dev..., S_t) bool
    recv_idx: tuple  # per tier: (dev..., S_t) int32 queue rows
    recv_mask: tuple  # per tier: (dev..., S_t) bool
    inv_tx: torch.Tensor  # (real..., B*(n_reg + n_q)) int32 flat producer index
    inv_tx_mask: torch.Tensor  # (real..., B*(n_reg + n_q)) bool
    inv_rx: torch.Tensor  # (real..., B*(n_reg + n_q)) int32 flat consumer index
    inv_rx_mask: torch.Tensor  # (real..., B*(n_reg + n_q)) bool
    bat_fwd: tuple  # per tier: (dev..., S_t) int32 source batch row; () unbatched
    bat_rev: tuple  # per tier: (dev..., S_t) int32 credit-return batch row


@tensor_dataclass
class FusedState:
    """All leaves carry the leading ``dev_shape`` dims, as in the JAX
    package's batched global view.

    ``reg_val``/``reg_v`` are the depth-1 intra-granule channel registers
    (ids 0/1 are the NULL_RX / NULL_TX sentinels: ``reg_v`` stays False
    there, so 0 never reads valid and 1 always looks free).  ``queues``
    holds only boundary egress/ingress + external channels; row 0 of every
    granule is the scratch row exchange padding points at.
    """

    reg_val: torch.Tensor  # (dev..., n_reg, W)
    reg_v: torch.Tensor  # (dev..., n_reg) bool
    queues: qmod.QueueArray  # (dev..., n_q, capacity, W)
    block_states: tuple  # per group: leaves (dev..., n_slot, ...)
    credits: tuple  # per tier: (dev..., S_t) int32 send credits
    cycle: torch.Tensor  # (dev...,) int32
    epoch: torch.Tensor  # (dev...,) int32
    tables: FusedTables


class FusedEngine(GraphEngine):
    """Fused-epoch engine over an arbitrary partitioned graph.  Accepts
    everything ``GraphEngine`` accepts."""

    engine_kind = "fused"

    def __init__(self, graph, partition, mesh=None, K: int = 1, axes=None,
                 tiers=None, *, batch_axes=None, overlap: Any = "auto",
                 device="cuda"):
        super().__init__(
            graph, partition, mesh, K=K, axes=axes, tiers=tiers,
            batch_axes=batch_axes, overlap=overlap, device=device,
        )
        self._build_fused_tables()
        self._build_flat_tables()
        self._n_row = self.n_q
        # First tier from which EVERY exchange class stays on a shard
        # (batched classes with an empty real_perm; exchange-free tiers
        # trivially qualify): tiers [_resident_from:] run as ONE resident
        # program a shard.  Unbatched engines keep the fold region
        # (real_perm is None there, never ()).
        r = len(self.tiers)
        while r > 0 and all(cl.real_perm == () for cl in self.tier_classes[r - 1]):
            r -= 1
        self._resident_from = min(r, self._fold_from)
        self._program_cache: dict[int, tuple] = {}
        self._cons_cache: dict[tuple, tuple] = {}
        # what each launch of the CUDA program steps, for obs (host numbers)
        granule_step.record_program([g.block for g in graph.groups],
                                    [t.shape[1] for t in self._rx_flat])

    # ---------------------------------------------------- uniform-grid preset
    @classmethod
    def grid(cls, cell, R: int, C: int, mesh=None, K: int = 1,
             payload_words: int = 2, capacity: int = qmod.DEFAULT_CAPACITY,
             dtype: Any = torch.float32, axis_r: str = "gr", axis_c: str = "gc",
             *, params=None, batch_axes=None, **kw) -> "FusedEngine":
        """Uniform R×C grid preset over ``ChannelGraph.grid`` and
        ``grid_partition``, as the JAX ``FusedEngine.grid``.  The granule
        grid is ``Dr x Dc``, each the axis's size in ``batch_axes`` (a
        mapping) or ``mesh``, 1 where neither names it; ``params`` are the
        cells' stacked params (else pass ``group_params`` to ``init``)."""
        sizes = {**(mesh or {}),
                 **(batch_axes if isinstance(batch_axes, Mapping) else {})}
        Dr, Dc = int(sizes.get(axis_r, 1)), int(sizes.get(axis_c, 1))
        graph = ChannelGraph.grid(cell, R, C, params=params,
                                  payload_words=payload_words, dtype=dtype,
                                  capacity=capacity)
        return cls(graph, grid_partition(R, C, Dr, Dc), mesh, K=K,
                   axes=(axis_r, axis_c), batch_axes=batch_axes, **kw)

    # ------------------------------------------------- host-side lowering
    def _build_fused_tables(self) -> None:
        """Re-lower the granule-local queue id space onto registers + queues.

        Every (granule, local queue) entity becomes either a depth-1
        register (intra-granule channels) or a row of the small boundary
        queue array (egress/ingress/external).  Combined addressing keeps
        one id space for the port tables: ids ``[0, n_reg)`` are registers
        (0/1 the sentinels), ``[n_reg, n_reg + n_q)`` queues.
        """
        G = self.G
        g = self.graph
        ent_g, ent_c, ent_kind, lid = self._ent
        # external channels (host-facing) need real multi-packet queues
        ext = (g.chan_src[ent_c] < 0) | (g.chan_dst[ent_c] < 0)
        is_reg = (ent_kind == 0) & ~ext

        reg_rank, reg_counts = _rank_within(ent_g[is_reg], G)
        q_rank, q_counts = _rank_within(ent_g[~is_reg], G)
        self.n_reg = int(2 + (reg_counts.max() if reg_counts.size else 0))
        # queue row 0 is a scratch sentinel: exchange-table *padding* points
        # there, so masked slots never touch a real channel's row
        self.n_q = int(1 + (q_counts.max() if q_counts.size else 0))

        lid2comb = np.zeros((G, self.n_local), np.int64)
        lid2comb[:, 1] = 1
        lid2comb[ent_g[is_reg], lid[is_reg]] = 2 + reg_rank
        lid2comb[ent_g[~is_reg], lid[~is_reg]] = self.n_reg + 1 + q_rank
        self._lid2comb = lid2comb

        gi = np.arange(G)[:, None, None]
        self._rx_tables_f = [
            lid2comb[gi, rxm].astype(np.int32) for rxm in self._rx_tables
        ]
        self._tx_tables_f = [
            lid2comb[gi, txm].astype(np.int32) for txm in self._tx_tables
        ]

        # exchange tables move from local-queue-id space to queue-row space
        gq = np.arange(G)[:, None]

        def to_qrow(idx, mask):
            comb = lid2comb[gq, idx]
            if not (comb[mask] >= self.n_reg).all():
                raise AssertionError("boundary channel lowered to a register")
            return np.where(mask, comb - self.n_reg, 0).astype(np.int32)

        self._send_idx_f = [
            to_qrow(si, sm) for si, sm in zip(self._send_idx, self._send_mask)
        ]
        self._recv_idx_f = [
            to_qrow(ri, rm) for ri, rm in zip(self._recv_idx, self._recv_mask)
        ]

    def _build_flat_tables(self) -> None:
        """Flatten each shard's batch of B granules into ONE granule: row
        r's registers at ``r*n_reg + c``, its queue rows at
        ``B*n_reg + r*n_q + k``, its group slots at ``r*n_slot + s``.  Rows
        need not share table *values*: each row's window gets its own
        granule's table.  The inverse maps are built over the flat id
        space, with every row's sentinels masked (SPSC uniqueness holds per
        row, and rows map into disjoint flat windows).  Unbatched (B = 1)
        these are the per-granule tables."""
        G, B = self.G, self.B
        G_real = G // B
        n_reg, n_q = self.n_reg, self.n_q

        def fmap(t: np.ndarray) -> np.ndarray:
            # (G_real, B, ...) combined ids -> flat combined ids
            r = np.arange(B).reshape((1, B) + (1,) * (t.ndim - 2))
            return np.where(
                t < n_reg, r * n_reg + t, B * n_reg + r * n_q + (t - n_reg)
            )

        def flat_ports(tbls):
            out = []
            for tbl in tbls:
                _, n_slot, n_p = tbl.shape
                t = fmap(tbl.reshape(G_real, B, n_slot, n_p))
                out.append(t.reshape(G_real, B * n_slot, n_p).astype(np.int32))
            return out

        self._rx_flat = flat_ports(self._rx_tables_f)
        self._tx_flat = flat_ports(self._tx_tables_f)

        n_tot = B * (n_reg + n_q)
        rows = np.arange(G_real)[:, None]

        def inverse(tables):
            inv = np.zeros((G_real, n_tot), np.int64)
            mask = np.zeros((G_real, n_tot), bool)
            off = 0
            for tbl in tables:
                _, n_fs, n_p = tbl.shape
                flat = np.broadcast_to(off + np.arange(n_fs * n_p), (G_real, n_fs * n_p))
                inv[rows, tbl.reshape(G_real, -1)] = flat
                mask[rows, tbl.reshape(G_real, -1)] = True
                off += n_fs * n_p
            sent = (np.arange(B)[:, None] * n_reg + np.array([0, 1])).ravel()
            mask[:, sent] = False  # sentinels never drive/commit anything
            return inv.astype(np.int32), mask

        self._inv_tx_flat, self._inv_tx_mask_flat = inverse(self._tx_flat)
        self._inv_rx_flat, self._inv_rx_mask_flat = inverse(self._rx_flat)

    def _dev_flat(self, arr: np.ndarray) -> torch.Tensor:
        """(G_real, ...) flat table -> (real_shape..., ...) device tensor."""
        return torch.as_tensor(
            np.ascontiguousarray(arr.reshape(self.real_shape + arr.shape[1:])),
            device=self.device,
        )

    def tables(self) -> FusedTables:
        return FusedTables(
            rx_idx=tuple(self._dev_flat(t) for t in self._rx_flat),
            tx_idx=tuple(self._dev_flat(t) for t in self._tx_flat),
            inv_tx=self._dev_flat(self._inv_tx_flat),
            inv_tx_mask=self._dev_flat(self._inv_tx_mask_flat),
            inv_rx=self._dev_flat(self._inv_rx_flat),
            inv_rx_mask=self._dev_flat(self._inv_rx_mask_flat),
            active=tuple(self._dev(t) for t in self._act_tables),
            send_idx=tuple(self._dev(t) for t in self._send_idx_f),
            send_mask=tuple(self._dev(t) for t in self._send_mask),
            recv_idx=tuple(self._dev(t) for t in self._recv_idx_f),
            recv_mask=tuple(self._dev(t) for t in self._recv_mask),
            bat_fwd=tuple(self._dev_bat(t) for t in self._bat_fwd),
            bat_rev=tuple(self._dev_bat(t) for t in self._bat_rev),
        )

    # ------------------------------------------------------------------ init
    def init(self, key=0, group_params: dict | None = None, *,
             into: FusedState | None = None) -> FusedState:
        """Initial state.  ``key`` is an int seed or a ``torch.Generator``
        for block ``init_state`` (``ManycoreCell`` ignores it, so states
        match the JAX package's exactly); ``group_params[gi]`` overrides the
        IR's stacked per-member params of group ``gi``.  ``into`` lends its
        tables as in ``GraphEngine.init``.  Traced as the ``init.state``
        and ``init.tables`` spans (``obs.trace``)."""
        rec = _trace.recorder()
        into = into if isinstance(into, FusedState) else None
        with rec.session_span("init.state"):
            states = self._init_block_states(key, group_params)
            lead = self.dev_shape
            q = qmod.make_queues(self.n_q, self.W, self.capacity, self.dtype,
                                 self.device)
            queues = tree_map(lambda x: x.expand(lead + x.shape).contiguous(), q)
            cap1 = self.capacity - 1
            zi = lambda shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                           device=self.device)
            fields = dict(
                reg_val=torch.zeros(lead + (self.n_reg, self.W), dtype=self.dtype,
                                    device=self.device),
                reg_v=torch.zeros(lead + (self.n_reg,), dtype=torch.bool,
                                  device=self.device),
                queues=queues,
                block_states=tuple(states),
                credits=tuple(
                    torch.full(lead + (si.shape[1],), cap1, dtype=torch.int32,
                               device=self.device)
                    for si in self._send_idx
                ),
                cycle=zi(lead),
                epoch=zi(lead),
            )
        with rec.session_span("init.tables"):
            tables = self.tables() if into is None else into.tables
            return self.place(FusedState(**fields, tables=tables))

    # ------------------------------------------------ flat-batch local views
    def _local_view(self, state: FusedState) -> FusedState:
        """The flat layout: the batch axes fold into the register/queue/slot
        axes (views, no copies), matching the flat port tables.  Exchange
        state keeps the (B, S_t) layout.  A scratch-only queue array (no
        boundary channels anywhere) drops to its first row, so the queue
        machinery vanishes from the cycle.  Rows run in lockstep and share
        one cycle counter."""
        B, nd, nd_r = self.B, self.nd, self.nd_real

        fold = lambda x: x.reshape(  # noqa: E731 — batch into first data dim
            (B * x.shape[nd],) + x.shape[nd + 1:]
        )
        bat = lambda x: x.reshape((B,) + x.shape[nd:])  # noqa: E731
        strip = lambda x: x.reshape(x.shape[nd_r:])  # noqa: E731
        q_fold = fold if self.n_q > 1 else (lambda x: bat(x)[0])
        tb = state.tables
        tables = tb.replace(
            rx_idx=tree_map(strip, tb.rx_idx),
            tx_idx=tree_map(strip, tb.tx_idx),
            inv_tx=strip(tb.inv_tx),
            inv_tx_mask=strip(tb.inv_tx_mask),
            inv_rx=strip(tb.inv_rx),
            inv_rx_mask=strip(tb.inv_rx_mask),
            active=tree_map(fold, tb.active),
            send_idx=tree_map(bat, tb.send_idx),
            send_mask=tree_map(bat, tb.send_mask),
            recv_idx=tree_map(bat, tb.recv_idx),
            recv_mask=tree_map(bat, tb.recv_mask),
            bat_fwd=tree_map(bat, tb.bat_fwd),
            bat_rev=tree_map(bat, tb.bat_rev),
        )
        return state.replace(
            reg_val=fold(state.reg_val),
            reg_v=fold(state.reg_v),
            queues=tree_map(q_fold, state.queues),
            block_states=tree_map(fold, state.block_states),
            credits=tree_map(bat, state.credits),
            cycle=bat(state.cycle)[0],
            epoch=bat(state.epoch),
            tables=tables,
        )

    def _global_view(self, local: FusedState) -> FusedState:
        B, nd_r = self.B, self.nd_real
        lead = (1,) * nd_r + self.batch_shape

        unfold = lambda x: x.reshape(  # noqa: E731
            lead + (x.shape[0] // B,) + x.shape[1:]
        )
        unbat = lambda x: x.reshape(lead + x.shape[1:])  # noqa: E731
        readd = lambda x: x.reshape((1,) * nd_r + x.shape)  # noqa: E731
        q_unfold = (
            unfold if self.n_q > 1
            else (lambda x: x.expand(lead + x.shape).contiguous())
        )
        tb = local.tables
        tables = tb.replace(
            rx_idx=tree_map(readd, tb.rx_idx),
            tx_idx=tree_map(readd, tb.tx_idx),
            inv_tx=readd(tb.inv_tx),
            inv_tx_mask=readd(tb.inv_tx_mask),
            inv_rx=readd(tb.inv_rx),
            inv_rx_mask=readd(tb.inv_rx_mask),
            active=tree_map(unfold, tb.active),
            send_idx=tree_map(unbat, tb.send_idx),
            send_mask=tree_map(unbat, tb.send_mask),
            recv_idx=tree_map(unbat, tb.recv_idx),
            recv_mask=tree_map(unbat, tb.recv_mask),
            bat_fwd=tree_map(unbat, tb.bat_fwd),
            bat_rev=tree_map(unbat, tb.bat_rev),
        )
        return local.replace(
            reg_val=unfold(local.reg_val),
            reg_v=unfold(local.reg_v),
            queues=tree_map(q_unfold, local.queues),
            block_states=tree_map(unfold, local.block_states),
            credits=tree_map(unbat, local.credits),
            cycle=local.cycle.expand(lead).contiguous(),
            epoch=unbat(local.epoch),
            tables=tables,
        )

    # ----------------------------------------------------------- local cycle
    def _cycle_body(self, carry, tb):
        """One cycle of every granule on registers + boundary queues.

        Same pre-cycle snapshot semantics as ``NetworkSim.step`` — fronts,
        valids and readies are all taken before any block steps — with
        channel storage split between the register file and the small
        boundary queue array.  Pure in its arguments, generic over block
        types: the plain version of the kernel's cycle.
        """
        reg_val_in, reg_v_in, q, block_states, cycle = carry
        n_reg, W = reg_val_in.shape
        # A 1-row queue array is only the scratch sentinel: no boundary or
        # external channels, so the queue machinery is skipped entirely.
        have_q = q.buf.shape[0] > 1

        if have_q:
            qsize = (q.head - q.tail) % q.capacity
            qfronts, _ = qmod.peek(q)
            # combined channel views: registers first, queue rows after
            fronts = torch.cat([reg_val_in, qfronts], 0)
            valids = torch.cat([reg_v_in, qsize > 0], 0)
            readies = torch.cat([~reg_v_in, qsize < q.capacity - 1], 0)
        else:
            fronts, valids, readies = reg_val_in, reg_v_in, ~reg_v_in

        new_states = []
        pay_parts, val_parts, rr_parts = [], [], []
        for gi, grp in enumerate(self.graph.groups):
            blk = grp.block
            rxm, txm = tb.rx_idx[gi].long(), tb.tx_idx[gi].long()
            f_all = fronts[rxm]  # (n_slot, n_in, W) — one gather per group
            v_all = valids[rxm]
            r_all = readies[txm]
            rx = {
                port: (f_all[:, p], v_all[:, p])
                for p, port in enumerate(blk.in_ports)
            }
            tx_ready = {port: r_all[:, p] for p, port in enumerate(blk.out_ports)}
            bst = block_states[gi]
            new_st, rx_ready, tx = blk.step(bst, rx, tx_ready)

            if blk.clock_divider > 1:
                en = (cycle % blk.clock_divider) == 0
                new_st = tree_map(lambda a, b: torch.where(en, a, b), new_st, bst)
                rx_ready = {k: v & en for k, v in rx_ready.items()}
                tx = {k: (p, v & en) for k, (p, v) in tx.items()}
            new_states.append(new_st)

            if blk.in_ports:
                rr_parts.append(
                    torch.stack([rx_ready[p] for p in blk.in_ports], 1).reshape(-1)
                )
            if blk.out_ports:
                pay_parts.append(
                    torch.stack([tx[p][0] for p in blk.out_ports], 1)
                    .reshape(-1, W).to(self.dtype)
                )
                val_parts.append(
                    torch.stack([tx[p][1] for p in blk.out_ports], 1).reshape(-1)
                )

        dev = reg_val_in.device
        pay_all = (torch.cat(pay_parts, 0) if pay_parts
                   else torch.zeros((1, W), dtype=self.dtype, device=dev))
        val_all = (torch.cat(val_parts, 0) if val_parts
                   else torch.zeros((1,), dtype=torch.bool, device=dev))
        rr_all = (torch.cat(rr_parts, 0) if rr_parts
                  else torch.zeros((1,), dtype=torch.bool, device=dev))

        # SPSC: the inverse maps pick each channel's unique producer and
        # consumer — gathers only, no scatters anywhere in the cycle.
        inv_tx, inv_rx = tb.inv_tx.long(), tb.inv_rx.long()
        inv_tx_r, inv_rx_r = inv_tx[:n_reg], inv_rx[:n_reg]

        # registers: depth-1 elastic commit (push into empty, pop drains)
        do_push_r = val_all[inv_tx_r] & tb.inv_tx_mask[:n_reg] & ~reg_v_in
        do_pop_r = rr_all[inv_rx_r] & tb.inv_rx_mask[:n_reg] & reg_v_in
        reg_val = torch.where(do_push_r[:, None], pay_all[inv_tx_r], reg_val_in)
        reg_v = (reg_v_in & ~do_pop_r) | do_push_r

        if have_q:
            # boundary/external queues: the standard ring handshake
            q2, _, _ = qmod.cycle(
                q,
                pay_all[inv_tx[n_reg:]],
                val_all[inv_tx[n_reg:]] & tb.inv_tx_mask[n_reg:],
                rr_all[inv_rx[n_reg:]] & tb.inv_rx_mask[n_reg:],
            )
        else:
            q2 = q
        return (reg_val, reg_v, q2, tuple(new_states), cycle + 1)

    # -------------------------------------------- resident multi-epoch program
    def _resident_program(self, t0: int) -> tuple:
        """The ("C", n)/("X", t) op list realizing tiers [t0:] — the tier
        recursion flattened so the whole span runs as ONE program (adjacent
        cycle blocks merged, exchange-free tiers elided).  Under
        ``overlap`` every boundary's run of ("X", t) ops becomes
        all-issues-then-all-commits (``granule_step.overlap_program``)."""
        if t0 not in self._program_cache:

            def prog(t):
                if t >= self._fold_from:
                    return [("C", int(np.prod(self.K_tiers[t:])))]
                if t == len(self.tiers) - 1:
                    ops = [("C", self.tiers[t].K)]
                else:
                    ops = prog(t + 1) * self.tiers[t].K
                if self.tier_classes[t]:
                    ops = ops + [("X", t)]
                return ops

            merged: list[tuple] = []
            for op, arg in prog(t0):
                if op == "C" and merged and merged[-1][0] == "C":
                    merged[-1] = ("C", merged[-1][1] + arg)
                else:
                    merged.append((op, arg))
            program = tuple(merged)
            if self.overlap:
                program = granule_step.overlap_program(program)
            self._program_cache[t0] = program
        return self._program_cache[t0]

    def _cons_table(self, dev: torch.device, shard: int = 0) -> tuple | None:
        """The CUDA program's consumer tables of a shard, one a group
        (``granule_step.consumer_table``), derived once per device and
        shard; None on the CPU, where the kernel does not run."""
        if dev.type != "cuda":
            return None
        key = (dev, shard)
        if key not in self._cons_cache:
            r = slice(shard, shard + 1)
            self._cons_cache[key] = tuple(
                torch.as_tensor(t, device=dev) for t in granule_step.consumer_table(
                    [t[r] for t in self._tx_flat], self._inv_tx_flat[r],
                    self._inv_tx_mask_flat[r], self._inv_rx_flat[r],
                    self._inv_rx_mask_flat[r], self.B * self.n_reg,
                ))
        return self._cons_cache[key]

    def _consts(self, tb: FusedTables, shard: int = 0) -> granule_step.ProgramConsts:
        """The read-only tables of shard ``shard``'s resident program (its
        local view).  Unbatched, the batch-row gathers are the identity
        (row 0 of one)."""
        bfw, brv = tb.bat_fwd, tb.bat_rev
        if not bfw:
            bfw = brv = tuple(torch.zeros_like(x) for x in tb.send_idx)
        return granule_step.ProgramConsts(
            rx_idx=tb.rx_idx, tx_idx=tb.tx_idx,
            inv_tx=tb.inv_tx, inv_tx_mask=tb.inv_tx_mask,
            inv_rx=tb.inv_rx, inv_rx_mask=tb.inv_rx_mask,
            send_idx=tb.send_idx, send_mask=tb.send_mask,
            recv_idx=tb.recv_idx, recv_mask=tb.recv_mask,
            bat_fwd=bfw, bat_rev=brv,
            cons=self._cons_table(tb.inv_tx.device, shard),
            blocks=tuple(g.block for g in self.graph.groups),
            depths=self.E_tiers, n_q=self.n_q,
        )

    def _resident_cycle(self, carry, consts):
        """Cycle body on the resident carry (the 5-leaf cycle carry plus
        the per-tier credit tuple, which only exchanges touch)."""
        return self._cycle_body(carry[:5], consts) + (carry[5],)

    def _resident_exchange_issue(self, carry, t: int, consts):
        """ISSUE half of tier t's exchange inside the resident program
        (every class stays on the shard): credit-bounded ``stage_drain`` of
        the flat queue rows into the (B, S_t, E_t, W) slab + the
        ``bat_fwd`` batch-row gather."""
        reg_val, reg_v, q, block_states, cycle, credits = carry
        q, slab, cnt = self._drain_tier(q, self.n_q, credits, t, consts)
        return ((reg_val, reg_v, q, block_states, cycle, credits),
                (slab, self._arrived(cnt, consts, t)))

    def _resident_exchange_commit(self, carry, t: int, pending, consts):
        """COMMIT half: ``stage_fill`` the in-flight slab + the ``bat_rev``
        credit return."""
        reg_val, reg_v, q, block_states, cycle, credits = carry
        q, cred = self._fill_tier(q, self.n_q, t, consts, pending)
        return (reg_val, reg_v, q, block_states, cycle,
                self._new_credits(credits, t, cred))

    def _resident_exchange(self, carry, t: int, consts):
        """Tier t's serial exchange — commit∘issue, so the serial and
        overlapped schedules share every operation and differ only in
        order."""
        carry, pending = self._resident_exchange_issue(carry, t, consts)
        return self._resident_exchange_commit(carry, t, pending, consts)

    def _run_program(self, local: FusedState, ops, shard: int, stop=None,
                     program=None) -> FusedState:
        """Shard ``shard``'s op program ``ops`` on its local view.
        ``program`` (``granule_step.epoch_program`` unless a caller holds a
        version against another) runs it; on a CUDA state the kernel
        updates the carry's tensors in place.  Where ``stop`` is set it
        leaves the state as it was."""
        program = granule_step.epoch_program if program is None else program
        carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
                 local.cycle, local.credits)
        out = program(
            self._resident_cycle, carry, ops,
            exchange_fn=self._resident_exchange,
            issue_fn=self._resident_exchange_issue,
            commit_fn=self._resident_exchange_commit,
            consts=self._consts(local.tables, shard), stop=stop,
        )
        return local.replace(
            reg_val=out[0], reg_v=out[1], queues=out[2], block_states=out[3],
            cycle=out[4], credits=out[5],
        )

    # The schedule of ``GraphEngine`` on every shard's local view (the flat
    # layout needs no folding): tiers from ``_resident_from`` on run as each
    # shard's resident program, the tiers above exchange across shards.
    def _fold(self, local: FusedState) -> FusedState:
        return local

    @staticmethod
    def _unfold(work: FusedState, local: FusedState) -> FusedState:
        return work

    def _inner_cycles(self, sts: tuple, K: int, stop=None, program=None) -> tuple:
        return tuple(self._run_program(st, (("C", K),), r, stop, program)
                     for r, st in enumerate(sts))

    def _tier_round(self, sts: tuple, t: int, stop=None, program=None) -> tuple:
        """Tiers [t:] as each shard's resident program where every class
        of them stays on a shard; the inherited round above that."""
        if t >= self._resident_from:
            return tuple(self._run_program(st, self._resident_program(t), r, stop,
                                           program)
                         for r, st in enumerate(sts))
        return super()._tier_round(sts, t, stop, program)

    def _pend_tiers(self, t0: int) -> tuple:
        """A resident program commits its own split exchanges, so it adds
        nothing to the caller's pending chain."""
        return () if t0 >= self._resident_from else super()._pend_tiers(t0)

    def _round_split(self, sts: tuple, t: int, stop=None, program=None):
        if t >= self._resident_from:
            return self._tier_round(sts, t, stop, program), ()
        return super()._round_split(sts, t, stop, program)

    def _epoch(self, local: FusedState, program=None, stop=None) -> FusedState:
        """One outermost epoch of an unsharded engine's local view: the
        resident program of every tier, then the epoch counter.  Where
        ``stop`` (the until-loop's () bool tensor) is set, the program and
        the counter leave the state as it was; a gated epoch bumps no
        registry counter (``until.epochs`` counts the loop's)."""
        return self._epoch_all((local,), stop, program)[0]

    # ------------------------------------------------- host-side external I/O
    def _ext_loc(self, cid: int) -> tuple[tuple[int, ...], int]:
        gid = int(self._chan_owner[cid])
        didx = tuple(int(i) for i in np.unravel_index(gid, self.dev_shape))
        lid = int(max(self._rx_local[cid], self._tx_local[cid]))
        return didx, int(self._lid2comb[gid, lid]) - self.n_reg
