"""Per-granule worker process — a free-running prebuilt granule simulator
(paper §III-F / §IV-B), as in ``repro.runtime.worker``.

Each worker owns ONE granule of a partitioned ``ChannelGraph`` (or, with
``batch_signatures``, a batch of same-signature granules): the
granule-local queues and block states, stepped by exactly the same
``granule_local_cycle`` body the in-process engines use.  The worker
free-runs epochs — ``K_inner`` local cycles, then per-tier exchanges over
shared-memory rings — gated only by its own ingress/egress credits.
There is no global barrier anywhere: a worker waits only when one of ITS
channels' rings is empty (producer behind) or full (consumer behind), so
two granules drift apart by up to their connecting channel's tier period,
and unconnected granules drift arbitrarily.

**Where a worker runs.**  Worker ``i`` runs on ``cuda:(i % device_count)``
— on one card, every worker shares it — unless the launcher was given
``device="cpu"``; then on the CPU with one intra-op thread, the
counterpart of the reference's single-CPU-device worker.  Only numpy
crosses a process boundary (the pickled ``GranuleSpec``, the command
pipe, the rings); a worker moves its granule to its device itself.

**The prebuilt simulator.**  The reference AOT-compiles its steppers
(``jit(...).lower().compile()``).  Here the state lives in tensors at
fixed addresses for the worker's life — ``init`` and ``scatter`` copy
into them — and each ``("C", n)`` length of the epoch program is
captured once into a CUDA graph at the worker's ``prebuild``
(``granule_local_cycle(..., inplace=True)`` ``n`` times, the new block
leaves copied back into the state's own) and replayed every epoch.  A
capture cannot cross processes, so each worker captures its own and
reports ``capture_s``.  On the CPU the same body runs eagerly.  The
exchange halves, host-port ingest/flush and the epoch tick run eagerly;
an exchange copies its slab and counts to the host once, then pushes
them to the rings.

Exchange protocol per boundary channel (bit-identical to the engines'
credit protocol): at the channel's tier cadence the sender pops one
credit record (pre-seeded with capacity-1 at reset), drains its egress
queue bounded by ``min(E_t, credit)``, and pushes one slab record; the
receiver pops one slab record per exchange, fills its ingress queue,
and pushes back its post-fill free space as the next credit.  One slab
record per exchange per channel — even when empty — is what makes the
free-running schedule deterministic and the traffic bit-identical to the
lockstep engines.

**Telemetry.**  Each worker produces into its own telemetry ring
(``obs.telemetry``, ``{prefix}t{w}``); with tracing on (the
``telemetry`` command) ``one_epoch`` runs as ``_traced_epoch``, which
makes the same ring operations in the same order and emits one 48-byte
record a phase, dropped and counted when the ring is full.  On the card
each traced phase ends with a synchronize of the worker's device, so a
``step`` record times the cycle graphs' work and not their launch;
untraced, the epoch adds no synchronize.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import os
import signal
import sys
import time
import traceback
from typing import Any

import numpy as np
import torch

from ..core import queue as qmod
from ..core.device import group_generator, to_tensor
from ..core.distributed import GraphTables, granule_local_cycle
from ..core.struct import tensor_dataclass, tree_leaves, tree_map
from ..kernels.granule_step import overlap_program
from ..obs import telemetry as _telem
from .fault_tolerance import (
    OP_CREDIT_POP, OP_CREDIT_PUSH, OP_SLAB_POP, OP_SLAB_PUSH, encode_blocked,
)
from .shmem import (
    RingCorruptionError, RingTimeout, ShmRing, attach_shared_memory,
    slab_slot_bytes,
)

Tree = Any


# ---------------------------------------------------------------- spec
@dataclasses.dataclass
class GroupSpec:
    """One block group's granule-local slice (all numpy, picklable)."""

    block: Any  # the Block instance (pickled by reference to its module)
    n_members: int  # GLOBAL member count (the per-member init's shape)
    n_slot: int
    member_of: np.ndarray  # (n_slot,) global member index (0 on padding)
    active: np.ndarray  # (n_slot,) bool
    rx_idx: np.ndarray  # (n_slot, n_in) local queue ids
    tx_idx: np.ndarray  # (n_slot, n_out)
    params_local: Tree | None  # pre-sliced per-slot params (n_slot leading)


@dataclasses.dataclass
class TierSpec:
    """One tier's boundary channels as seen by this granule."""

    K: int
    E: int  # slab depth = min(period, capacity-1)
    egress_chans: tuple[int, ...]  # channel ids, canonical order
    egress_lqids: np.ndarray  # (n_e,) local queue ids
    ingress_chans: tuple[int, ...]
    ingress_lqids: np.ndarray


@dataclasses.dataclass
class GranuleSpec:
    """Everything a worker needs to build and free-run its granule."""

    granule: int
    signature: str
    payload_words: int
    capacity: int
    dtype: str  # numpy dtype string of the payload
    n_local: int
    groups: list[GroupSpec]
    tiers: list[TierSpec]  # outermost first
    ext_ports: list[tuple[str, int, int, bool]]  # (name, chan, lqid, is_in)
    ring_prefix: str
    ring_depth: int
    timeout: float
    overlap: bool = False  # split issue/commit exchange (send-early/receive-late)

    @property
    def cycles_per_epoch(self) -> int:
        out = 1
        for t in self.tiers:
            out *= t.K
        return out


@dataclasses.dataclass
class BatchSpec:
    """``nb`` same-signature granules stepped as ONE leading-axis batch
    (``ProcsEngine(batch_signatures=True)``).

    All member specs share ``PartitionLowering.granule_signature`` — same
    block shapes, per-tier egress/ingress channel *counts* and ext-port
    count — so their epoch programs are identical and their per-granule
    tables stack into (nb, ...) arrays stepped by one call.  The rings
    stay per channel; only the dispatch is batched.
    """

    members: tuple[int, ...]
    specs: list[GranuleSpec]

    @property
    def signature(self) -> str:
        return self.specs[0].signature


def data_ring_name(prefix: str, chan: int) -> str:
    return f"{prefix}d{chan}"


def credit_ring_name(prefix: str, chan: int) -> str:
    return f"{prefix}c{chan}"


def ext_ring_name(prefix: str, chan: int) -> str:
    return f"{prefix}x{chan}"


def heartbeat_name(prefix: str) -> str:
    return f"{prefix}hb"


def bulk_name(prefix: str, worker: int) -> str:
    return f"{prefix}b{worker}"


def spec_name(prefix: str, worker: int) -> str:
    return f"{prefix}s{worker}"


# ------------------------------------------------------------ bulk records
# A command's or reply's large arrays (a state view, a gather, a scatter)
# travel in a shared-memory segment beside the command pipe, one per
# worker, and the pipe carries only the tree with each array replaced by
# its ``BulkSlot``: on the card's machine a pipe moves ~10 MB/s, shared
# memory GB/s (``scripts/torch_host_transport.py``), and a worker copies
# device leaves straight into the segment.
_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class BulkSlot:
    """Where one array of a bulk record lies in its segment."""

    offset: int
    shape: tuple
    dtype: str  # numpy dtype string


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((0,), dtype=dt).numpy().dtype


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _nbytes(x) -> int:
    item = x.element_size() if isinstance(x, torch.Tensor) else x.itemsize
    return int(np.prod(x.shape, dtype=np.int64)) * item


def bulk_size(tree) -> int:
    """Bytes a bulk record of ``tree`` (tensor or numpy leaves) takes."""
    return sum(_aligned(_nbytes(x)) for x in tree_leaves(tree))


def write_bulk(buf, tree) -> Tree:
    """Copy every leaf of ``tree`` (tensors on any device, or numpy) into
    ``buf`` back to back; returns the tree of their ``BulkSlot``s."""
    off = 0

    def put(x):
        nonlocal off
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        n = _nbytes(t)
        dst = np.frombuffer(buf, np.uint8, count=n, offset=off)
        torch.from_numpy(dst).view(t.dtype).reshape(t.shape).copy_(t)
        slot = BulkSlot(off, tuple(t.shape), numpy_dtype(t.dtype).str)
        off += _aligned(n)
        return slot

    return tree_map(put, tree)


def read_bulk(buf, slots, copy: bool) -> Tree:
    """The numpy tree a bulk record holds: views of ``buf`` (valid until
    the segment is written again), or copies."""
    def get(s: BulkSlot):
        a = np.frombuffer(buf, np.dtype(s.dtype), count=int(np.prod(s.shape, dtype=np.int64)),
                          offset=s.offset).reshape(s.shape)
        return a.copy() if copy else a

    return tree_map(get, slots)


@tensor_dataclass
class WorkerState:
    """One granule's state (no leading device dims; a signature batch
    carries one leading (nb,) axis) — the squeezed analogue of
    ``GraphState``, stepped by the shared ``granule_local_cycle``.
    Credits do NOT ride in it: they live in the shm credit rings between
    exchanges."""

    queues: qmod.QueueArray  # (n_local, capacity, W)
    block_states: tuple  # per group: leaves (n_slot, ...)
    cycle: Any  # () int32
    epoch: Any  # () int32
    tables: Any  # GraphTables (granule-local)


@tensor_dataclass
class _Work:
    """The rows of a signature batch folded for ``granule_local_cycle``:
    queue rows ``r * n_local + id``, block slots ``r * n_slot + s``, the
    port tables holding those flat row ids (views of the state, no
    copies)."""

    queues: qmod.QueueArray
    block_states: tuple
    cycle: Any
    tables: Any


class _Group:
    """``granule_local_cycle`` reads ``.block`` of each group."""

    def __init__(self, block):
        self.block = block


def spec_tables(spec: GranuleSpec) -> GraphTables:
    """One granule's local tables as a ``GraphTables`` of numpy arrays (the
    reference's layout, so a gathered state matches its leaf for leaf)."""
    return GraphTables(
        rx_idx=tuple(g.rx_idx for g in spec.groups),
        tx_idx=tuple(g.tx_idx for g in spec.groups),
        active=tuple(g.active for g in spec.groups),
        send_idx=tuple(t.egress_lqids for t in spec.tiers),
        send_mask=tuple(np.ones((len(t.egress_chans),), bool) for t in spec.tiers),
        recv_idx=tuple(t.ingress_lqids for t in spec.tiers),
        recv_mask=tuple(np.ones((len(t.ingress_chans),), bool) for t in spec.tiers),
    )


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros((0,), np.dtype(np_dtype))).dtype


def _full_params(params, member_of: np.ndarray, n_members: int):
    """Per-slot params spread to all ``n_members`` members: each held
    member's row is its own (a padding slot holds member 0's, as the
    lowering slices it), the others a copy of slot 0's.  Each member's
    initial state then comes out of the block's ``init_state`` over every
    member, as ``GraphEngine._init_block_states`` makes it."""
    src = np.zeros((n_members,), np.int64)
    src[np.asarray(member_of)] = np.arange(len(member_of))
    return tree_map(lambda x: np.asarray(x)[src], params)


def _copy_back(dsts: list, srcs: list) -> None:
    """Write every new leaf ``srcs[i]`` into the state's own ``dsts[i]``;
    a leaf handed back untouched (the same tensor) is skipped, and a new
    leaf that is another state leaf is copied first, so no write reads a
    leaf an earlier write changed."""
    own = {d.data_ptr() for d in dsts if d.numel()}
    pairs = []
    for d, s in zip(dsts, srcs):
        if s.data_ptr() == d.data_ptr():
            continue
        pairs.append((d, s.clone() if s.numel() and s.data_ptr() in own else s))
    for d, s in pairs:
        d.copy_(s)


# ------------------------------------------------------------- granule sim
class GranuleSim:
    """Pure compute half of a worker: the granule state, at fixed
    addresses on ``device``, and its steppers.

    Built by workers AND by the launcher's prebuild pass (one instance a
    distinct signature, on the CPU, each stepper stepped once on a
    template), so a shape fault fails before any worker spawns.  A
    ``BatchSpec`` (the reference's ``BatchedGranuleSim``) is stepped as
    ``nb`` rows: every state leaf carries a leading (nb,) axis, which
    ``granule_local_cycle`` folds into its queue rows and block slots, so
    one stepper call advances all nb granules, and host-port ops address
    one row at a time.  A ``GranuleSpec`` is one row whose public trees
    carry no leading axis.
    """

    def __init__(self, spec, device="cpu"):
        self.batched = isinstance(spec, BatchSpec)
        self.specs = list(spec.specs) if self.batched else [spec]
        self.spec = self.specs[0]  # shared scalars (capacity/W/rings/...)
        self.nb = len(self.specs)
        self.device = torch.device(device)
        self.np_dtype = np.dtype(self.spec.dtype)
        self.dtype = torch_dtype(self.np_dtype)
        self.W = self.spec.payload_words
        self.capacity = self.spec.capacity
        self.n_local = self.spec.n_local
        self.K_tiers = tuple(t.K for t in self.spec.tiers)
        programs = [self._build_program(s) for s in self.specs]
        if any(p != programs[0] for p in programs):
            raise ValueError("signature batch members disagree on epoch program")
        self.program = programs[0]
        self._groups = [_Group(g.block) for g in self.spec.groups]
        self.state: WorkerState | None = None  # (nb, ...) leaves, fixed addresses
        self._graphs: dict[int, Any] = {}  # cycles -> captured CUDA graph
        self.capture_s = 0.0
        dev = self.device
        base = torch.arange(self.nb, device=dev) * self.n_local

        def rows(per_row) -> torch.Tensor:  # local ids per row -> flat rows
            t = torch.as_tensor(np.stack(per_row).astype(np.int64), device=dev)
            return (t + base.reshape((-1,) + (1,) * (t.ndim - 1))).reshape(
                (-1,) + t.shape[2:])

        self._flat_tables = GraphTables(
            rx_idx=tuple(rows([s.groups[gi].rx_idx for s in self.specs])
                         for gi in range(len(self._groups))),
            tx_idx=tuple(rows([s.groups[gi].tx_idx for s in self.specs])
                         for gi in range(len(self._groups))),
            active=(), send_idx=(), send_mask=(), recv_idx=(), recv_mask=(),
        )
        self._send_rows = [rows([s.tiers[t].egress_lqids for s in self.specs])
                           for t in range(len(self.K_tiers))]
        self._recv_rows = [rows([s.tiers[t].ingress_lqids for s in self.specs])
                           for t in range(len(self.K_tiers))]

    # ---------------------------------------------------------- the program
    @staticmethod
    def _build_program(spec: GranuleSpec) -> list[tuple[str, int]]:
        """Flatten the nested tier rounds into ("C", n_cycles) / ("X", tier)
        ops — the same schedule as ``GraphEngine._tier_round``, with
        trailing tiers that have no channels ON THIS GRANULE folded into
        one contiguous cycle block (pure local compute chunks bigger).

        With ``spec.overlap`` the serial exchanges are rewritten to split
        ("XI", t) / ("XC", t) phases by ``granule_step.overlap_program`` —
        at a multi-tier boundary all issues precede all commits, so every
        outgoing slab is pushed before the worker blocks on any incoming
        one (send-early/receive-late)."""
        tiers = spec.tiers
        fold_from = len(tiers)
        while fold_from > 0 and not (
            tiers[fold_from - 1].egress_chans or tiers[fold_from - 1].ingress_chans
        ):
            fold_from -= 1

        def tier_round(t: int) -> list[tuple[str, int]]:
            if t >= fold_from:
                n = 1
                for tt in tiers[t:]:
                    n *= tt.K
                return [("C", n)] if n else []
            ops: list[tuple[str, int]] = []
            if t == len(tiers) - 1:
                ops.append(("C", tiers[t].K))
            else:
                for _ in range(tiers[t].K):
                    ops.extend(tier_round(t + 1))
            ops.append(("X", t))
            return ops

        program = tier_round(0)
        if spec.overlap:
            program = list(overlap_program(program))
        return program

    # ---------------------------------------------------------------- state
    def _init_row(self, spec: GranuleSpec, key, group_params) -> WorkerState:
        """One granule's initial state on the device — per member, the
        derivation of ``GraphEngine._init_block_states`` (``init_state``
        over the group's GLOBAL members, then this granule's slots), so
        its blocks equal the in-process engines'.  ``key`` is an int seed
        or the state of a ``torch.Generator`` (uint8 numpy)."""
        dev = self.device
        if isinstance(key, np.ndarray):
            gen = torch.Generator()
            gen.set_state(torch.from_numpy(key.copy()))
            key = gen
        states = []
        for gi, gs in enumerate(spec.groups):
            params = gs.params_local
            if group_params is not None and group_params[gi] is not None:
                params = group_params[gi]
            if params is not None:
                params = tree_map(lambda x: to_tensor(x, dev),
                                  _full_params(params, gs.member_of, gs.n_members))
            st = gs.block.init_state(gs.n_members, params,
                                     generator=group_generator(key, gi), device=dev)
            mo = torch.as_tensor(np.asarray(gs.member_of, np.int64), device=dev)
            states.append(tree_map(lambda x: x[mo], st))
        return WorkerState(
            queues=qmod.make_queues(self.n_local, self.W, self.capacity,
                                    self.dtype, dev),
            block_states=tuple(states),
            cycle=torch.zeros((), dtype=torch.int32, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            tables=tree_map(lambda x: torch.as_tensor(x, device=dev),
                            spec_tables(spec)),
        )

    def init(self, key, group_params=None) -> None:
        """Reset the state in place: ``group_params`` is None or, per row,
        per group, an override of the per-slot params (numpy)."""
        rows = [self._init_row(s, key, group_params[r] if group_params else None)
                for r, s in enumerate(self.specs)]
        self._install(tree_map(lambda *xs: torch.stack(xs), *rows))

    def _install(self, tree: WorkerState) -> None:
        """Copy ``tree`` ((nb, ...) leaves) into the state's tensors; the
        first call allocates them, each leaf its own memory (no two
        leaves alias, so the in-place steppers never write one through
        another)."""
        if self.state is None:
            self.state = tree_map(lambda x: torch.empty_like(
                x, device=self.device, memory_format=torch.contiguous_format), tree)
            self._work = _Work(
                queues=tree_map(self._fold, self.state.queues),
                block_states=tree_map(self._fold, self.state.block_states),
                cycle=self.state.cycle, tables=self._flat_tables)
        for dst, src in zip(tree_leaves(self.state), tree_leaves(tree)):
            dst.copy_(torch.as_tensor(src).reshape(dst.shape))

    @staticmethod
    def _fold(x: torch.Tensor) -> torch.Tensor:
        return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

    def load(self, tree: WorkerState) -> None:
        """Install a gathered state (numpy leaves; no leading axis unless
        batched)."""
        lead = (lambda x: x) if self.batched else (lambda x: x[None])
        self._install(tree_map(lambda x: torch.from_numpy(lead(np.asarray(x))), tree))

    def gather(self, tables: bool = True) -> WorkerState:
        """The state's leaves (views on the device; no leading axis unless
        batched), without ``tables`` when asked: the predicate view, whose
        tables the launcher holds."""
        st = self.state if tables else self.state.replace(tables=None)
        return st if self.batched else tree_map(lambda x: x[0], st)

    # -------------------------------------------------------------- steppers
    def _run_cycles(self, n: int) -> None:
        """``n`` cycles of every row, in place."""
        w0 = w = self._work
        for _ in range(n):
            w = granule_local_cycle(self._groups, self.n_local, self.W,
                                    self.dtype, w, inplace=True)
        _copy_back(tree_leaves((w0.block_states, w0.cycle)),
                   tree_leaves((w.block_states, w.cycle)))

    def cycles(self, n: int) -> None:
        """The ("C", n) op: a replay of its captured graph on the card, the
        same cycles eagerly on the CPU."""
        graph = self._graphs.get(n)
        if graph is not None:
            graph.replay()
        else:
            self._run_cycles(n)

    def _capture(self, n: int) -> None:
        """Capture ``n`` cycles into a CUDA graph on the current state's
        addresses (a warm-up first, eager on a side stream)."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_cycles(n)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()  # a graph freed mid-capture would break the capture
        try:
            with torch.cuda.graph(graph):
                self._run_cycles(n)
        finally:
            if collecting:
                gc.enable()
        self._graphs[n] = graph

    def drain(self, t: int, credits: np.ndarray):
        """Tier t's issue: credit-bounded drain of every row's egress
        queues.  ``credits`` (nb, n_e) -> numpy (slab (nb, n_e, E, W),
        count (nb, n_e))."""
        E = self.spec.tiers[t].E
        q = self._work.queues
        lim = torch.as_tensor(credits.reshape(-1), device=self.device)
        _, slab, cnt = qmod.stage_drain_(q, self._send_rows[t], E, limit=lim)
        shape = credits.shape
        return (slab.reshape(shape + (E, self.W)).cpu().numpy(),
                cnt.reshape(shape).cpu().numpy())

    def fill(self, t: int, slab: np.ndarray, cnt: np.ndarray) -> np.ndarray:
        """Tier t's commit: land the arrived slabs in every row's ingress
        queues; returns each queue's post-fill free space (nb, n_in), the
        next credits."""
        E = self.spec.tiers[t].E
        q = self._work.queues
        idx = self._recv_rows[t]
        dev = self.device
        qmod.stage_fill_(q, idx, torch.from_numpy(slab.reshape(-1, E, self.W)).to(dev),
                         torch.from_numpy(cnt.reshape(-1)).to(dev))
        free = (self.capacity - 1) - (q.head[idx] - q.tail[idx]) % self.capacity
        return free.reshape(cnt.shape).cpu().numpy()

    def ingest(self, row: int, lqid: int, payloads: np.ndarray) -> int:
        """Push host packets into one external-in queue; returns how many
        landed."""
        q = self._work.queues
        r = row * self.n_local + lqid
        buf, head, n = qmod.fill_single(
            q.buf[r], q.head[r], q.tail[r], self.capacity,
            torch.from_numpy(payloads).to(self.device))
        q.buf[r].copy_(buf)
        q.head[r].copy_(head)
        return int(n)

    def flush(self, row: int, lqid: int, room: int) -> np.ndarray:
        """Pop up to ``room`` packets from one external-out queue."""
        q = self._work.queues
        r = row * self.n_local + lqid
        pays, tail, cnt = qmod.drain_single(q.buf[r], q.head[r], q.tail[r],
                                            self.capacity, self.capacity - 1,
                                            limit=room)
        q.tail[r].copy_(tail)
        return pays[: int(cnt)].cpu().numpy()

    def tick(self) -> None:
        self.state.epoch.add_(1)

    def prebuild(self, step: bool = False) -> dict:
        """Allocate the state on a template (seed 0) and, on the card,
        capture each ("C", n) length of the program; with ``step`` (the
        launcher's CPU pass) run every stepper once on the template.
        Returns {"seconds", "n_functions", "capture_s"}."""
        t0 = time.perf_counter()
        self.init(0)
        lengths = sorted({n for op, n in self.program if op == "C"})
        n_fns = len(lengths) + 1
        if self.device.type == "cuda":
            t1 = time.perf_counter()
            for n in lengths:
                self._capture(n)
            torch.cuda.synchronize(self.device)
            self.capture_s = time.perf_counter() - t1
        elif step and lengths:
            self._run_cycles(1)  # every length runs this one body
        if step:
            for t, ts in enumerate(self.spec.tiers):
                if ts.egress_chans:
                    self.drain(t, np.zeros((self.nb, len(ts.egress_chans)), np.int32))
                    n_fns += 1
                if ts.ingress_chans:
                    n_in = len(ts.ingress_chans)
                    self.fill(t, np.zeros((self.nb, n_in, ts.E, self.W), self.np_dtype),
                              np.zeros((self.nb, n_in), np.int32))
                    n_fns += 1
            if any(s.ext_ports for s in self.specs):
                for r, s in enumerate(self.specs):
                    for _name, _chan, lqid, is_in in s.ext_ports:
                        if is_in:
                            self.ingest(r, lqid, np.zeros((0, self.W), self.np_dtype))
                        else:
                            self.flush(r, lqid, 0)
                n_fns += 2
            self.tick()
        return {"seconds": time.perf_counter() - t0, "n_functions": n_fns,
                "capture_s": self.capture_s, "bulk_bytes": bulk_size(self.gather())}


# ----------------------------------------------------------------- worker
class Worker:
    """The free-running process: rings + steppers + command loop, over one
    granule or a signature batch of them (one process stepping the whole
    batch a call while the ring protocol stays per channel — the batch
    merely refines the free-running schedule: its members run in
    lockstep, a legal schedule the credit chain already admits, so
    traffic stays bit-identical to per-granule workers)."""

    def __init__(self, spec, conn, hb: np.ndarray | None, device="cpu",
                 bulk: str | None = None, faults=()):
        self.sim = GranuleSim(spec, device)
        self.bulk_name = bulk  # the launcher creates it once the worker is ready
        self._bulk = None
        self.specs = self.sim.specs
        self.spec = self.sim.spec
        self.conn = conn
        # (4,) f64 view: [epochs_completed, wallclock, blocked-status, spare]
        self.hb = hb
        self.epochs_done = 0
        # Ring waits get twice the launcher's heartbeat timeout: when the
        # whole fleet blocks (deadlock), the launcher's stall diagnoser
        # fires FIRST and names the credit cycle; the worker-side
        # RingTimeout is the backstop, not the headline diagnosis.
        self.ring_timeout = self.spec.timeout * 2
        self.wait_s = 0.0  # time blocked on peer rings (credits/slabs)
        self.run_s = 0.0  # wallclock inside "run" commands
        self.ring_ops = 0  # credit/slab records pushed or popped
        self.telem = None  # TelemetryWriter once the entry attaches a ring
        self._init_faults(faults)
        itemsize = self.sim.np_dtype.itemsize
        self.rings: dict[tuple[str, int], ShmRing] = {}
        for s in self.specs:
            for ts in s.tiers:
                for c in ts.egress_chans + ts.ingress_chans:
                    if ("d", c) in self.rings:
                        continue  # both ends batched into this worker
                    self.rings[("d", c)] = ShmRing.attach(
                        data_ring_name(s.ring_prefix, c), s.ring_depth + 1,
                        slab_slot_bytes(ts.E, s.payload_words, itemsize),
                        checked=True, label=f"slab:c{c}",
                    )
                    self.rings[("c", c)] = ShmRing.attach(
                        credit_ring_name(s.ring_prefix, c), s.ring_depth + 2, 4,
                    )
            for name, chan, lqid, is_in in s.ext_ports:
                self.rings[("x", chan)] = ShmRing.attach(
                    ext_ring_name(s.ring_prefix, chan), s.capacity,
                    s.payload_words * itemsize, checked=True, label=f"ext:{name}",
                )

    def _init_faults(self, faults) -> None:
        from .faultinject import WorkerFaultInjector

        self.injector = WorkerFaultInjector(faults) if faults else None
        self.slow_per_epoch = 0.0  # faultinject "slow" straggler knob
        self.hb_muted = False      # faultinject "mute" (drop heartbeats)

    def corruptible_ring(self, chan: int | None) -> ShmRing:
        """The data ring a ``corrupt`` fault targets: the given channel, or
        this worker's first egress channel when unspecified."""
        if chan is None:
            chan = next((ts.egress_chans[0] for s in self.specs for ts in s.tiers
                         if ts.egress_chans), None)
        if chan is None or ("d", chan) not in self.rings:
            raise ValueError(f"no corruptible data ring for channel {chan}")
        return self.rings[("d", chan)]

    def beat(self) -> None:
        if self.hb is not None and not self.hb_muted:
            self.hb[0] = float(self.epochs_done)
            self.hb[1] = time.time()

    def _set_status(self, code: int) -> None:
        """Publish "blocked on ring X" (0 = running) in the heartbeat shm —
        the raw material of the launcher's credit wait-for graph."""
        if self.hb is not None:
            self.hb[2] = float(code)

    def _probe(self, gi: int, slot: int, row: int):
        return tree_map(lambda x: x[row, slot].cpu().numpy(),
                        self.sim.state.block_states[gi])

    def _bulk_buf(self):
        if self._bulk is None:
            self._bulk = attach_shared_memory(self.bulk_name)
        return self._bulk.buf

    # ------------------------------------------------------------ the epoch
    def _ingest_ext(self) -> None:
        for r, s in enumerate(self.specs):
            for name, chan, lqid, is_in in s.ext_ports:
                if not is_in:
                    continue
                ring = self.rings[("x", chan)]
                avail = ring.size()
                if not avail:
                    continue
                k = min(avail, s.capacity - 1)
                pays = ring.peek_packets(k, self.sim.np_dtype, self.sim.W)
                ring.advance(self.sim.ingest(r, lqid, pays))

    def _flush_ext(self) -> None:
        """Move ext-out packets from the local queue into the host ring.

        Contract vs the in-process engines: the worker flushes at every
        boundary whether or not the host is draining, so an UNdrained
        output port buffers up to one extra ring (capacity-1 packets) of
        output before backpressuring the producer.  A host that drains at
        boundaries — the session scripts — therefore sees per-boundary
        bit-identical traffic; a host that lets output accumulate sees an
        identical packet *sequence* with producer stalls engaging one ring
        later."""
        for r, s in enumerate(self.specs):
            for name, chan, lqid, is_in in s.ext_ports:
                if is_in:
                    continue
                ring = self.rings[("x", chan)]
                room = ring.free()
                if not room:
                    continue
                pays = self.sim.flush(r, lqid, room)
                if len(pays):
                    landed = ring.push_packets(pays)
                    if landed != len(pays):  # room was the drain limit
                        raise RuntimeError(f"ext ring {name}: {landed} of "
                                           f"{len(pays)} packets landed")

    def _timed(self, fn, *args, status: int = 0):
        """Run one potentially-blocking ring op, accumulating its wallclock
        into ``wait_s`` (the procs blocking-wait metric; same accounting in
        serial and overlapped schedules, so the fraction is comparable).
        ``status`` publishes the blocked-on-ring word for the stall
        diagnoser; deliberately left set when the op raises, so a timed-out
        worker's last status word names the ring it died waiting on."""
        if status:
            self._set_status(status)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        finally:
            self.wait_s += time.perf_counter() - t0
        self.ring_ops += 1
        if status:
            self._set_status(0)
        return out

    def _pop_order(self, rings, codes=None):
        """Yield ring indices as each becomes non-empty (round-robin poll):
        the receive-late fill consumes whichever peer's slab lands first
        instead of serializing on channel order.  Poll time with no ring
        ready counts as blocking wait; past the deadline the remaining
        indices are yielded so the blocking pop raises ``RingTimeout``
        with its usual diagnostics."""
        pending = list(range(len(rings)))
        deadline = time.monotonic() + self.ring_timeout
        delay = 20e-6
        while pending:
            progressed = False
            for i in list(pending):
                if not rings[i].empty():
                    pending.remove(i)
                    progressed = True
                    yield i
            if pending and not progressed:
                if time.monotonic() > deadline:
                    while pending:
                        yield pending.pop(0)
                    return
                if codes is not None:
                    self._set_status(codes[pending[0]])
                t0 = time.perf_counter()
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
                self.wait_s += time.perf_counter() - t0
        if codes is not None:
            self._set_status(0)

    def _exchange_issue(self, t: int) -> None:
        """Window-end send: pop credits, drain egress queues, push slabs."""
        rows = [s.tiers[t] for s in self.specs]
        if not rows[0].egress_chans:
            return
        # pop one credit per egress channel: the receiver's post-fill
        # free space from the PREVIOUS exchange (seeded capacity-1)
        creds = np.array(
            [[self._timed(self.rings[("c", c)].pop_u32_wait, self.ring_timeout,
                          status=encode_blocked(OP_CREDIT_POP, c))
              for c in ts.egress_chans] for ts in rows],
            np.int32,
        )
        slab, cnt = self.sim.drain(t, creds)
        for r, ts in enumerate(rows):
            for i, c in enumerate(ts.egress_chans):
                self._timed(self.rings[("d", c)].push_slab_wait,
                            int(cnt[r, i]), slab[r, i], self.ring_timeout,
                            status=encode_blocked(OP_SLAB_PUSH, c))

    def _exchange_commit(self, t: int) -> None:
        """Receive-late fill: pop slabs (first-ready order under overlap),
        fill ingress queues, push back post-fill free space as the next
        credits."""
        rows = [s.tiers[t] for s in self.specs]
        if not rows[0].ingress_chans:
            return
        n_in, E = len(rows[0].ingress_chans), rows[0].E
        slab_in = np.zeros((self.sim.nb, n_in, E, self.sim.W), self.sim.np_dtype)
        cnt_in = np.zeros((self.sim.nb, n_in), np.int32)
        flat = [(r, i, c, self.rings[("d", c)])
                for r, ts in enumerate(rows)
                for i, c in enumerate(ts.ingress_chans)]
        codes = [encode_blocked(OP_SLAB_POP, c) for _, _, c, _ in flat]
        # receive-late is part of the overlap feature; the serial schedule
        # keeps strict channel-order blocking pops (the honest baseline)
        order = (self._pop_order([ring for *_, ring in flat], codes)
                 if self.spec.overlap else range(len(flat)))
        for k in order:
            r, i, c, ring = flat[k]
            cnt_in[r, i], slab_in[r, i] = self._timed(
                ring.pop_slab_wait, (E, self.sim.W), self.sim.np_dtype,
                self.ring_timeout, status=codes[k])
        free = self.sim.fill(t, slab_in, cnt_in)
        for r, ts in enumerate(rows):
            for i, c in enumerate(ts.ingress_chans):
                self._timed(self.rings[("c", c)].push_u32, int(free[r, i]),
                            self.ring_timeout,
                            status=encode_blocked(OP_CREDIT_PUSH, c))

    def one_epoch(self) -> None:
        tl = self.telem
        if tl is not None and tl.enabled:
            return self._traced_epoch(tl)
        if self.injector is not None:
            # plan-driven faults fire at deterministic LOCAL epoch numbers,
            # before any of this epoch's effects (its first cycle-graph
            # replay and ring operation) — reproducible drills
            self.injector.before_epoch(self)
        if self.slow_per_epoch:
            time.sleep(self.slow_per_epoch)
        self._ingest_ext()
        for op, arg in self.sim.program:
            if op == "C":
                self.sim.cycles(arg)
            elif op == "XI":
                self._exchange_issue(arg)
            elif op == "XC":
                self._exchange_commit(arg)
            else:
                self._exchange_issue(arg)
                self._exchange_commit(arg)
        self._flush_ext()
        self.sim.tick()
        self.epochs_done += 1
        self.beat()

    def _traced_epoch(self, tl) -> None:
        """``one_epoch`` with per-phase telemetry records.  Mirrors the
        untraced walk exactly (same ring ops, same op order — traffic
        stays bit-identical); each phase costs one monotonic read, one
        non-blocking 48-byte ring push and, on the card, one synchronize
        of the device so the record covers the phase's device work."""
        dev = self.sim.device
        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        if self.injector is not None:
            self.injector.before_epoch(self)
        if self.slow_per_epoch:
            time.sleep(self.slow_per_epoch)
        wait0 = self.wait_s
        e0 = t0 = time.monotonic()
        self._ingest_ext()
        sync()
        tl.phase(_telem.TEV_INGEST, 0.0, t0)
        for op, arg in self.sim.program:
            t0 = time.monotonic()
            if op == "C":
                self.sim.cycles(arg)
                sync()
                tl.phase(_telem.TEV_STEP, float(arg), t0)
            elif op == "XI":
                self._exchange_issue(arg)
                sync()
                tl.phase(_telem.TEV_ISSUE, float(arg), t0)
            elif op == "XC":
                self._exchange_commit(arg)
                sync()
                tl.phase(_telem.TEV_COMMIT, float(arg), t0)
            else:
                self._exchange_issue(arg)
                sync()
                tl.phase(_telem.TEV_ISSUE, float(arg), t0)
                t0 = time.monotonic()
                self._exchange_commit(arg)
                sync()
                tl.phase(_telem.TEV_COMMIT, float(arg), t0)
        t0 = time.monotonic()
        self._flush_ext()
        sync()
        tl.phase(_telem.TEV_FLUSH, 0.0, t0)
        self.sim.tick()
        self.epochs_done += 1
        occ = n_d = 0
        for (kind, _c), ring in self.rings.items():
            if kind == "d":
                occ += ring.size()
                n_d += 1
        tl.emit(_telem.TEV_OCC, 0.0, time.monotonic(), 0.0,
                float(occ), float(n_d))
        tl.phase(_telem.TEV_EPOCH, float(self.epochs_done - 1), e0,
                 v0=self.wait_s - wait0)
        self.beat()

    def _profiled(self, n: int) -> dict:
        """``n`` epochs under ``torch.profiler``: the host wall seconds and
        the device's busy seconds (the union of its events' intervals;
        None when the trace holds no device event)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.sim.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                self.one_epoch()
            torch.cuda.synchronize(self.sim.device)
            wall = time.perf_counter() - t0
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events() if ev.device_type == DeviceType.CUDA)
        busy_us, reach = 0.0, float("-inf")
        for lo, hi in spans:
            if hi > reach:
                busy_us += hi - max(lo, reach)
                reach = hi
        return {"wall_s": wall, "busy_s": busy_us * 1e-6 if spans else None,
                "events": len(spans)}

    # --------------------------------------------------------- command loop
    def serve(self) -> None:
        while True:
            cmd = self.conn.recv()
            op = cmd[0]
            try:
                if op == "init":
                    _, key, group_params = cmd
                    self.sim.init(key, group_params)
                    self.epochs_done = 0
                    self.wait_s = self.run_s = 0.0
                    self.ring_ops = 0
                    self.beat()
                    self.conn.send(("ok", 0))
                elif op == "run":
                    t0 = time.perf_counter()
                    if len(cmd) > 2 and cmd[2]:
                        prof = self._profiled(int(cmd[1]))
                    else:
                        prof = None
                        for _ in range(int(cmd[1])):
                            self.one_epoch()
                    self.run_s += time.perf_counter() - t0
                    self.conn.send(("ok", self.epochs_done if prof is None
                                    else (self.epochs_done, prof)))
                elif op == "probe":
                    _, gi, slot, *rest = cmd
                    self.conn.send(("ok", self._probe(gi, slot, rest[0] if rest else 0)))
                elif op == "view":
                    # the done-predicate view: tables are constants the
                    # launcher already holds, so strip them from the
                    # per-epoch record (it re-attaches its numpy copies)
                    self.conn.send(("ok", write_bulk(self._bulk_buf(),
                                                     self.sim.gather(tables=False))))
                elif op == "gather":
                    self.conn.send(("ok", write_bulk(self._bulk_buf(), self.sim.gather())))
                elif op == "scatter":
                    _, slots, epochs = cmd
                    self.sim.load(read_bulk(self._bulk_buf(), slots, copy=False))
                    self.epochs_done = int(epochs)
                    self.beat()
                    self.conn.send(("ok", self.epochs_done))
                elif op == "stats":
                    self.conn.send(("ok", self._stats()))
                elif op == "telemetry":
                    on = bool(cmd[1])
                    if self.telem is not None:
                        self.telem.enabled = on
                    self.conn.send(("ok", on and self.telem is not None))
                elif op == "exit":
                    self.conn.send(("ok", None))
                    return
                else:
                    self.conn.send(("err", f"unknown command {op!r}"))
            except (RingCorruptionError, RingTimeout) as e:
                # fleet faults travel as a typed "fault" reply (not a
                # generic traceback) so the launcher can rebuild the
                # exception
                sys.stderr.write(traceback.format_exc())
                sys.stderr.flush()
                payload = {"error": type(e).__name__, "message": str(e)}
                if isinstance(e, RingCorruptionError):
                    payload["args"] = e.to_payload()
                try:
                    self.conn.send(("fault", payload))
                except (BrokenPipeError, OSError):
                    return
            except Exception:  # noqa: BLE001 — reported to the launcher
                sys.stderr.write(traceback.format_exc())
                sys.stderr.flush()
                try:
                    self.conn.send(("err", traceback.format_exc()))
                except (BrokenPipeError, OSError):
                    return

    def _stats(self):
        """One row per granule (a list for a signature batch)."""
        st = self.sim.state
        size = ((st.queues.head - st.queues.tail) % self.sim.capacity).cpu().numpy()
        cycles = st.cycle.cpu().numpy()
        cap = self.sim.capacity
        out = []
        for r, s in enumerate(self.specs):
            ports = {name: {"occupancy": int(size[r, lqid]),
                            "credit": int(cap - 1 - size[r, lqid]),
                            "is_input": bool(is_in)}
                     for name, chan, lqid, is_in in s.ext_ports}
            row = {
                "granule": s.granule,
                "cycle": int(cycles[r]),
                "epoch": self.epochs_done,
                "ports": ports,
                "signature": s.signature,
                "device": str(self.sim.device),
                "wait_s": self.wait_s,
                "run_s": self.run_s,
                "wait_fraction": (self.wait_s / self.run_s) if self.run_s else 0.0,
                "capture_s": self.sim.capture_s,
                "ring_ops": self.ring_ops,
                "telem_dropped": self.telem.dropped if self.telem else 0,
            }
            if self.sim.batched:
                row.update(batch_row=r, batch_size=len(self.specs))
            out.append(row)
        return out if self.sim.batched else out[0]


HB_RECORD_BYTES = 32  # per-worker heartbeat: [epochs, wallclock, status, _]
HB_RECORD_F64 = HB_RECORD_BYTES // 8


def attach_heartbeat(hb_ring_name: str, index: int):
    """Attach one member's heartbeat record (4 f64: [progress counter,
    wallclock, blocked-status word, spare]) in the fleet heartbeat shm.
    Returns (segment, view); the caller keeps the segment alive for the
    view's lifetime."""
    hb_shm = attach_shared_memory(hb_ring_name)
    hb = np.frombuffer(hb_shm.buf, np.float64, count=HB_RECORD_F64,
                       offset=index * HB_RECORD_BYTES)
    return hb_shm, hb


def worker_device(device: str, worker_index: int) -> torch.device:
    """Where worker ``worker_index`` runs: ``cuda:(index % device_count)``
    for a CUDA fleet (all on one card here), else the CPU."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("the worker finds no CUDA device")
        return torch.device("cuda", worker_index % n)
    return torch.device("cpu")


def worker_entry(conn, spec_segment: str, worker_index: int,
                 log_path: str | None, device: str,
                 hb_ring_name: str | None, bulk: str,
                 faults_pickle: bytes | None = None,
                 telem_ring_name: str | None = None) -> None:
    """Process entry point (forkserver or spawn context).  Reads its
    pickled spec from the ``spec_segment`` the launcher wrote, builds the
    granule simulator on its device (capturing its cycle graphs on the
    card), then serves the command loop until "exit"; its bulk records go
    through the segment ``bulk``.  ``faults_pickle`` carries this worker's
    armed ``FaultAction``s for the current fleet incarnation (drills; None
    in production): the environment is never re-parsed here.
    ``telem_ring_name`` is this worker's telemetry ring (it is its only
    producer; records flow once tracing is switched on)."""
    import pickle

    t_entry, entry_at = time.perf_counter(), time.time()
    if log_path:
        f = open(log_path, "w", buffering=1)
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        sys.stdout = os.fdopen(1, "w", buffering=1)
        sys.stderr = os.fdopen(2, "w", buffering=1)
    # SIGUSR1 writes every thread's Python stack to the log: the launcher
    # asks a silent worker for it before declaring it hung
    faulthandler.register(signal.SIGUSR1, file=sys.stderr, all_threads=True)
    try:
        seg = attach_shared_memory(spec_segment)
        try:
            spec = pickle.loads(seg.buf)
        finally:
            seg.close()
        faults = pickle.loads(faults_pickle) if faults_pickle else ()
        dev = worker_device(device, worker_index)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # one CPU device a worker
        if isinstance(spec, BatchSpec):
            print(f"[worker {worker_index}] granules {spec.members} "
                  f"signature {spec.signature} starting on {dev} (batched)",
                  flush=True)
        else:
            print(f"[worker {worker_index}] granule {spec.granule} "
                  f"signature {spec.signature} starting on {dev}", flush=True)
        if faults:
            print(f"[worker {worker_index}] armed faults: {faults}", flush=True)
        hb = hb_shm = None
        if hb_ring_name:
            hb_shm, hb = attach_heartbeat(hb_ring_name, worker_index)
        w = Worker(spec, conn, hb, dev, bulk, faults)
        if telem_ring_name:
            # stored under ("t", 0) so the exit sweep below closes it
            tring = ShmRing.attach(telem_ring_name, _telem.TELEM_RING_RECORDS,
                                   _telem.TELEM_RECORD_BYTES)
            w.rings[("t", 0)] = tring
            w.telem = _telem.TelemetryWriter(tring)
        setup_s = time.perf_counter() - t_entry  # spec, device context, state, rings
        build = w.sim.prebuild()
        build["setup_s"] = setup_s
        build["entry_at"] = entry_at  # wall clock: the launcher times the start
        print(f"[worker {worker_index}] prebuilt {build['n_functions']} fns "
              f"in {build['seconds']:.2f}s (capture {build['capture_s']:.2f}s)",
              flush=True)
        conn.send(("ready", build))
        w.serve()
        # release every live view of shm before interpreter exit
        for ring in w.rings.values():
            ring.close()
        if w._bulk is not None:
            w._bulk.close()
        w.hb = hb = None
        if hb_shm is not None:
            hb_shm.close()
        print(f"[worker {worker_index}] clean exit", flush=True)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        sys.stderr.flush()
        try:
            conn.send(("err", traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
        raise
