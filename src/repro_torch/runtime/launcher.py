"""Multiprocess launcher — ``Network.build(engine="procs")`` (paper §III),
as in ``repro.runtime.launcher``, on a single host.

``ProcsEngine`` realizes the paper's deployment model *literally* — one
free-running OS process per granule, connected at runtime by
shared-memory SPSC queues — behind the same ``Simulation`` facade as the
in-process engines.  The division of labor:

  * ``graph.lower_partition`` assigns every channel its granule-local
    queue (the same lowering the in-process engines consume, so the
    granule state layouts are bit-identical);
  * the launcher creates one slab ring + one credit ring per boundary
    channel and one packet ring per external port
    (``runtime.shmem.ShmRing``), spawns one worker per granule
    (``runtime.worker``), and speaks the session protocol to them over
    command pipes: ``init`` / ``run`` / ``view`` / ``probe`` / ``stats`` /
    checkpoint ``gather``/``scatter``;
  * host Tx/Rx ports read and write the external rings directly — host
    I/O never interrupts a running worker, it lands at the worker's next
    epoch boundary exactly like the in-process engines' host tier.

The launcher holds no simulation state: it lowers the partition, creates
the rings, spawns the workers and evaluates predicates on the numpy
views they send back.  Only numpy crosses a process boundary.  Workers
run on ``cuda:(worker % device_count)`` unless ``device="cpu"``; without
a card, ``device="cuda"`` (the default) raises here, before any spawn.

**Prebuild.**  The reference compiles one granule simulator per
*distinct granule signature* into a persistent XLA cache before spawning.
The port has no such cache (a CUDA graph cannot outlive its process):
``prebuild`` builds one ``GranuleSim`` a signature here, on the CPU, and
steps each of its steppers once on a template, so a shape fault fails
before any spawn; each worker then captures its own cycle graphs at start
(``build_stats`` keeps the reference's keys, the workers' ``stats`` carry
``capture_s``).

**Failure surface** (``runtime.fault_tolerance``): every reply wait polls
worker exitcodes (ANY exit while replies are pending, clean or not) and
per-epoch heartbeats; a dead or silent worker raises ``WorkerDiedError``
with that worker's captured log tail, and the remaining workers are torn
down — never a hang on a half-dead fleet.  When the WHOLE fleet goes
quiet, the per-worker "blocked on ring X" status words in the heartbeat
shm are decoded into the credit wait-for graph: a cycle raises
``FleetStallError`` naming the deadlock, an acyclic graph names the root
worker.  Checked rings surface slab corruption as
``RingCorruptionError``.

**Self-healing** (``runtime.recovery``): with ``on_fault="recover"`` (env
``REPRO_ON_FAULT``) the engine takes coordinated snapshots every
``snapshot_every`` epochs at command boundaries, and heals a dead, hung,
corrupted or deadlocked fleet by respawn (a fresh incarnation: new ring
namespace, new processes, each capturing its graphs anew) + restore +
replay, bit-identical to the fault-free timeline, host I/O included.
``fault_plan`` (env ``REPRO_FAULT_PLAN``, ``runtime.faultinject``) drills
it deterministically.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: multi-host fleets (``hosts``/``host``/``base_port``,
``REPRO_HOSTS``, ``REPRO_BRIDGE_PORT``; Queue 1 item 10.3), worker
telemetry (``set_tracing``, ``flush_telemetry``; item 10.4).
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import pickle
import secrets
import signal
import tempfile
import time
import weakref
from multiprocessing import get_context
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.distributed import GraphTables
from ..core.graph import (
    ChannelGraph, PartitionTree, Tier, lower_partition, normalize_partition,
    normalize_tiers,
)
from ..core.struct import tree_map
from ..kernels import granule_step
from ..obs.registry import REGISTRY
from .fault_tolerance import (
    FleetStallError, ProcessMonitor, WorkerDiedError, find_stall_cycle,
    read_log_tail, stall_wait_edges,
)
from .faultinject import actions_for, resolve_fault_plan, split_plan
from .recovery import RecoveryController, resolve_on_fault
from .shmem import (
    RingCorruptionError, RingTimeout, ShmRing, create_shared_memory,
    slab_slot_bytes,
)
from .worker import (
    HB_RECORD_BYTES, HB_RECORD_F64, BatchSpec, GranuleSim, GranuleSpec, GroupSpec,
    TierSpec, bulk_name, credit_ring_name, data_ring_name, ext_ring_name,
    heartbeat_name, numpy_dtype, read_bulk, spec_name, spec_tables, worker_entry,
    write_bulk,
)

Tree = Any

#: The ROADMAP items that bring what this engine refuses.
_HOSTS_ITEM = "ROADMAP Queue 1 item 10.3 (multi-host fleets)"
_TELEMETRY_ITEM = "ROADMAP Queue 1 item 10.4 (worker telemetry)"


def _worker_mp_context():
    """Multiprocessing context for worker processes.

    Default is a ``forkserver`` preloaded with ``repro_torch.runtime.worker``:
    the server pays the torch/repro_torch import ONCE, then every worker
    is a cheap fork of it.  Safe because importing the worker module
    touches no CUDA and starts no threads (each fork creates its own CUDA
    context), and the server is a fresh process, never a fork of a
    launcher that holds CUDA.  ``REPRO_WORKER_SPAWN=spawn`` restores plain
    spawn (each worker re-imports torch, seconds apiece).  ``fork`` is
    never used: a launcher may hold CUDA."""
    method = os.environ.get("REPRO_WORKER_SPAWN", "forkserver")
    if method not in ("forkserver", "spawn"):
        raise ValueError(
            f"REPRO_WORKER_SPAWN={method!r}: expected 'forkserver' or "
            "'spawn'"
        )
    if method == "forkserver":
        try:
            ctx = get_context("forkserver")
            ctx.set_forkserver_preload(["repro_torch.runtime.worker"])
            return ctx
        except (ValueError, OSError):  # platform without forkserver
            pass
    return get_context("spawn")


# Engines are tracked weakly: a garbage-collected engine tears itself down
# via __del__, and whatever is still alive at interpreter exit is closed
# here — worker processes and shm segments never outlive the launcher.
_live_engines: "weakref.WeakSet[ProcsEngine]" = weakref.WeakSet()


def _close_all_engines() -> None:  # pragma: no cover - interpreter exit
    for eng in list(_live_engines):
        try:
            eng.close()
        except Exception:
            pass


atexit.register(_close_all_engines)


@dataclasses.dataclass
class ProcsState:
    """The session's handle on a running fleet — a *reference*, not the
    state itself: granule state lives in the workers (that is the point).
    The handle carries the boundary-synchronized counters plus a
    generation stamp so a stale handle (pre-reset) fails loudly."""

    cycle: np.ndarray  # () int32 — identical on every worker at a boundary
    epoch: np.ndarray  # () int32
    generation: int

    def replace(self, **kw) -> "ProcsState":
        return dataclasses.replace(self, **kw)


def _env_set(name: str) -> bool:
    return bool(os.environ.get(name, "").strip())


def _refuse_unported(hosts, host, base_port) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of any
    multi-host setting, passed or from the environment."""
    fleet = {"hosts": hosts is not None, "host": host is not None,
             "base_port": base_port is not None,
             "REPRO_HOSTS": _env_set("REPRO_HOSTS"),
             "REPRO_BRIDGE_PORT": _env_set("REPRO_BRIDGE_PORT")}
    bad = [k for k, v in fleet.items() if v]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: multi-host fleets are not ported yet "
            f"({_HOSTS_ITEM}); the port's fleet runs on one host")


class ProcsEngine:
    """Free-running multiprocess engine over a partitioned ChannelGraph.

    graph:      the channel-graph IR.
    partition:  ``PartitionTree`` (tiered), or any flat instance->granule
                map ``normalize_partition`` accepts (with ``n_workers``/
                ``K``); granule ids are worker indices.
    n_workers:  worker count for flat partitions (default: max granule+1).
    K:          innermost sync rate (cycles between boundary exchanges).
    tiers:      refused: procs needs no mesh, so pass tiered layouts via a
                PartitionTree.
    ring_depth: slab records a boundary ring buffers (>= 2; staleness
                slack for the slab data — the credit chain already bounds
                epoch drift at one exchange period per channel).
    timeout:    seconds a worker waits on a ring / the launcher waits on a
                silent worker before declaring it dead.
    prebuild:   build one ``GranuleSim`` per distinct granule signature
                here, on the CPU, stepping each stepper once on a
                template, before any worker spawns (a shape fault fails
                first).  Each worker captures its own cycle graphs.
    cache_dir:  the reference's persistent XLA cache directory; the port
                keeps no compile cache (a CUDA graph cannot outlive its
                process), so anything but None raises ``ValueError``.
    log_dir:    where each worker's captured log goes (a fresh temporary
                directory by default).
    batch_signatures:
                group same-signature granules (``lowering.batch_plan``)
                into ONE worker process each, stepping the whole group as
                a leading-axis batch with one stepper call per program op
                — fewer processes and dispatches for replicated designs,
                bit-identical traffic.
    overlap:    split every tier exchange into issue (drain + push) and
                commit (pop + fill) phases (send-early/receive-late).
                Bit-identical traffic.  "auto"/bool with ``REPRO_OVERLAP``
                env override; auto = off.
    device:     where the workers run: ``"cuda"`` (the default; worker i on
                ``cuda:(i % device_count)``; raises without a card) or
                ``"cpu"`` (one intra-op thread a worker).
    on_fault:   "raise" (default) propagates the first fleet fault;
                "recover" auto-heals: snapshot periodically, and on a
                dead/hung/corrupted/deadlocked fleet respawn + restore +
                replay (``runtime.recovery``).  "auto"/str with
                ``REPRO_ON_FAULT`` env override; auto = raise.
    snapshot_every:
                coordinated-snapshot cadence in epochs (recover mode; the
                snapshot is a ``gather_state`` at the first command
                boundary on each multiple, where the fleet is quiesced,
                plus one at each run entry whose epoch moved).
    max_restarts:
                recovery attempts before giving up (the original fault is
                re-raised, chained).
    backoff_s:  base of the exponential respawn backoff (doubles per
                consecutive restart).
    fault_plan: deterministic fault injection for drills — a plan string
                (see ``runtime.faultinject``) or a sequence of
                ``FaultAction``; default: env ``REPRO_FAULT_PLAN``.  Link
                kinds (``linkkill``/``linkslow``/``linkcorrupt``) raise
                ``ValueError``: a single-host fleet has no bridged links.
    hosts, host, base_port:
                the reference's multi-host fleet; anything but None (or
                ``REPRO_HOSTS`` / ``REPRO_BRIDGE_PORT`` set) raises
                ``NotImplementedError`` (Queue 1 item 10.3).
    """

    engine_kind = "procs"

    def __init__(
        self,
        graph: ChannelGraph,
        partition=None,
        *,
        n_workers: int | None = None,
        K: int = 1,
        tiers: Sequence | None = None,
        ring_depth: int = 2,
        timeout: float = 60.0,
        prebuild: bool = True,
        cache_dir: str | None = None,
        log_dir: str | None = None,
        batch_signatures: bool = False,
        overlap: Any = "auto",
        on_fault: str = "auto",
        snapshot_every: int = 16,
        max_restarts: int = 3,
        backoff_s: float = 0.25,
        fault_plan: Any = None,
        hosts: Any = None,
        host: str | None = None,
        base_port: int | None = None,
        device="cuda",
    ):
        _refuse_unported(hosts, host, base_port)
        self.on_fault = resolve_on_fault(on_fault)
        self.fault_plan = resolve_fault_plan(fault_plan)
        self._incarnation = 0  # bumped on every recovery respawn
        if cache_dir is not None:
            raise ValueError(
                "cache_dir: the port's workers keep no persistent compile "
                "cache (each captures its own CUDA graphs at start); pass None")
        self.device = resolve_device(device)  # raises here without a card
        if isinstance(self.device, tuple):
            raise ValueError("procs places its workers itself: pass one device "
                             "('cuda' or 'cpu'), not a sequence")
        self.graph = graph
        if isinstance(partition, PartitionTree):
            if tiers is not None:
                raise ValueError("pass tiers via the PartitionTree, not both")
            ptree = partition
        else:
            if tiers is not None:
                tspec = normalize_tiers(tiers)
                raise ValueError(
                    "procs has no mesh to size tier axes "
                    f"{[t.axes for t in tspec]} — pass a PartitionTree"
                )
            if n_workers is None:
                part0 = normalize_partition(graph, partition, 1 << 30)
                n_workers = int(part0.max()) + 1 if part0.size else 1
            part = normalize_partition(graph, partition, n_workers)
            ptree = PartitionTree(
                part, (Tier(axes=("w",), K=int(K)),), {"w": int(n_workers)}
            )
        self.ptree = ptree
        self.tiers = ptree.tiers
        self.K_tiers = ptree.K_tiers
        self.periods = ptree.periods()
        self.cycles_per_epoch = ptree.cycles_per_epoch
        self.K = self.K_tiers[-1]
        self.G = ptree.n_granules
        self.E_tiers = tuple(min(p, graph.capacity - 1) for p in self.periods)
        self.W = graph.payload_words
        self.payload_words = graph.payload_words
        self.capacity = graph.capacity
        self.torch_dtype = graph.dtype
        self.dtype = numpy_dtype(graph.dtype)
        self.part = ptree.part
        # A boundary slab ring must hold one exchange window in flight PLUS
        # the next window the overlapped (send-early/receive-late) schedule
        # pushes before the previous one is consumed.  Shallower rings
        # deadlock the free-running fleet — fail fast at build time instead.
        ring_depth = int(ring_depth)
        if ring_depth < 2:
            raise ValueError(
                f"ring_depth={ring_depth} is too shallow: boundary slab "
                f"rings must hold two exchange windows (>= 2 slab records "
                f"of E_t slots each; tier slab depths E_t={self.E_tiers}) "
                f"so the overlapped schedule can push window w+1 before "
                f"window w is consumed — a shallower ring deadlocks the "
                f"free-running fleet instead of failing fast"
            )
        self.ring_depth = ring_depth
        self.overlap = granule_step.resolve_overlap(overlap)
        self.timeout = float(timeout)

        t0 = time.perf_counter()
        low = lower_partition(graph, ptree)
        self.lowering = low
        self.n_local = low.n_local
        self._chan_owner = low.chan_owner
        self._tx_local, self._rx_local = low.tx_local, low.rx_local

        self._ring_prefix = f"sb{os.getpid() % 100000:x}{secrets.token_hex(3)}"
        self._log_dir = log_dir or tempfile.mkdtemp(prefix="repro_torch_procs_")
        self._specs = [self._granule_spec(g) for g in range(self.G)]
        self.signatures = [s.signature for s in self._specs]

        # ---- signature-batch plan: one worker per granule, or (with
        # batch_signatures) one worker per signature group stepping the
        # whole group as a leading-axis batch
        self.batch_signatures = bool(batch_signatures)
        if self.batch_signatures:
            groups, where = low.batch_plan()
            self._worker_members = [tuple(ms) for ms in groups]
            self._worker_of = {g: b for g, (b, r) in where.items()}
            self._row_of = {g: r for g, (b, r) in where.items()}
        else:
            self._worker_members = [(g,) for g in range(self.G)]
            self._worker_of = {g: g for g in range(self.G)}
            self._row_of = {g: 0 for g in range(self.G)}
        self._wspecs = self._worker_specs()
        self._is_batch = [isinstance(s, BatchSpec) for s in self._wspecs]
        self.NW = len(self._wspecs)
        # channel id -> (producer worker, consumer worker) of its slab
        # direction: the topology the stall diagnoser decodes status
        # words against
        self._chan_workers = {
            c: (self._worker_of[s], self._worker_of[d])
            for (t, s, d), chans in self.lowering.routes.items()
            for c in chans
        }
        self.lowering_seconds = time.perf_counter() - t0

        worker_faults, link_faults = split_plan(self.fault_plan)
        bad = [a for a in worker_faults if a.worker >= self.NW]
        if bad:
            raise ValueError(
                f"fault plan targets worker(s) {[a.worker for a in bad]} "
                f"but the fleet has {self.NW} worker(s)"
            )
        if link_faults:
            raise ValueError(
                "fault plan has link fault(s) "
                f"{[a.kind for a in link_faults]} but the engine has no "
                f"bridged links (multi-host fleets: {_HOSTS_ITEM})")

        # ---- prebuild: one CPU simulator per DISTINCT (signature, batch)
        self.build_stats: dict[str, Any] = {
            "n_workers": self.NW,
            "n_signatures": len(set(self.signatures)),
            "compiled": {},
            "prebuild_seconds": 0.0,
        }
        if prebuild:
            t0 = time.perf_counter()
            done: set[tuple[str, int]] = set()
            for wspec in self._wspecs:
                nb = len(wspec.specs) if isinstance(wspec, BatchSpec) else 1
                key = (wspec.signature, nb)
                if key in done:
                    continue
                done.add(key)
                stats = GranuleSim(wspec, "cpu").prebuild(step=True)
                name = wspec.signature if nb == 1 else f"{wspec.signature}x{nb}"
                self.build_stats["compiled"][name] = stats
            self.build_stats["prebuild_seconds"] = time.perf_counter() - t0

        self._ctx = _worker_mp_context()
        self._procs: dict[int, Any] = {}
        self._conns: dict[int, Any] = {}
        self._rings: dict[str, ShmRing] = {}
        self._segments: dict[str, Any] = {}  # specs at spawn; bulk records
        self._bulk: dict[int, Any] = {}
        self._hb_shm = None
        self._hb: np.ndarray | None = None
        self._generation = 0
        self._launched = False
        self._closed = False
        self._monitor: ProcessMonitor | None = None
        self._np_tables_cache: dict[int, GraphTables] = {}
        self.launch_stats: dict[str, Any] = {}
        # packets per rx port the host already received before a recovery
        # rewind: the replay regenerates them, the host-facing pop drops
        # them (exactly-once delivery; owned by the RecoveryController)
        self._ext_discard: dict[str, int] = {}
        self._recovery = RecoveryController(
            self, snapshot_every=snapshot_every, max_restarts=max_restarts,
            backoff_s=backoff_s,
        )
        _live_engines.add(self)

    # ------------------------------------------------------------- lowering
    def _granule_spec(self, g: int) -> GranuleSpec:
        low, graph = self.lowering, self.graph
        groups = []
        for gi, grp in enumerate(graph.groups):
            mo = low.member_of[gi][g]
            groups.append(GroupSpec(
                block=grp.block,
                n_members=grp.n_members,
                n_slot=low.n_slot[gi],
                member_of=mo.copy(),
                active=low.act_tables[gi][g].copy(),
                rx_idx=low.rx_tables[gi][g].copy(),
                tx_idx=low.tx_tables[gi][g].copy(),
                params_local=(None if grp.params is None
                              else _tree_np(grp.params, mo)),
            ))
        tiers = []
        for t in range(self.ptree.n_tiers):
            eg, ing = low.tier_channels(t, g)
            tiers.append(TierSpec(
                K=self.K_tiers[t],
                E=self.E_tiers[t],
                egress_chans=tuple(eg),
                egress_lqids=low.tx_local[eg].astype(np.int32)
                if eg else np.zeros((0,), np.int32),
                ingress_chans=tuple(ing),
                ingress_lqids=low.rx_local[ing].astype(np.int32)
                if ing else np.zeros((0,), np.int32),
            ))
        ext = [
            (name, cid, int(max(low.tx_local[cid], low.rx_local[cid])), is_in)
            for name, cid, is_in in low.ext_channels(g)
        ]
        return GranuleSpec(
            granule=g,
            signature=low.granule_signature(g),
            payload_words=self.W,
            capacity=self.capacity,
            dtype=self.dtype.str,
            n_local=self.n_local,
            groups=groups,
            tiers=tiers,
            ext_ports=ext,
            ring_prefix=self._ring_prefix,
            ring_depth=self.ring_depth,
            timeout=self.timeout,
            overlap=self.overlap,
        )

    def _worker_specs(self) -> list:
        return [self._specs[ms[0]] if len(ms) == 1
                else BatchSpec(members=ms, specs=[self._specs[g] for g in ms])
                for ms in self._worker_members]

    # ------------------------------------------------------------- lifecycle
    def launch(self) -> "ProcsEngine":
        """Create the rings and spawn the workers — idempotent."""
        if self._launched:
            return self
        if self._closed:
            raise RuntimeError("engine was closed")
        t0 = time.perf_counter()
        itemsize = self.dtype.itemsize
        for (t, s, d), chans in sorted(self.lowering.routes.items()):
            for c in chans:
                # slab + host-port rings are integrity-checked (per-record
                # seq + crc32); 4-byte credit rings are not — their
                # payload IS the protocol invariant
                name = data_ring_name(self._ring_prefix, c)
                self._rings[name] = ShmRing.create(
                    name, self.ring_depth + 1,
                    slab_slot_bytes(self.E_tiers[t], self.W, itemsize),
                    checked=True, label=f"slab:c{c}",
                )
                name = credit_ring_name(self._ring_prefix, c)
                self._rings[name] = ShmRing.create(name, self.ring_depth + 2, 4)
        for name, (cid, is_in) in self.graph.ext_ports().items():
            rname = ext_ring_name(self._ring_prefix, cid)
            self._rings[rname] = ShmRing.create(
                rname, self.capacity, self.W * itemsize, checked=True,
                label=f"ext:{name}",
            )
        self._seed_credit_rings()

        hb_name = heartbeat_name(self._ring_prefix)
        self._hb_shm = create_shared_memory(hb_name, HB_RECORD_BYTES * self.NW)
        self._hb = np.frombuffer(self._hb_shm.buf, np.float64)
        self._hb[:] = 0.0
        rings_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        device = self.device.type
        for w, spec in enumerate(self._wspecs):
            # the spec rides in shared memory: a pipe moves MB/s on some
            # hosts, and a million-core granule's tables are megabytes
            blob = pickle.dumps(spec)
            sname = spec_name(self._ring_prefix, w)
            seg = self._segments[sname] = create_shared_memory(sname, len(blob))
            seg.buf[:] = blob
            parent, child = self._ctx.Pipe()
            log_path = os.path.join(self._log_dir, f"worker{w}.log")
            faults = actions_for(self.fault_plan, w, self._incarnation)
            p = self._ctx.Process(
                target=worker_entry,
                args=(child, sname, w, log_path, device, hb_name,
                      bulk_name(self._ring_prefix, w),
                      pickle.dumps(faults) if faults else None),
                daemon=True,
                name=f"repro-torch-granule-{w}",
            )
            p.start()
            child.close()
            self._procs[w] = p
            self._conns[w] = parent
        spawn_s = time.perf_counter() - t0

        self._monitor = ProcessMonitor(
            dict(self._procs),
            {w: os.path.join(self._log_dir, f"worker{w}.log")
             for w in range(self.NW)},
            heartbeat=lambda g: float(self._hb[g * HB_RECORD_F64])
            + float(self._hb[g * HB_RECORD_F64 + 1]),
            hang_timeout_s=self.timeout,
            diagnose=self._diagnose_stall,
        )
        self._launched = True
        segs = [r._shm for r in self._rings.values()] + [self._hb_shm]
        self.launch_stats = {"rings_seconds": rings_s, "spawn_seconds": spawn_s,
                             "n_rings": len(self._rings),
                             "shm_bytes": sum(seg.size for seg in segs),
                             "shm_pages": sum(-(-seg.size // 4096) for seg in segs),
                             "ready_seconds": {}, "build": {}}
        t0 = time.perf_counter()
        for w in range(self.NW):
            # no heartbeats exist yet (first beat lands on the init
            # command), so the ready-wait polls exitcodes only under a
            # generous absolute deadline — a cold start must not read as
            # "hung"
            kind, payload = self._recv(w, timeout=max(self.timeout, 300.0),
                                       hang_check=False)
            if kind != "ready":
                raise WorkerDiedError(w, f"failed to start: {payload}",
                                      read_log_tail(self._monitor.log_paths[w]))
            self.launch_stats["ready_seconds"][w] = time.perf_counter() - t0
            self.launch_stats["build"][w] = payload
            self._drop_segment(spec_name(self._ring_prefix, w))
            bname = bulk_name(self._ring_prefix, w)
            self._bulk[w] = self._segments[bname] = create_shared_memory(
                bname, max(int(payload["bulk_bytes"]), 64))
        REGISTRY.set("procs.workers", float(self.NW))
        REGISTRY.set("procs.incarnation", float(self._incarnation))
        if self.build_stats.get("prebuild_seconds"):
            REGISTRY.set("procs.prebuild.s",
                         float(self.build_stats["prebuild_seconds"]))
            REGISTRY.set("procs.compile.count",
                         float(len(self.build_stats.get("compiled", {}))))
        return self

    def _drop_segment(self, name: str) -> None:
        """Unlink a segment and unmap it once no view of it is left."""
        seg = self._segments.pop(name, None)
        if seg is None:
            return
        try:
            seg.close()
        except BufferError:
            pass  # a caller still holds a view: the mapping goes at exit
        seg.unlink()

    def _seed_credit_rings(self) -> None:
        """Every boundary channel's sender starts with capacity-1 credit —
        the engines' initial-credit convention, as one pre-seeded record."""
        for (t, s, d), chans in self.lowering.routes.items():
            for c in chans:
                ring = self._rings[credit_ring_name(self._ring_prefix, c)]
                ring.reset()
                ring.push_u32(self.capacity - 1, timeout=1.0)

    def close(self) -> None:
        """Tear down the workers and unlink every shared-memory segment.

        Every worker gets "exit", then the fleet 2 s in all to leave (a
        worker blocked on a dead peer's ring never reads it), then SIGTERM
        and 2 s more, then SIGKILL: no worker outlives the call."""
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns.values()):
            try:
                conn.send(("exit",))
            except (BrokenPipeError, OSError):
                pass
        procs = list(self._procs.values())
        _join_all(procs, 2.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
        _join_all(procs, 2.0)
        for p in procs:
            if p.is_alive():
                # SIGTERM can stay pending (a stopped process) or be
                # caught: a survivor would keep its CUDA context and card
                # memory beside the next incarnation
                p.kill()
                p.join()
                REGISTRY.inc("procs.close.killed")
        for conn in list(self._conns.values()):
            conn.close()
        for ring in self._rings.values():
            ring.close()
        self._rings.clear()
        for name in list(self._segments):
            self._drop_segment(name)
        self._bulk.clear()
        if self._hb_shm is not None:
            self._hb = None
            try:
                self._hb_shm.close()
                self._hb_shm.unlink()
            except (BufferError, OSError):
                pass
            self._hb_shm = None
        _live_engines.discard(self)

    def _reopen(self) -> None:
        """Respawn the fleet after a fault (the recovery path): a fresh
        ring namespace and fresh worker processes on the SAME lowering,
        each paying its CUDA context and graph captures again (the port
        keeps no compile cache).  The restart count gates incarnation-
        scoped fault-plan actions (``:r<N>``), so a fired drill fault does
        not re-fire during its own replay."""
        if not self._closed:
            self.close()
        self._incarnation += 1
        self._closed = False
        self._launched = False
        self._procs, self._conns, self._rings = {}, {}, {}
        self._segments, self._bulk = {}, {}
        self._hb_shm = self._hb = self._monitor = None
        self._ring_prefix = f"sb{os.getpid() % 100000:x}{secrets.token_hex(3)}"
        # specs embed the ring prefix — rebuild them for the new namespace
        self._specs = [self._granule_spec(g) for g in range(self.G)]
        self._wspecs = self._worker_specs()
        self._np_tables_cache = {}
        _live_engines.add(self)
        self.launch()

    def __del__(self):  # best-effort; atexit covers the normal path
        try:
            self.close()
        except Exception:
            pass

    # --------------------------------------------------------------- comms
    def _check_workers(self, waiting_on=None) -> None:
        if self._monitor is not None:
            try:
                self._monitor.check(waiting_on)
            except WorkerDiedError as e:
                p = self._procs.get(e.worker)
                if p is not None and p.exitcode is None:
                    # silent, not dead: its log tail gets its Python stack
                    e = WorkerDiedError(e.worker, e.reason, self._stack_tail(e.worker))
                # a dead or deadlocked granule poisons the whole fleet (its
                # peers would hang on its rings) — tear everything down
                # before raising
                self.close()
                raise e
            except FleetStallError:
                self.close()
                raise

    def _stack_tail(self, w: int) -> str:
        """Worker ``w``'s log tail after it wrote its threads' Python
        stacks there (SIGUSR1, ``faulthandler``)."""
        path = self._monitor.log_paths.get(w)
        before = os.path.getsize(path) if path and os.path.exists(path) else 0
        try:
            os.kill(self._procs[w].pid, signal.SIGUSR1)
        except OSError:
            return read_log_tail(path)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if path and os.path.exists(path) and os.path.getsize(path) > before:
                time.sleep(0.1)  # let the dump finish
                break
            time.sleep(0.02)
        return read_log_tail(path, max_bytes=8192)

    def _diagnose_stall(self, waiting_on: tuple[int, ...]):
        """Fleet-wide no-heartbeat diagnosis (monitor callback): decode
        every worker's "blocked on ring X" status word into the credit
        wait-for graph.  A cycle is a true deadlock → ``FleetStallError``
        naming it; an acyclic graph blames its root worker; no usable
        information returns None (the monitor falls back to the plain
        hung-worker error)."""
        if self._hb is None:
            return None
        blocked = {w: int(self._hb[w * HB_RECORD_F64 + 2]) for w in range(self.NW)}
        edges, details = stall_wait_edges(blocked, self._chan_workers)
        cycle = find_stall_cycle(edges)
        if cycle is not None:
            return FleetStallError(cycle, [details[w] for w in cycle])
        roots = set(edges.values()) - set(edges)
        if edges and roots:
            w = min(roots)
            return WorkerDiedError(
                w,
                f"is the root of a fleet-wide stall: {len(edges)} member(s) "
                f"transitively blocked on it while it made no progress for "
                f"{self.timeout:.0f}s",
                read_log_tail(self._monitor.log_paths.get(w)
                              if self._monitor else None),
            )
        return None

    def _send(self, g: int, cmd: tuple) -> None:
        """Send one command; a closed pipe means the worker is gone —
        surface WorkerDiedError (with the log tail) instead of
        BrokenPipeError, and tear the fleet down."""
        if self._closed:
            raise RuntimeError(
                "engine is closed (a worker died or close() was called); "
                "build a fresh engine"
            )
        try:
            self._conns[g].send(cmd)
            if self._monitor is not None:
                self._monitor.arm(g)
        except (BrokenPipeError, OSError):
            p = self._procs.get(g)
            if p is not None:
                p.join(timeout=1.0)
            rc = p.exitcode if p is not None else None
            tail = read_log_tail(
                self._monitor.log_paths[g] if self._monitor else None
            )
            self.close()
            raise WorkerDiedError(
                g, f"died with exitcode {rc} (command pipe closed)", tail
            )

    def _recv_raw(self, g: int):
        """recv() one reply from a worker whose pipe is ready — EOF-
        hardened (a worker can die between poll() and recv(); poll returns
        True at EOF), and typed ``("fault", ...)`` replies (worker-side
        ring corruption / ring timeout) are rebuilt into their original
        exception with the fleet torn down."""
        try:
            kind, payload = self._conns[g].recv()
        except (EOFError, OSError):
            p = self._procs.get(g)
            if p is not None:
                p.join(timeout=1.0)
            rc = p.exitcode if p is not None else None
            tail = read_log_tail(
                self._monitor.log_paths[g] if self._monitor else None
            )
            self.close()
            how = (f"died with exitcode {rc}" if rc
                   else "exited cleanly (exitcode 0) while replies were "
                        "still pending")
            raise WorkerDiedError(g, f"{how} (reply pipe closed)", tail)
        if kind == "fault":
            self.close()
            raise _rebuild_fault(g, payload)
        return kind, payload

    def _recv(self, g: int, timeout: float | None = None,
              progress: bool = False, hang_check: bool = True):
        """Await one reply.  ``progress=True`` (run commands): no absolute
        deadline — the ProcessMonitor's heartbeat watchdog converts a
        worker that stops making *epoch progress* for ``timeout`` seconds
        (dead, hung, or deadlocked on a ring) into a WorkerDiedError.
        ``hang_check=False`` (startup): workers emit no heartbeats before
        their first command, so only exitcodes are polled and the
        absolute deadline governs."""
        conn = self._conns[g]
        deadline = (None if progress
                    else time.monotonic() + (timeout or self.timeout))
        while not conn.poll(0.02):
            self._check_workers(waiting_on=(g,) if hang_check else None)
            if deadline is not None and time.monotonic() > deadline:
                tail = read_log_tail(self._monitor.log_paths[g])
                self.close()
                raise WorkerDiedError(
                    g, f"no reply within {timeout or self.timeout:.0f}s", tail
                )
        return self._recv_raw(g)

    def _command(self, g: int, cmd: tuple, timeout: float | None = None):
        self._send(g, cmd)
        kind, payload = self._recv(g, timeout)
        if kind == "err":
            self.close()
            raise RuntimeError(f"worker {g} command {cmd[0]!r} failed:\n{payload}")
        return payload

    def _broadcast(self, cmd, progress: bool = False) -> dict:
        """Send to every worker, then collect every reply — the workers run
        the command concurrently (free-running; no barrier inside).
        ``cmd`` is one command, or a ``{worker: command}`` dict.  Returns
        ``{worker: payload}``.

        Replies are consumed READY-FIRST, not in worker order: a typed
        fault reply (ring corruption, worker-side timeout) surfaces the
        moment it lands even while earlier-numbered workers are wedged by
        that same fault — detection latency is one poll interval, and the
        monitor's fleet-wide stall diagnosis reasons over exactly the
        still-pending set."""
        cmds = cmd if isinstance(cmd, dict) else dict.fromkeys(range(self.NW), cmd)
        for g in range(self.NW):
            self._send(g, cmds[g])
        out: dict = {}
        pending = set(range(self.NW))
        deadline = (None if progress
                    else time.monotonic() + self.timeout)
        while pending:
            ready = [g for g in sorted(pending) if self._conns[g].poll(0)]
            for g in ready:
                kind, payload = self._recv_raw(g)
                if kind == "err":
                    self.close()
                    raise RuntimeError(
                        f"worker {g} command {cmds[g][0]!r} failed:\n{payload}"
                    )
                out[g] = payload
                pending.discard(g)
            if not pending:
                break
            if ready:
                if deadline is not None:  # any reply rearms the deadline
                    deadline = time.monotonic() + self.timeout
                continue
            self._check_workers(waiting_on=tuple(sorted(pending)))
            if deadline is not None and time.monotonic() > deadline:
                g = min(pending)
                tail = read_log_tail(self._monitor.log_paths[g])
                self.close()
                raise WorkerDiedError(
                    g, f"no reply within {self.timeout:.0f}s", tail
                )
            time.sleep(0.02)
        return out

    # ------------------------------------------------------ engine protocol
    def init(self, key=0, group_params: dict[int, Tree] | None = None) -> ProcsState:
        """(Re)initialize every worker's granules.  ``key`` is an int seed
        or a ``torch.Generator`` (its state goes to the workers), as the
        in-process engines take it; ``group_params[gi]`` overrides group
        ``gi``'s stacked per-member params (global instantiation order)."""
        self.launch()
        self._generation += 1
        self._recovery.note_reset()
        for ring in self._rings.values():
            ring.reset()
        self._seed_credit_rings()
        if isinstance(key, torch.Generator):
            key = key.get_state().numpy().copy()
        else:
            key = int(key)
        per_granule: list[list | None] = [None] * self.G
        if group_params is not None:
            for g in range(self.G):
                sliced: list = [None] * len(self.graph.groups)
                for gi, p in group_params.items():
                    sliced[gi] = _tree_np(p, self.lowering.member_of[gi][g])
                per_granule[g] = sliced
        cmds = {}
        for w, members in enumerate(self._worker_members):
            if group_params is None:
                payload = None
            elif self._is_batch[w]:
                payload = [per_granule[g] for g in members]
            else:
                payload = [per_granule[members[0]]]
            cmds[w] = ("init", key, payload)
        self._broadcast(cmds)
        return ProcsState(
            cycle=np.zeros((), np.int32), epoch=np.zeros((), np.int32),
            generation=self._generation,
        )

    def _require(self, state: ProcsState) -> ProcsState:
        if not isinstance(state, ProcsState):
            raise TypeError(f"expected ProcsState, got {type(state).__name__}")
        if state.generation != self._generation:
            raise RuntimeError(
                "stale ProcsState: the engine was re-initialized (reset) "
                "after this handle was issued"
            )
        return state

    def run_epochs(self, state: ProcsState, n_epochs: int, *,
                   donate: bool = True) -> ProcsState:
        """Free-run ``n_epochs`` on every worker.  Returns when the slowest
        worker reaches the target epoch — the only global synchronization
        is this *observation* at the command boundary; during the run each
        worker is gated solely by its own channels' credits.  ``donate``
        is accepted for the engine protocol: the state lives in the
        workers either way.

        With ``on_fault="recover"`` the run goes through the recovery
        controller: coordinated snapshots on the ``snapshot_every`` epoch
        grid, and any recoverable fleet fault (dead / hung / corrupted /
        deadlocked) is healed by respawn + restore + replay instead of
        raised."""
        state = self._require(state)
        if n_epochs <= 0:
            return state
        if self.on_fault == "recover":
            return self._recovery.run_epochs(state, int(n_epochs))
        return self._run_epochs_raw(state, int(n_epochs))

    def _run_epochs_raw(self, state: ProcsState, n_epochs: int) -> ProcsState:
        return self._run_all(state, ("run", int(n_epochs)))[0]

    def _run_all(self, state: ProcsState, cmd) -> tuple[ProcsState, dict]:
        replies = self._broadcast(cmd, progress=True)
        epochs = {w: (r[0] if isinstance(r, tuple) else r) for w, r in replies.items()}
        done = next(iter(epochs.values()))
        if any(e != done for e in epochs.values()):
            raise RuntimeError(f"workers disagree on the epoch count: {epochs}")
        return state.replace(cycle=np.int32(done * self.cycles_per_epoch),
                             epoch=np.int32(done)), replies

    def profile_epochs(self, state: ProcsState, n_epochs: int
                       ) -> tuple[ProcsState, dict]:
        """``run_epochs`` with every worker's epochs under
        ``torch.profiler`` (CUDA fleets): returns the state and, a worker,
        ``{"wall_s", "busy_s", "events"}`` — the seconds its own kernels
        kept the device busy over its window, from which its idle share
        follows (workers time-slice one card, so their busy seconds add)."""
        state = self._require(state)
        if self.device.type != "cuda":
            raise ValueError("profile_epochs traces a CUDA fleet's devices")
        state, replies = self._run_all(state, ("run", int(n_epochs), True))
        return state, {w: r[1] for w, r in replies.items()}

    def run_cycles(self, state: ProcsState, n_cycles: int, *,
                   donate: bool = True) -> ProcsState:
        return self.run_epochs(state, -(-int(n_cycles) // self.cycles_per_epoch))

    def _done_view(self, view):
        return view

    def _np_tables(self, g: int) -> GraphTables:
        """This granule's GraphTables as numpy (the launcher-side copy the
        lightweight ``view`` replies are rejoined with — tables are
        constant, so they never ride the per-epoch record)."""
        if g not in self._np_tables_cache:
            self._np_tables_cache[g] = spec_tables(self._specs[g])
        return self._np_tables_cache[g]

    def _views(self) -> list:
        """Per-GRANULE state views in granule order, numpy leaves (batched
        workers reply with the stacked batch; each member's row is sliced
        back out).  The leaves are views of the workers' bulk segments,
        valid until the next command."""
        out: list = [None] * self.G
        for w, slots in self._broadcast(("view",)).items():
            v = read_bulk(self._bulk[w].buf, slots, copy=False)
            for r, g in enumerate(self._worker_members[w]):
                vv = tree_map(lambda x: x[r], v) if self._is_batch[w] else v
                out[g] = vv.replace(tables=self._np_tables(g))
        return out

    def eval_done(self, state: ProcsState, done_fn: Callable) -> bool:
        """Evaluate a granule-local predicate on every worker's state view
        (host-side — predicates are arbitrary closures, which do not cross
        process boundaries).  The view's leaves are CPU tensors, so a
        predicate written for the in-process engines runs unchanged."""
        self._require(state)
        return all(bool(torch.as_tensor(done_fn(self._done_view(_cpu_tensors(v)))).all())
                   for v in self._views())

    def run_until(self, state: ProcsState, done_fn: Callable,
                  max_epochs: int, *, cache_key: Any = None,
                  donate: bool = True) -> ProcsState:
        """Run until ``done_fn`` holds on every granule (checked at epoch
        boundaries, the engines' cadence), at most ``max_epochs`` more.
        ``cache_key`` and ``donate`` are accepted for the engine protocol:
        nothing is captured launcher-side."""
        state = self._require(state)
        ran = 0
        while ran < max_epochs and not self.eval_done(state, done_fn):
            state = self.run_epochs(state, 1)
            ran += 1
        return state

    def run_until_done(self, state: ProcsState, max_epochs: int, **kw) -> ProcsState:
        return self.run_until(
            state, lambda v: np.asarray(True), max_epochs, **kw
        )

    # ------------------------------------------------------------- probing
    def group_state(self, state: ProcsState, inst) -> Tree:
        """One instance's (unstacked) live state, CPU tensors — mirrors the
        in-process engines' ``group_state``."""
        self._require(state)
        inst_id = inst if isinstance(inst, int) else inst.inst_id
        gi, slot_g = self.graph.locate(inst_id)
        g = int(self.lowering.member_granule[gi][slot_g])
        slot = int(self.lowering.member_slot[gi][slot_g])
        w = self._worker_of[g]
        return _cpu_tensors(self._command(w, ("probe", gi, slot, self._row_of[g])))

    def gather_group(self, state: ProcsState, gi: int) -> Tree:
        """Group ``gi``'s member states in global instantiation order
        (numpy leaves)."""
        self._require(state)
        views = self._views()
        low = self.lowering

        def pick(*leaves):
            if not len(low.member_granule[gi]):
                return np.zeros((0,))
            return np.stack([leaves[g][low.member_slot[gi][m]]
                             for m, g in enumerate(low.member_granule[gi])])

        return tree_map(pick, *[v.block_states[gi] for v in views])

    def worker_stats(self, state: ProcsState | None = None) -> list[dict]:
        """One record per GRANULE (batched workers reply with a list, one
        per batch row — flattened here so the schema is engine-invariant)."""
        if state is not None:
            self._require(state)
        out: list[dict] = []
        for w, payload in sorted(self._broadcast(("stats",)).items()):
            out.extend(payload if isinstance(payload, list) else [payload])
        return out

    def set_tracing(self, on: bool) -> bool:
        """Per-worker phase telemetry is not ported yet: switching it on
        raises ``NotImplementedError`` (Queue 1 item 10.4); off is the
        state the fleet is in."""
        if on:
            raise NotImplementedError(
                f"worker telemetry is not ported yet ({_TELEMETRY_ITEM})")
        return False

    def flush_telemetry(self) -> None:
        """Not ported yet (Queue 1 item 10.4)."""
        raise NotImplementedError(
            f"worker telemetry is not ported yet ({_TELEMETRY_ITEM})")

    def port_stats(self, state: ProcsState) -> dict[str, dict]:
        """Per external port: shm-ring occupancy (packets the host can pop /
        has parked) plus the owning worker's device-queue occupancy — the
        uniform ``Simulation.stats()["ports"]`` schema."""
        self._require(state)
        wstats = {s["granule"]: s for s in self.worker_stats()}

        def rec(cid, name, is_in):
            ring = self._rings[ext_ring_name(self._ring_prefix, cid)]
            size, free = ring.size(), ring.free()
            g = int(self._chan_owner[cid])
            dev = wstats[g]["ports"].get(name, {})
            return {
                "occupancy": size + int(dev.get("occupancy", 0)),
                "credit": (self.capacity - 1 - int(dev.get("occupancy", 0)))
                if is_in else free,
                "ring": size,
                "home": g,
            }

        return {
            "tx": {n: rec(c, n, True) for n, c in self.graph.ext_in.items()},
            "rx": {n: rec(c, n, False) for n, c in self.graph.ext_out.items()},
        }

    # ---------------------- host-side external ports (PySbTx/PySbRx surface)
    def _ext_ring(self, table: dict, name: str) -> ShmRing:
        if name not in table:
            raise KeyError(name)
        return self._rings[ext_ring_name(self._ring_prefix, table[name])]

    def _payloads(self, payload) -> np.ndarray:
        if isinstance(payload, torch.Tensor):
            payload = payload.detach().cpu().numpy()
        return np.asarray(payload, self.dtype).reshape(-1, self.W)

    def _ext_pop_host(self, state: ProcsState, name: str, max_n: int) -> np.ndarray:
        """Host-facing pop: raw ring pops are journaled for recovery, and
        packets a replay regenerated that the host already received
        before the rewind are silently dropped (exactly-once delivery)."""
        skip = int(self._ext_discard.get(name, 0))
        got = self._ext_ring(self.graph.ext_out, name).pop_packets(
            int(max_n) + skip, self.dtype, self.W)
        if len(got):
            self._recovery.note_ext_pop(state, name, len(got))
        if skip:
            dropped = min(skip, len(got))
            self._ext_discard[name] = skip - dropped
            got = got[dropped:]
        return got

    # recovery hooks: exactly-once host delivery across a rewind
    def _replay_ext_push(self, name: str, batch) -> None:
        arr = np.asarray(batch, self.dtype).reshape(-1, self.W)
        self._ext_ring(self.graph.ext_in, name).push_packets(arr)

    def _set_ext_discard(self, discards: dict) -> None:
        self._ext_discard = {k: int(v) for k, v in discards.items() if v}

    def _ext_discard_state(self) -> dict:
        return {k: v for k, v in self._ext_discard.items() if v}

    def host_push(self, state: ProcsState, name: str, payload):
        state = self._require(state)
        arr = self._payloads(payload)[:1]
        n = self._ext_ring(self.graph.ext_in, name).push_packets(arr)
        if n:
            self._recovery.note_ext_push(state, name, arr[:n])
        return state, torch.tensor(n == 1)

    def host_pop(self, state: ProcsState, name: str):
        state = self._require(state)
        got = self._ext_pop_host(state, name, 1)
        if len(got):
            return state, torch.from_numpy(got[0]), torch.tensor(True)
        return state, torch.zeros((self.W,), dtype=self.torch_dtype), torch.tensor(False)

    def host_push_many(self, state: ProcsState, name: str, payloads):
        state = self._require(state)
        arr = self._payloads(payloads)[: self.capacity - 1]
        n = self._ext_ring(self.graph.ext_in, name).push_packets(arr)
        if n:
            self._recovery.note_ext_push(state, name, arr[:n])
        return state, torch.tensor(n, dtype=torch.int32)

    def host_pop_many(self, state: ProcsState, name: str, max_n: int):
        state = self._require(state)
        got = self._ext_pop_host(state, name, max_n)
        out = np.zeros((max_n, self.W), self.dtype)
        out[: len(got)] = got
        return state, torch.from_numpy(out), torch.tensor(len(got), dtype=torch.int32)

    # ------------------------------------------------- checkpoint (gather)
    def gather_state(self, state: ProcsState) -> Tree:
        """Full-fleet state as one tree of numpy leaves: every worker's
        granule state, every boundary channel's in-flight credit record,
        every external ring's resident packets (fixed-size buffers +
        counts, so the checkpoint template is shape-stable)."""
        state = self._require(state)
        workers: dict[str, Any] = {}
        for w, slots in self._broadcast(("gather",)).items():
            tree_w = read_bulk(self._bulk[w].buf, slots, copy=True)
            for r, g in enumerate(self._worker_members[w]):
                workers[f"g{g}"] = (tree_map(lambda x: x[r], tree_w)
                                    if self._is_batch[w] else tree_w)
        credits = {}
        for (t, s, d), chans in sorted(self.lowering.routes.items()):
            for c in chans:
                snap = self._rings[credit_ring_name(self._ring_prefix, c)].snapshot()
                # at a command boundary exactly one credit is in flight
                if len(snap) != 1:
                    raise AssertionError(
                        f"channel {c} holds {len(snap)} credits at a boundary")
                credits[f"c{c}"] = snap[0].copy()
        # every dict in key order: the reference's tree flattens so
        return {
            "credits": dict(sorted(credits.items())),
            "cycle": np.asarray(state.cycle),
            "epoch": np.asarray(state.epoch),
            "ext": self._gather_ext(),
            "workers": dict(sorted(workers.items())),
        }

    def _gather_ext(self) -> dict:
        """The external rings' resident packets + seq counters, by port
        name in key order.  Checked rings snapshot WITH their headers, and
        the (producer, consumer) sequence counters ride along so a restore
        into a FRESH segment resumes the exact seq timeline."""
        ext = {}
        for name, (cid, is_in) in self.graph.ext_ports().items():
            ring = self._rings[ext_ring_name(self._ring_prefix, cid)]
            snap = ring.snapshot()
            buf = np.zeros((self.capacity - 1, ring.stride), np.uint8)
            buf[: len(snap)] = snap
            ext[name] = {"buf": buf, "count": np.int32(len(snap)),
                         "seq": np.asarray(ring.seq_state(), np.int64)}
        return dict(sorted(ext.items()))

    def scatter_state(self, state: ProcsState, tree: Tree) -> ProcsState:
        """Restore a ``gather_state`` tree into the running fleet: credits
        and external rings restored, data rings emptied, every worker's
        granules scattered."""
        state = self._require(state)
        self._recovery.note_scatter()
        tree = tree_map(lambda x: x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x), tree)
        for (t, s, d), chans in sorted(self.lowering.routes.items()):
            for c in chans:
                self._rings[credit_ring_name(self._ring_prefix, c)].restore(
                    np.asarray(tree["credits"][f"c{c}"])[None])
                self._rings[data_ring_name(self._ring_prefix, c)].reset()
        for name, (cid, is_in) in self.graph.ext_ports().items():
            rec = tree["ext"][name]
            seq = tuple(int(x) for x in np.asarray(rec["seq"]).ravel())
            self._rings[ext_ring_name(self._ring_prefix, cid)].restore(
                np.asarray(rec["buf"])[: int(rec["count"])], seq=seq)
        epoch = int(np.asarray(tree["epoch"]).ravel()[0])
        cmds = {}
        for w, members in enumerate(self._worker_members):
            rows = [tree["workers"][f"g{g}"] for g in members]
            payload = (tree_map(lambda *xs: np.stack(xs), *rows)
                       if self._is_batch[w] else rows[0])
            cmds[w] = ("scatter", write_bulk(self._bulk[w].buf, payload), epoch)
        self._broadcast(cmds)
        return state.replace(
            cycle=np.int32(np.asarray(tree["cycle"]).ravel()[0]),
            epoch=np.int32(epoch),
        )

    # -------------------------------------------------------- fault surface
    def fault_stats(self) -> dict:
        """Recovery/fault counters — ``Simulation.stats()["faults"]``."""
        return self._recovery.stats()

    def _handle_at(self, epoch: int) -> ProcsState:
        """A fresh state handle pinned at ``epoch`` — the recovery restore
        path's replacement for the handle that rode into the fault."""
        return ProcsState(
            cycle=np.int32(int(epoch) * self.cycles_per_epoch),
            epoch=np.int32(int(epoch)),
            generation=self._generation,
        )


def _join_all(procs: list, timeout: float) -> None:
    """Join every process, ``timeout`` seconds in all."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))


def _rebuild_fault(worker: int, payload: dict) -> Exception:
    """Rebuild a worker's typed ``("fault", ...)`` reply into its original
    exception (ring corruption / ring timeout)."""
    if payload.get("error") == "RingCorruptionError":
        return RingCorruptionError(**payload["args"])
    return RingTimeout(
        f"worker {worker}: {payload.get('message', 'ring timeout')}"
    )


def _tree_np(tree: Tree, idx: np.ndarray) -> Tree:
    """``tree``'s rows ``idx`` as numpy (tensor or numpy leaves)."""
    def rows(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x)[np.asarray(idx)]

    return tree_map(rows, tree)


def _cpu_tensors(tree: Tree) -> Tree:
    """A numpy tree as CPU tensors (views, no copies)."""
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)
