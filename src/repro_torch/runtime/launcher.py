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

**Multi-host fleets** (``runtime.fleet``, ``runtime.bridge``): with
``hosts`` (env ``REPRO_HOSTS``) the granules are sharded over that many
launcher processes, the leader (this engine) and one follower launcher a
further host; a channel whose ends lie on two hosts keeps a local ring
pair on each, paired over TCP by one bridge proxy process a host and
link.  Traffic, state and the per-tier staleness bound are the
single-host fleet's, bit for bit; a dead link raises ``LinkDownError``,
which recovery heals like a dead worker (teardown, re-rendezvous under a
fresh incarnation token, restore, replay).

**Telemetry** (``obs.telemetry``): ``set_tracing(True)`` makes every
worker emit one record a phase into its telemetry ring; the launcher
drains the rings while it waits on a free-running fleet and at every
command boundary into the trace recorder and the metrics registry, a
follower's through the leader (``obs_drain``).
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import pickle
import secrets
import signal
import socket
import sys
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
from ..obs import telemetry as _telem
from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from . import fleet as _fleet
from .bridge import BridgeChannel, BridgeSpec, bridge_entry
from .fault_tolerance import (
    FleetStallError, LinkDownError, ProcessMonitor, WorkerDiedError,
    find_stall_cycle, read_log_tail, stall_wait_edges,
)
from .faultinject import actions_for, resolve_fault_plan, split_plan
from .recovery import RecoveryController, resolve_on_fault
from .shmem import (
    RingCorruptionError, RingTimeout, ShmRing, attach_shared_memory,
    create_shared_memory, slab_slot_bytes,
)
from .worker import (
    HB_RECORD_BYTES, HB_RECORD_F64, BatchSpec, GranuleSim, GranuleSpec, GroupSpec,
    TierSpec, bulk_name, credit_ring_name, data_ring_name, ext_ring_name,
    heartbeat_name, numpy_dtype, read_bulk, spec_name, spec_tables, worker_entry,
    write_bulk,
)

Tree = Any


def _worker_mp_context():
    """Multiprocessing context for worker, bridge and follower processes.

    Default is a ``forkserver`` preloaded with ``repro_torch.runtime.worker``
    (and the bridge and fleet modules): the server pays the
    torch/repro_torch import ONCE, then every worker is a cheap fork of
    it.  Safe because importing the worker module
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
            ctx.set_forkserver_preload(["repro_torch.runtime.worker",
                                        "repro_torch.runtime.bridge",
                                        "repro_torch.runtime.fleet"])
            _start_forkserver()
            return ctx
        except (ValueError, OSError):  # platform without forkserver
            pass
    return get_context("spawn")


def _start_forkserver() -> None:
    """Start the forkserver (if it is not running) with this process's
    ``sys.path`` on its ``PYTHONPATH``.  Some Python 3.12 releases (3.12.3,
    on the card's machine) do not hand ``sys.path`` to the server, whose
    preload then cannot import this package when it is found through
    ``sys.path`` alone: the server swallows the ``ImportError``, and every
    worker imports torch itself, ~7 s a start on that machine against
    ~0.1 s from a preloaded server."""
    from multiprocessing import forkserver

    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + ([saved] if saved else []))
    try:
        forkserver.ensure_running()
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved


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
    stop_helpers()


atexit.register(_close_all_engines)


def _stop_helper(obj, pid_attr: str, fd_attr: str, timeout: float) -> int | None:
    """Close the "alive" pipe of a multiprocessing helper this process
    started and reap it; SIGKILL it after ``timeout`` seconds.  Returns its
    pid, or None when this process runs no such helper."""
    pid, fd = getattr(obj, pid_attr, None), getattr(obj, fd_attr, None)
    if pid is None or fd is None:
        return None
    try:
        os.close(fd)
    except OSError:
        pass
    setattr(obj, fd_attr, None)
    deadline = time.monotonic() + timeout
    try:
        while os.waitpid(pid, os.WNOHANG)[0] == 0:
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                break
            time.sleep(0.01)
    except ChildProcessError:
        pass
    setattr(obj, pid_attr, None)
    return pid


def helper_pids() -> list[int]:
    """The pids of the forkserver and resource tracker this process
    started and still runs."""
    from multiprocessing import forkserver, resource_tracker

    return [pid for pid in (forkserver._forkserver._forkserver_pid,
                            resource_tracker._resource_tracker._pid)
            if pid is not None]


def stop_helpers(timeout: float = 10.0) -> list[int]:
    """Stop this process's forkserver and resource tracker, if it started
    them, and wait until they have exited.  Left alone, each leaves only
    when its parent has, and a forkserver that preloaded torch takes a
    while to shut down: it would outlive the program.  Call it once every
    fleet of this process is closed (interpreter exit does); the next
    fleet starts both anew.  Returns the pids it stopped."""
    from multiprocessing import forkserver, resource_tracker
    from multiprocessing import util as mp_util

    stopped = []
    fs = forkserver._forkserver
    with fs._lock:
        address = fs._forkserver_address
        pid = _stop_helper(fs, "_forkserver_pid", "_forkserver_alive_fd", timeout)
        if pid is not None:
            stopped.append(pid)
            if address and not mp_util.is_abstract_socket_namespace(address):
                try:
                    os.unlink(address)
                except OSError:
                    pass
            fs._forkserver_address = None
    rt = resource_tracker._resource_tracker
    with rt._lock:
        pid = _stop_helper(rt, "_pid", "_fd", timeout)
    if pid is not None:
        stopped.append(pid)
    return stopped


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
                ``FaultAction``; default: env ``REPRO_FAULT_PLAN``.
                Link-fault kinds (``linkkill``/``linkslow``/``linkcorrupt``)
                target bridged links and are executed launcher-side at
                epoch boundaries; a single-host fleet refuses them.
    hosts:      multi-host fleet placement: a host count, comma list of
                names, ``{host: [granule, ...]}`` dict, or a
                ``runtime.fleet.HostPlan``; default env ``REPRO_HOSTS``,
                else single-host.  The partition's granules are sharded
                across that many launcher processes, whose workers' traffic
                crosses hosts only through TCP ring bridges
                (``runtime.bridge``) — traffic, state, and the per-tier
                staleness bound are bit-identical to the single-host engine.
    host:       which plan host THIS engine instance is (internal: set by
                ``fleet.follower_entry``; user code leaves it None and
                gets the leader).
    base_port:  deterministic bridge/control port base (link i listens on
                ``base_port + i``, the leader's control listener on
                ``base_port + n_links``); default env
                ``REPRO_BRIDGE_PORT``, else ephemeral ports exchanged at
                rendezvous.
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
        self.on_fault = resolve_on_fault(on_fault)
        self.fault_plan = resolve_fault_plan(fault_plan)
        self._incarnation = 0  # bumped on every recovery respawn
        if cache_dir is not None:
            raise ValueError(
                "cache_dir: the port's workers keep no persistent compile "
                "cache (each captures its own CUDA graphs at start); pass None")
        # raises here without a card; a follower launcher (``host``) trusts
        # the leader's check and leaves the CUDA driver untouched: only its
        # workers touch the card
        self.device = (torch.device(device) if host is not None
                       else resolve_device(device))
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
        self._chan_tier = {c: t
                           for (t, _s, _d), chans in self.lowering.routes.items()
                           for c in chans}
        self.lowering_seconds = time.perf_counter() - t0
        self._plan_hosts(hosts, host, base_port)

        worker_faults, self._link_faults = split_plan(self.fault_plan)
        bad = [a for a in worker_faults if a.worker >= self.NW]
        if bad:
            raise ValueError(
                f"fault plan targets worker(s) {[a.worker for a in bad]} "
                f"but the fleet has {self.NW} worker(s)"
            )
        if self._link_faults:
            if self.host_plan is None:
                raise ValueError(
                    "fault plan has link fault(s) "
                    f"{[a.kind for a in self._link_faults]} but the engine "
                    "has no bridged links (pass hosts=)")
            badl = [a for a in self._link_faults
                    if a.worker >= len(self._links)]
            if badl:
                raise ValueError(
                    f"fault plan targets link(s) "
                    f"{[a.worker for a in badl]} but the fleet has "
                    f"{len(self._links)} bridged link(s)")
        self._fired_links: set = set()

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
        # every worker's bulk segment by global id: created here for local
        # workers, attached at rendezvous for a follower's
        self._bulk: dict[int, Any] = {}
        self._reset_fleet_members()
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
        # flight recorder: per-worker telemetry ring names, tracing toggle,
        # and the (pid, tid) tracks already named
        self._telem_on = False
        self._telem_names: dict[int, str] = {}
        self._telem_tracked: set[tuple[int, int]] = set()
        # a follower's report of its own faults to the leader (set by
        # ``fleet.follower_entry``; ``_fail`` calls it before the teardown)
        self._fault_report: Callable[[Exception], None] | None = None
        self._fault_reported = False
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

    def _plan_hosts(self, hosts, host, base_port) -> None:
        """Multi-host placement (``runtime.fleet``): shard the worker set
        over named hosts, one launcher process a host, cross-host channels
        carried by TCP ring bridges."""
        self.host_plan = _fleet.resolve_host_plan(hosts, self.G)
        if host is not None and self.host_plan is None:
            raise ValueError(
                "host= names a fleet member but no multi-host plan was "
                "given (pass hosts=)")
        self.host = (host if host is not None
                     else (self.host_plan.leader if self.host_plan else None))
        self.is_leader = (self.host_plan is None
                          or self.host == self.host_plan.leader)
        if self.host_plan is None:
            self._host_of_w = {w: None for w in range(self.NW)}
            self._local_ws = tuple(range(self.NW))
            self._chan_hosts, self._links, self._local_links = {}, (), ()
            self.NB = 0
            self._bridge_ids, self._link_of_chan = {}, {}
            self._chan_peers = self._chan_workers
            self._base_port = 0
            self._fleet_token = secrets.token_hex(8)
            return
        if self.host not in self.host_plan.hosts:
            raise ValueError(f"host {self.host!r} is not in the plan "
                             f"{self.host_plan.hosts}")
        for w, ms in enumerate(self._worker_members):
            hs = sorted({self.host_plan.host_of(g) for g in ms})
            if len(hs) > 1:
                raise ValueError(
                    f"signature-batch worker {w} spans hosts {hs} "
                    f"(granules {list(ms)}); a batched worker must stay "
                    "on one host — adjust the host plan or disable "
                    "batch_signatures")
        self._host_of_w = {w: self.host_plan.host_of(ms[0])
                           for w, ms in enumerate(self._worker_members)}
        self._local_ws = tuple(w for w in range(self.NW)
                               if self._host_of_w[w] == self.host)
        self._chan_hosts = {c: (self._host_of_w[sw], self._host_of_w[dw])
                            for c, (sw, dw) in self._chan_workers.items()}
        self._links = _fleet.build_links(self.host_plan, self._chan_hosts)
        self._local_links = tuple(lk for lk in self._links
                                  if self.host in (lk.accept, lk.dial))
        self.NB = len(self._local_links)
        self._bridge_ids = {lk.link: self.NW + i
                            for i, lk in enumerate(self._local_links)}
        self._link_of_chan = {c: lk.link for lk in self._links
                              for c, _sh in lk.chans}
        # host-local stall topology: a cross-host channel's remote end is
        # its LOCAL bridge proxy's monitor id, so the stall graph blames
        # the bridge, never an innocent remote worker
        self._chan_peers = {}
        for c, (sw, dw) in self._chan_workers.items():
            sh, dh = self._chan_hosts[c]
            if self.host not in (sh, dh):
                continue
            if sh == dh:
                self._chan_peers[c] = (sw, dw)
                continue
            b = self._bridge_ids[self._link_of_chan[c]]
            self._chan_peers[c] = (sw if sh == self.host else b,
                                   dw if dh == self.host else b)
        self._base_port = _fleet.resolve_base_port(base_port)
        self._fleet_token = secrets.token_hex(8)

    def _reset_fleet_members(self) -> None:
        """No bridge, follower or attached segment: a fresh incarnation's
        bookkeeping (the constructor's, and ``_reopen``'s)."""
        self._bridge_procs: dict[int, Any] = {}
        self._bridge_conns: dict[int, Any] = {}
        self._bridge_labels: dict[int, str] = {}
        self._bridge_logs: dict[int, str] = {}
        self._accept_ports: dict[int, int] = {}
        self._follower_procs: dict[str, Any] = {}
        self._follower_ctls: dict[str, Any] = {}
        self._follower_mid: dict[str, int] = {}
        self._follower_hello: dict[str, dict] = {}
        self._ctl_listener: socket.socket | None = None
        self._remote_bulk: list = []

    # ------------------------------------------------------------- lifecycle
    def _local_chans(self):
        """(tier, channel) of every boundary channel with a ring pair on
        this host, in route order."""
        for (t, s, d), chans in sorted(self.lowering.routes.items()):
            for c in chans:
                # a multi-host fleet materialises a channel's rings on
                # every host that touches it: both endpoints of a
                # cross-host channel get LOCAL rings under this launcher's
                # own shm namespace, paired over TCP by the bridge —
                # workers run unmodified
                if self.host_plan is None or self.host in self._chan_hosts[c]:
                    yield t, c

    def launch(self) -> "ProcsEngine":
        """Create this host's rings and spawn its workers and bridges (and,
        on the fleet leader, the follower launchers) — idempotent."""
        if self._launched:
            return self
        if self._closed:
            raise RuntimeError("engine was closed")
        t0 = time.perf_counter()
        itemsize = self.dtype.itemsize
        for t, c in self._local_chans():
            # slab + host-port rings are integrity-checked (per-record
            # seq + crc32); 4-byte credit rings are not — their payload
            # IS the protocol invariant
            name = data_ring_name(self._ring_prefix, c)
            self._rings[name] = ShmRing.create(
                name, self.ring_depth + 1,
                slab_slot_bytes(self.E_tiers[t], self.W, itemsize),
                checked=True, label=f"slab:c{c}",
            )
            name = credit_ring_name(self._ring_prefix, c)
            self._rings[name] = ShmRing.create(name, self.ring_depth + 2, 4)
        for name, (cid, is_in) in self.graph.ext_ports().items():
            if self.host_plan is not None and self._ext_home_host(cid) != self.host:
                continue
            rname = ext_ring_name(self._ring_prefix, cid)
            self._rings[rname] = ShmRing.create(
                rname, self.capacity, self.W * itemsize, checked=True,
                label=f"ext:{name}",
            )
        self._seed_credit_rings()

        hb_name = heartbeat_name(self._ring_prefix)
        nhb = self.NW + self.NB  # bridge proxies beat alongside the workers
        self._hb_shm = create_shared_memory(hb_name, HB_RECORD_BYTES * nhb)
        self._hb = np.frombuffer(self._hb_shm.buf, np.float64)
        self._hb[:] = 0.0
        rings_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        # followers first: each boots a whole launcher (its own lowering,
        # forkserver and workers), which then runs beside this host's
        # spawns instead of after them
        blob_s = self._spawn_followers() if (self.host_plan is not None
                                             and self.is_leader) else 0.0
        device = self.device.type
        started: dict[int, float] = {}
        for w in self._local_ws:
            spec = self._wspecs[w]
            # the spec rides in shared memory: a pipe moves MB/s on some
            # hosts, and a million-core granule's tables are megabytes
            blob = pickle.dumps(spec)
            sname = spec_name(self._ring_prefix, w)
            seg = self._segments[sname] = create_shared_memory(sname, len(blob))
            seg.buf[:] = blob
            # flight-recorder ring: always created (a few hundred KB),
            # records only flow once tracing is switched on
            tname = _telem.telemetry_ring_name(self._ring_prefix, w)
            self._rings[tname] = ShmRing.create(
                tname, _telem.TELEM_RING_RECORDS, _telem.TELEM_RECORD_BYTES)
            self._telem_names[w] = tname
            parent, child = self._ctx.Pipe()
            log_path = os.path.join(self._log_dir, f"worker{w}.log")
            faults = actions_for(self.fault_plan, w, self._incarnation)
            p = self._ctx.Process(
                target=worker_entry,
                args=(child, sname, w, log_path, device, hb_name,
                      bulk_name(self._ring_prefix, w),
                      pickle.dumps(faults) if faults else None, tname),
                daemon=True,
                name=f"repro-torch-granule-{w}",
            )
            started[w] = time.time()
            p.start()
            child.close()
            self._procs[w] = p
            self._conns[w] = parent
        for i, lk in enumerate(self._local_links):
            self._spawn_bridge(i, lk, hb_name)
        spawn_s = time.perf_counter() - t0

        # accept-side bridges report their bound listener ports first
        for i, lk in enumerate(self._local_links):
            mid = self.NW + i
            kind, payload = self._bridge_recv(mid, max(self.timeout, 120.0))
            if kind != "ready":
                raise self._bridge_dead(mid, f"failed to start: {payload}")
            if payload is not None:
                self._accept_ports[lk.link] = int(payload)

        procs: dict[int, Any] = dict(self._procs)
        procs.update(self._bridge_procs)
        logs = {w: os.path.join(self._log_dir, f"worker{w}.log")
                for w in self._local_ws}
        logs.update(self._bridge_logs)
        labels = dict(self._bridge_labels)
        for h, mid in self._follower_mid.items():
            procs[mid] = self._follower_procs[h]
            logs[mid] = os.path.join(self._log_dir, f"launcher-{h}.log")
            labels[mid] = f"launcher {h}"
        self._monitor = ProcessMonitor(
            procs, logs,
            heartbeat=lambda g: float(self._hb[g * HB_RECORD_F64])
            + float(self._hb[g * HB_RECORD_F64 + 1]),
            hang_timeout_s=self.timeout,
            diagnose=self._diagnose_stall,
            labels=labels,
            link_ids=frozenset(self._bridge_ids.values()),
        )
        self._launched = True
        segs = [r._shm for r in self._rings.values()] + [self._hb_shm]
        self.launch_stats = {"rings_seconds": rings_s, "spawn_seconds": spawn_s,
                             "n_rings": len(self._rings),
                             "shm_bytes": sum(seg.size for seg in segs),
                             "shm_pages": sum(-(-seg.size // 4096) for seg in segs),
                             "ready_seconds": {}, "entry_seconds": {}, "build": {}}
        t0 = time.perf_counter()
        for w in self._local_ws:
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
            # from the spawn to the worker's entry function
            self.launch_stats["entry_seconds"][w] = payload["entry_at"] - started[w]
            self._drop_segment(spec_name(self._ring_prefix, w))
            bname = bulk_name(self._ring_prefix, w)
            self._bulk[w] = self._segments[bname] = create_shared_memory(
                bname, max(int(payload["bulk_bytes"]), 64))
        if self.host_plan is not None and self.is_leader:
            t0 = time.perf_counter()
            self._rendezvous_fleet()
            self.launch_stats.update(blob_seconds=blob_s,
                                     rendezvous_seconds=time.perf_counter() - t0)
        REGISTRY.set("procs.workers", float(self.NW))
        REGISTRY.set("procs.incarnation", float(self._incarnation))
        if self.build_stats.get("prebuild_seconds"):
            REGISTRY.set("procs.prebuild.s",
                         float(self.build_stats["prebuild_seconds"]))
            REGISTRY.set("procs.compile.count",
                         float(len(self.build_stats.get("compiled", {}))))
        if self._telem_on and self.is_leader:
            # a respawn (recovery _reopen) keeps tracing on across
            # incarnations; a pre-launch set_tracing lands here too
            self._apply_tracing()
        # a follower returns here with its bridges still un-dialed:
        # ``fleet.follower_entry`` sends the hello (with _accept_ports)
        # and calls _finish_rendezvous once the leader broadcasts the map
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

    # ------------------------------------------------ fleet wiring (leader)
    def _ext_home_host(self, cid: int):
        """The host owning an external port's granule (its ring lives
        there; the leader forwards host I/O to it over the control link)."""
        g = int(self._chan_owner[cid])
        return self._host_of_w[self._worker_of[g]]

    def _bulk_names(self) -> dict:
        """This host's workers' bulk segments by worker (a follower's
        hello: the leader reads views and gathers from them and writes
        scatters into them)."""
        return {w: bulk_name(self._ring_prefix, w) for w in self._local_ws}

    def _child_pids(self) -> list:
        """Every worker and bridge process this launcher started."""
        return [p.pid for p in (*self._procs.values(),
                                *self._bridge_procs.values())]

    def _spawn_bridge(self, i: int, lk, hb_name: str) -> None:
        mid = self.NW + i
        itemsize = self.dtype.itemsize
        channels = []
        for c, src_host in lk.chans:
            t = self._chan_tier[c]
            channels.append(BridgeChannel(
                chan=c,
                side="tx" if src_host == self.host else "rx",
                data_name=data_ring_name(self._ring_prefix, c),
                data_capacity=self.ring_depth + 1,
                data_slot_bytes=slab_slot_bytes(self.E_tiers[t], self.W,
                                                itemsize),
                credit_name=credit_ring_name(self._ring_prefix, c),
                credit_capacity=self.ring_depth + 2,
            ))
        role = "accept" if lk.accept == self.host else "dial"
        spec = BridgeSpec(
            link=lk.link, label=lk.label, host=self.host,
            peer=lk.peer_of(self.host), role=role, token=self._fleet_token,
            port=(self._base_port + lk.link if self._base_port else 0),
            channels=tuple(channels), timeout=self.timeout,
            hb_name=hb_name, hb_index=mid,
        )
        parent, child = self._ctx.Pipe()
        log_path = os.path.join(self._log_dir, f"bridge{lk.link}.log")
        p = self._ctx.Process(
            target=bridge_entry,
            args=(child, pickle.dumps(spec), log_path),
            daemon=True,
            name=f"repro-torch-bridge-{lk.link}",
        )
        p.start()
        child.close()
        self._bridge_procs[mid] = p
        self._bridge_conns[mid] = parent
        self._bridge_labels[mid] = f"bridge {lk.label}"
        self._bridge_logs[mid] = log_path

    def _spawn_followers(self) -> float:
        """Bind the fleet control listener and spawn one follower launcher
        per non-leader host (each a full ProcsEngine restricted to its
        granules — ``fleet.follower_entry``).  The build blob (graph,
        partition, engine arguments) rides in one shared-memory segment
        every follower reads: tens of MB at wafer scale, too slow for a
        pipe.  Returns the seconds pickling and writing it took."""
        plan = self.host_plan
        port = self._base_port + len(self._links) if self._base_port else 0
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind(("127.0.0.1", port))
        lst.listen(plan.n_hosts)
        self._ctl_listener = lst
        addr = ("127.0.0.1", lst.getsockname()[1])
        kwargs = dict(
            ring_depth=self.ring_depth, timeout=self.timeout,
            prebuild=False, batch_signatures=self.batch_signatures,
            overlap=self.overlap, on_fault="raise",
            fault_plan=self.fault_plan, hosts=plan,
            base_port=self._base_port, device=self.device.type,
        )
        t0 = time.perf_counter()
        blob = pickle.dumps((self.graph, self.ptree, kwargs))
        bname = f"{self._ring_prefix}f"
        seg = self._segments[bname] = create_shared_memory(bname, len(blob))
        seg.buf[:] = blob
        blob_s = time.perf_counter() - t0
        self.build_stats["follower_blob_bytes"] = len(blob)
        followers = tuple(h for h in plan.hosts if h != self.host)
        for j, h in enumerate(followers):
            mid = self.NW + self.NB + j
            boot = _fleet.FollowerBoot(
                host=h, leader_addr=addr, token=self._fleet_token,
                build=bname, timeout=self.timeout,
                incarnation=self._incarnation,
            )
            log_path = os.path.join(self._log_dir, f"launcher-{h}.log")
            # NOT daemonic: a follower spawns its own worker/bridge
            # children (daemons cannot).  Leader death still reaps it —
            # its control-link recv raises ConnectionError and it exits.
            p = self._ctx.Process(
                target=_fleet.follower_entry,
                args=(pickle.dumps(boot), log_path),
                daemon=False,
                name=f"repro-torch-launcher-{h}",
            )
            p.start()
            self._follower_procs[h] = p
            self._follower_mid[h] = mid
        return blob_s

    def _rendezvous_fleet(self) -> None:
        """Leader rendezvous: collect follower hellos (their accept-side
        bridge ports and bulk segments), broadcast the aggregated link ->
        address map, dial the local bridges, then wait for every member's
        all-links-up."""
        followers = self._follower_hosts

        def _alive() -> None:
            for h, p in self._follower_procs.items():
                if p.exitcode is not None:
                    mid = self._follower_mid[h]
                    tail = read_log_tail(
                        os.path.join(self._log_dir, f"launcher-{h}.log"))
                    self.close()
                    raise WorkerDiedError(
                        mid, f"died with exitcode {p.exitcode} during "
                        "rendezvous", tail, label=f"launcher {h}")

        t0 = time.perf_counter()
        conns = _fleet.accept_followers(
            self._ctl_listener, followers, self._fleet_token,
            timeout=max(self.timeout, 300.0), on_wait=_alive)
        self.launch_stats["followers_seconds"] = time.perf_counter() - t0
        # every follower has read the build blob before its hello
        self._drop_segment(f"{self._ring_prefix}f")
        addr_map = {lk: ("127.0.0.1", prt)
                    for lk, prt in self._accept_ports.items()}
        for h, (ctl, ports, hello) in conns.items():
            self._follower_ctls[h] = ctl
            self._follower_hello[h] = hello
            for lk, prt in ports.items():
                addr_map[int(lk)] = ("127.0.0.1", int(prt))
            for w, name in hello.get("bulk", {}).items():
                seg = attach_shared_memory(name)
                self._bulk[int(w)] = seg
                self._remote_bulk.append(seg)
        for h in followers:
            self._follower_ctls[h].send(("rendezvous", addr_map))
        self._finish_rendezvous(addr_map)
        self.launch_stats["hosts"] = {
            h: self._ctl_wait(h, timeout=max(self.timeout, 300.0))
            for h in followers}

    def _finish_rendezvous(self, addr_map: dict) -> None:
        """Dial this host's dial-side bridges and wait for every local
        link to come up (HELLO handshake verified bridge-side)."""
        for i, lk in enumerate(self._local_links):
            mid = self.NW + i
            if lk.accept != self.host:
                if lk.link not in addr_map:
                    raise self._bridge_dead(
                        mid, f"rendezvous map lacks {lk.label}")
                self._bridge_conns[mid].send(("dial",
                                              tuple(addr_map[lk.link])))
        for i, lk in enumerate(self._local_links):
            mid = self.NW + i
            kind, payload = self._bridge_recv(mid, max(self.timeout, 300.0))
            if kind != "up":
                raise self._bridge_dead(
                    mid, f"link never came up: got {kind!r} {payload!r}")

    def _seed_credit_rings(self) -> None:
        """Every boundary channel's sender starts with capacity-1 credit —
        the engines' initial-credit convention, as one pre-seeded record.
        On a bridged fleet only the SENDER's host seeds a cross-host
        channel (the receiver host's credit ring starts empty: the bridge
        drains the receiver's post-fill credits into it and forwards them
        over the wire — seeding both sides would double the credit)."""
        for _t, c in self._local_chans():
            ring = self._rings[credit_ring_name(self._ring_prefix, c)]
            ring.reset()
            if self.host_plan is None or self._chan_hosts[c][0] == self.host:
                ring.push_u32(self.capacity - 1, timeout=1.0)

    def close(self) -> None:
        """Tear down workers, bridges and follower launchers, and unlink
        every shared-memory segment.

        Everyone gets "exit" first (followers tear their own fleets down
        concurrently), then the workers and bridges 2 s in all to leave (a
        worker blocked on a dead peer's ring never reads it), then SIGTERM
        and 2 s more, then SIGKILL: none outlives the call.  A follower
        gets 10 s (its own teardown runs the same sequence), then SIGTERM
        and SIGKILL, and then the processes it reported at rendezvous are
        killed and its segments unlinked, so nothing of it outlives the
        call either."""
        if self._closed:
            return
        self._closed = True
        if self._telem_on:
            try:  # last drain before the rings unlink (best-effort)
                self._drain_telemetry_once()
            except Exception:
                pass
        for conn in (list(self._follower_ctls.values())
                     + list(self._bridge_conns.values())
                     + list(self._conns.values())):
            try:
                conn.send(("exit",))
            except (BrokenPipeError, ConnectionError, OSError):
                pass
        procs = list(self._procs.values()) + list(self._bridge_procs.values())
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
        followers = list(self._follower_procs.items())
        _join_all([p for _h, p in followers], 10.0)
        for h, p in followers:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join()
            if p.exitcode != 0:
                self._reap_follower(h)
        for conn in list(self._conns.values()) + list(self._bridge_conns.values()):
            conn.close()
        for ctl in list(self._follower_ctls.values()):
            ctl.close()
        if self._ctl_listener is not None:
            self._ctl_listener.close()
            self._ctl_listener = None
        for ring in self._rings.values():
            ring.close()
        self._rings.clear()
        for name in list(self._segments):
            self._drop_segment(name)
        for seg in self._remote_bulk:
            try:
                seg.close()
            except BufferError:
                pass  # a caller still holds a view: the mapping goes at exit
        self._remote_bulk = []
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

    def _reap_follower(self, host: str) -> None:
        """After a follower died unclean: kill the processes it reported
        at rendezvous and unlink the segments under its ring prefix."""
        hello = self._follower_hello.get(host) or {}
        for pid in hello.get("pids", ()):
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass
        prefix = hello.get("prefix")
        if prefix and os.path.isdir("/dev/shm"):
            import _posixshmem

            for f in os.listdir("/dev/shm"):
                if f.startswith(prefix):
                    try:
                        _posixshmem.shm_unlink("/" + f)
                    except OSError:
                        pass

    def _reopen(self) -> None:
        """Respawn the fleet after a fault (the recovery path): a fresh
        ring namespace, fresh worker, bridge and follower processes on the
        SAME lowering, each worker paying its CUDA context and graph
        captures again (the port keeps no compile cache), and on a bridged
        fleet a re-rendezvous under a fresh incarnation token.  The
        restart count gates incarnation-scoped fault-plan actions
        (``:r<N>``), so a fired drill fault does not re-fire during its
        own replay."""
        if not self._closed:
            self.close()
        self._incarnation += 1
        self._closed = False
        self._launched = False
        self._procs, self._conns, self._rings = {}, {}, {}
        self._segments, self._bulk = {}, {}
        self._reset_fleet_members()
        self._telem_names = {}
        self._hb_shm = self._hb = self._monitor = None
        self._fired_links = set()
        # fresh incarnation token: a bridge or follower surviving from the
        # previous incarnation can never splice into the new rendezvous
        self._fleet_token = secrets.token_hex(8)
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
        # Early follower faults FIRST: a remote worker fault lands as a
        # typed ("fault", ...) control frame, usually accompanied by
        # collateral bridge deaths (the follower tears its fleet down
        # before reporting) — prefer the root-cause frame over blaming
        # the first dead bridge the monitor happens to see.  The frame
        # can still lose the race to the monitor (TCP latency), so
        # LinkDownError and the typed fault are equivalent triggers for
        # recovery (both are RECOVERABLE).
        self._poll_follower_faults()
        if self._monitor is not None:
            try:
                self._monitor.check(waiting_on)
            except WorkerDiedError as e:
                p = self._procs.get(e.worker)
                if p is not None and p.exitcode is None:
                    # silent, not dead: its log tail gets its Python stack
                    e = WorkerDiedError(e.worker, e.reason, self._stack_tail(e.worker))
                if isinstance(e, LinkDownError) and self._follower_ctls:
                    # the link's far side may be reporting the root cause
                    # (its worker's fault, which tore its end down): give
                    # its typed frame a moment to land
                    deadline = time.monotonic() + 0.25
                    while time.monotonic() < deadline:
                        self._poll_follower_faults()
                        time.sleep(0.01)
                # a dead or deadlocked granule poisons the whole fleet (its
                # peers would hang on its rings) — tear everything down
                # before raising
                raise self._fail(e)
            except FleetStallError as e:
                raise self._fail(e)

    def _fail(self, exc: Exception) -> Exception:
        """Tear the fleet down and hand back ``exc`` to raise.  A follower
        reports it to the leader first (``_fault_report``), so the root
        cause lands there before the collateral death of the bridges this
        teardown ends."""
        if self._fault_report is not None and not self._fault_reported:
            self._fault_reported = True
            try:
                self._fault_report(exc)
            except (ConnectionError, OSError):
                pass
        self.close()
        return exc

    def _poll_follower_faults(self) -> None:
        for h, ctl in list(self._follower_ctls.items()):
            try:
                msg = ctl.peek()
            except ConnectionError:
                raise self._follower_dead(h, "control link closed unexpectedly")
            if msg is not None and msg[0] in ("fault", "err"):
                ctl.take()
                self.close()
                if msg[0] == "fault":
                    raise _fleet.decode_fault(msg[1], h)
                raise RuntimeError(f"follower {h} command failed:\n{msg[1]}")

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
        every member's "blocked on ring X" status word into the credit
        wait-for graph.  A cycle is a true deadlock → ``FleetStallError``
        naming it; an acyclic graph blames its root member — a bridge
        proxy root raises ``LinkDownError`` (the link, not an innocent
        worker, is the fault); no usable information returns None (the
        monitor falls back to the plain hung-worker error)."""
        if self._hb is None:
            return None
        members = list(self._local_ws) + list(self._bridge_ids.values())
        blocked = {w: int(self._hb[w * HB_RECORD_F64 + 2]) for w in members}
        edges, details = stall_wait_edges(blocked, self._chan_peers)
        cycle = find_stall_cycle(edges)
        if cycle is not None:
            return FleetStallError(cycle, [details[w] for w in cycle])
        roots = set(edges.values()) - set(edges)
        if edges and roots:
            w = min(roots)
            cls = LinkDownError if w >= self.NW else WorkerDiedError
            return cls(
                w,
                f"is the root of a fleet-wide stall: {len(edges)} member(s) "
                f"transitively blocked on it while it made no progress for "
                f"{self.timeout:.0f}s",
                read_log_tail(self._monitor.log_paths.get(w)
                              if self._monitor else None),
                label=(self._monitor.labels.get(w)
                       if self._monitor is not None else None),
            )
        return None

    # ------------------------------------------------------- bridge command
    def _bridge_dead(self, mid: int, reason: str) -> LinkDownError:
        label = self._bridge_labels.get(mid, f"bridge {mid}")
        tail = read_log_tail(self._bridge_logs.get(mid))
        return self._fail(LinkDownError(mid, reason, tail, label=label))

    def _bridge_recv(self, mid: int, timeout: float):
        conn = self._bridge_conns[mid]
        deadline = time.monotonic() + timeout
        while not conn.poll(0.05):
            p = self._bridge_procs.get(mid)
            if p is not None and p.exitcode is not None:
                raise self._bridge_dead(mid, f"died with exitcode {p.exitcode}")
            if time.monotonic() > deadline:
                raise self._bridge_dead(mid, f"no reply within {timeout:.0f}s")
        try:
            return conn.recv()
        except (EOFError, OSError):
            raise self._bridge_dead(mid, "command pipe closed")

    def _bridge_cmd(self, mid: int, cmd: tuple, timeout: float | None = None):
        try:
            self._bridge_conns[mid].send(cmd)
        except (BrokenPipeError, OSError):
            raise self._bridge_dead(
                mid, f"died (command pipe closed on {cmd[0]!r})")
        kind, payload = self._bridge_recv(
            mid, timeout if timeout is not None else max(self.timeout, 60.0))
        if kind != "ok":
            raise self._bridge_dead(
                mid, f"command {cmd[0]!r} failed: {kind} {payload}")
        return payload

    def _bridges_all(self, cmd: tuple) -> None:
        """Send ``cmd`` to every local bridge, then collect every ack (a
        fence completes only when its peer fences too, so the sends go
        out before any wait)."""
        for mid in sorted(self._bridge_conns):
            self._bridge_conns[mid].send(cmd)
        for mid in sorted(self._bridge_conns):
            kind, payload = self._bridge_recv(mid, max(self.timeout, 60.0))
            if kind != "ok":
                raise self._bridge_dead(
                    mid, f"{cmd[0]} failed: {kind} {payload}")

    # ------------------------------------------------------ follower command
    def _follower_dead(self, host: str, reason: str) -> WorkerDiedError:
        mid = self._follower_mid.get(host, self.NW + self.NB)
        tail = read_log_tail(os.path.join(self._log_dir, f"launcher-{host}.log"))
        self.close()
        return WorkerDiedError(mid, reason, tail, label=f"launcher {host}")

    def _ctl_wait(self, host: str, timeout: float | None = None,
                  progress: bool = False):
        """Await one control reply from a follower; typed fault replies
        re-raise here with the fleet torn down (recovery catches them one
        frame up, exactly like a local worker fault)."""
        ctl = self._follower_ctls[host]
        deadline = (None if progress
                    else time.monotonic() + (timeout or self.timeout))
        while True:
            try:
                if ctl.poll(0.02):
                    break
            except ConnectionError:
                raise self._follower_dead(host, "control link closed")
            self._check_workers()
            if deadline is not None and time.monotonic() > deadline:
                raise self._follower_dead(
                    host, f"no control reply within {timeout or self.timeout:.0f}s")
        kind, payload = ctl.take()
        if kind == "fault":
            self.close()
            raise _fleet.decode_fault(payload, host)
        if kind == "err":
            self.close()
            raise RuntimeError(f"follower {host} command failed:\n{payload}")
        return payload

    def _ctl_send(self, host: str, op: str, *args) -> None:
        try:
            self._follower_ctls[host].send((op, *args))
        except (ConnectionError, OSError):
            raise self._follower_dead(host, f"control link closed (sending {op!r})")

    def _ctl_cmd(self, host: str, op: str, *args,
                 timeout: float | None = None, progress: bool = False):
        self._ctl_send(host, op, *args)
        return self._ctl_wait(host, timeout=timeout, progress=progress)

    @property
    def _follower_hosts(self) -> tuple:
        return tuple(h for h in (self.host_plan.hosts if self.host_plan
                                 else ()) if h != self.host)

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
            raise self._fail(WorkerDiedError(
                g, f"died with exitcode {rc} (command pipe closed)", tail
            ))

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
            how = (f"died with exitcode {rc}" if rc
                   else "exited cleanly (exitcode 0) while replies were "
                        "still pending")
            raise self._fail(WorkerDiedError(g, f"{how} (reply pipe closed)", tail))
        if kind == "fault":
            raise self._fail(_rebuild_fault(g, payload))
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
                raise self._fail(WorkerDiedError(
                    g, f"no reply within {timeout or self.timeout:.0f}s", tail
                ))
        return self._recv_raw(g)

    def _command(self, g: int, cmd: tuple, timeout: float | None = None):
        self._send(g, cmd)
        kind, payload = self._recv(g, timeout)
        if kind == "err":
            self.close()
            raise RuntimeError(f"worker {g} command {cmd[0]!r} failed:\n{payload}")
        return payload

    def _broadcast(self, cmd, progress: bool = False) -> dict:
        """Send to every worker ON THIS HOST, then collect every reply —
        the workers run the command concurrently (free-running; no barrier
        inside).  ``cmd`` is one command, or a ``{worker: command}`` dict.
        Returns ``{worker: payload}`` keyed by global worker id (the leader
        merges follower dicts on top for fleet-wide ops).

        Replies are consumed READY-FIRST, not in worker order: a typed
        fault reply (ring corruption, worker-side timeout) surfaces the
        moment it lands even while earlier-numbered workers are wedged by
        that same fault — detection latency is one poll interval, and the
        monitor's fleet-wide stall diagnosis reasons over exactly the
        still-pending set."""
        cmds = cmd if isinstance(cmd, dict) else dict.fromkeys(self._local_ws, cmd)
        for g in self._local_ws:
            self._send(g, cmds[g])
        out: dict = {}
        pending = set(self._local_ws)
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
            if self._telem_on:
                # free-running coverage: keep the telemetry rings drained
                # while the fleet runs, so a bounded ring never forces the
                # workers to drop records on long epochs-per-command runs
                self._drain_telemetry_once()
            if deadline is not None and time.monotonic() > deadline:
                g = min(pending)
                tail = read_log_tail(self._monitor.log_paths[g])
                raise self._fail(WorkerDiedError(
                    g, f"no reply within {self.timeout:.0f}s", tail
                ))
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
        # On a bridged fleet a RE-init can catch the previous run's final
        # credit still inside a TCP pipe — fence every bridge (drain +
        # pause) before reseeding, or that credit would land after the
        # reseed and double-credit its channel.
        self._fence_fleet()
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
        payloads = {}
        for w, members in enumerate(self._worker_members):
            if group_params is None:
                payloads[w] = None
            elif self._is_batch[w]:
                payloads[w] = [per_granule[g] for g in members]
            else:
                payloads[w] = [per_granule[members[0]]]
        for h in self._follower_hosts:
            self._ctl_send(h, "init", key, {w: payloads[w] for w in range(self.NW)
                                            if self._host_of_w[w] == h})
        self._broadcast({w: ("init", key, payloads[w]) for w in self._local_ws})
        for h in self._follower_hosts:
            self._ctl_wait(h, timeout=max(self.timeout, 300.0))
        self._resume_fleet()
        return ProcsState(
            cycle=np.zeros((), np.int32), epoch=np.zeros((), np.int32),
            generation=self._generation,
        )

    def _fence_fleet(self) -> None:
        """Quiesce every bridge in the fleet.  Each proxy pauses its pump,
        sends a FENCE marker, and discards inbound frames until its peer's
        marker arrives — after which BOTH TCP directions are provably
        empty.  Fence commands go out to every party (local bridges AND
        follower launchers) before any ack is collected: a proxy's fence
        completes only when its peer fences too, so acking serially would
        deadlock the handshake."""
        if self.host_plan is None or not self.is_leader or not self._launched:
            return
        gen = self._generation % 256
        for mid in sorted(self._bridge_conns):
            self._bridge_conns[mid].send(("fence", gen))
        for h in self._follower_hosts:
            self._ctl_send(h, "fence", gen)
        for mid in sorted(self._bridge_conns):
            kind, payload = self._bridge_recv(mid, max(self.timeout, 60.0))
            if kind != "ok":
                raise self._bridge_dead(mid, f"fence failed: {kind} {payload}")
        for h in self._follower_hosts:
            self._ctl_wait(h, timeout=max(self.timeout, 60.0))

    def _resume_fleet(self) -> None:
        """Un-pause every bridge after the fenced section (ring reseed /
        state restore) completes fleet-wide."""
        if self.host_plan is None or not self.is_leader or not self._launched:
            return
        for h in self._follower_hosts:
            self._ctl_send(h, "resume")
        self._bridges_all(("resume",))
        for h in self._follower_hosts:
            self._ctl_wait(h, timeout=max(self.timeout, 60.0))

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
        if self._link_faults and self.is_leader:
            # Link faults are launcher-executed at epoch boundaries (the
            # bridge pump has no epoch counter): split the run at every
            # armed fault epoch, run up to it, fire, continue.  The fault
            # then surfaces from inside the NEXT segment — a killed link
            # stalls its consumers, the monitor sees the proxy's exit, and
            # LinkDownError goes to the recovery controller like any
            # worker death.
            done = int(state.epoch)
            end = done + int(n_epochs)
            while done < end:
                pending = sorted(a.epoch for a in self._armed_link_faults()
                                 if done <= a.epoch < end)
                cut = pending[0] if pending else end
                if cut > done:
                    state = self._run_all(state, ("run", cut - done))[0]
                    done = cut
                for a in self._armed_link_faults():
                    if a.epoch <= done:
                        self._fire_link_fault(a)
            return state
        return self._run_all(state, ("run", int(n_epochs)))[0]

    def _run_all(self, state: ProcsState, cmd) -> tuple[ProcsState, dict]:
        for h in self._follower_hosts:
            self._ctl_send(h, *cmd)
        replies = self._broadcast(cmd, progress=True)
        for h in self._follower_hosts:
            replies.update(self._ctl_wait(h, progress=True))
        if self._telem_on:
            self._drain_telemetry_once()
            self._drain_followers()
        epochs = {w: (r[0] if isinstance(r, tuple) else r) for w, r in replies.items()}
        done = next(iter(epochs.values()))
        if any(e != done for e in epochs.values()):
            raise RuntimeError(f"workers disagree on the epoch count: {epochs}")
        return state.replace(cycle=np.int32(done * self.cycles_per_epoch),
                             epoch=np.int32(done)), replies

    def _armed_link_faults(self):
        return tuple(a for a in self._link_faults
                     if a.restart == self._incarnation
                     and (a.kind, a.worker, a.epoch, a.restart)
                     not in self._fired_links)

    def _fire_link_fault(self, a) -> None:
        """Execute one armed link fault.  ``a.worker`` is a bridge LINK
        index; the fault routes to a host incident to that link — local
        side preferred, else over the control link to the accept host (for
        ``linkcorrupt``, to a side that actually SENDS slabs, since the
        corruption flips a byte in the next outbound slab frame)."""
        self._fired_links.add((a.kind, a.worker, a.epoch, a.restart))
        REGISTRY.inc("faults.injected")
        _trace.instant("fault_injected", cat="fault",
                       args={"kind": a.kind, "link": int(a.worker),
                             "incarnation": int(self._incarnation)})
        lk = self._links[int(a.worker)]
        mid = self._bridge_ids.get(lk.link)
        local = mid is not None and mid in self._bridge_conns
        if a.kind == "linkkill":
            if local:
                self._bridge_procs[mid].kill()
            else:
                self._ctl_cmd(lk.accept, "linkfault", "linkkill", lk.link, None)
        elif a.kind == "linkslow":
            secs = float(a.arg) if a.arg is not None else 0.05
            if local:
                self._bridge_cmd(mid, ("slow", secs))
            else:
                self._ctl_cmd(lk.accept, "linkfault", "linkslow", lk.link, secs)
        elif a.kind == "linkcorrupt":
            tx_hosts = sorted({sh for (_c, sh) in lk.chans})
            if local and self.host in tx_hosts:
                self._bridge_cmd(mid, ("corrupt",))
            else:
                self._ctl_cmd(tx_hosts[0], "linkfault", "linkcorrupt", lk.link, None)

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

    def _fleet_broadcast(self, cmd: tuple, op: str, *args) -> dict:
        """``cmd`` on every worker of the fleet: the local ones directly,
        a follower's through its control link (``op``).  ``{worker:
        payload}`` over all hosts."""
        for h in self._follower_hosts:
            self._ctl_send(h, op, *args)
        out = self._broadcast(cmd)
        for h in self._follower_hosts:
            out.update(self._ctl_wait(h, timeout=max(self.timeout, 60.0)))
        return out

    def _views(self) -> list:
        """Per-GRANULE state views in granule order, numpy leaves (batched
        workers reply with the stacked batch; each member's row is sliced
        back out).  The leaves are views of the workers' bulk segments —
        a follower's workers' too, attached at rendezvous — valid until
        the next command."""
        out: list = [None] * self.G
        for w, slots in self._fleet_broadcast(("view",), "views").items():
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
        h = self._host_of_w[w]
        if self.host_plan is not None and h != self.host:
            got = self._ctl_cmd(h, "probe", w, gi, slot, self._row_of[g])
        else:
            got = self._command(w, ("probe", gi, slot, self._row_of[g]))
        return _cpu_tensors(got)

    def gather_group(self, state: ProcsState, gi: int) -> Tree:
        """Group ``gi``'s member states in global instantiation order
        (numpy leaves)."""
        self._require(state)
        views = self._views()
        gran = np.asarray(self.lowering.member_granule[gi])
        slot = np.asarray(self.lowering.member_slot[gi])
        # one gather a granule, not one a member: a member's row is its
        # granule's leaf at its slot
        rows = {int(g): (gran == g, slot[gran == g]) for g in np.unique(gran)}

        def pick(*leaves):
            if not len(gran):
                return np.zeros((0,))
            first = leaves[int(gran[0])]
            out = np.empty((len(gran),) + first.shape[1:], first.dtype)
            for g, (where, at) in rows.items():
                out[where] = leaves[g][at]
            return out

        return tree_map(pick, *[v.block_states[gi] for v in views])

    def worker_stats(self, state: ProcsState | None = None) -> list[dict]:
        """One record per GRANULE (batched workers reply with a list, one
        per batch row — flattened here so the schema is engine-invariant)."""
        if state is not None:
            self._require(state)
        out: list[dict] = []
        for w, payload in sorted(self._fleet_broadcast(("stats",), "wstats").items()):
            out.extend(payload if isinstance(payload, list) else [payload])
        if self._telem_on:
            self._drain_telemetry_once()
        return out

    # ------------------------------------------------------ flight recorder
    def set_tracing(self, on: bool) -> bool:
        """Toggle per-worker phase telemetry fleet-wide (``obs.telemetry``).
        Pre-launch calls are remembered and applied by ``launch()``; a
        recovery respawn re-applies the setting to the new incarnation."""
        self._telem_on = bool(on)
        if self._launched and not self._closed:
            self._apply_tracing()
            if not self._telem_on:
                self._drain_telemetry_once(force=True)
        return self._telem_on

    def _apply_tracing(self) -> None:
        on = self._telem_on
        for h in self._follower_hosts:
            self._ctl_cmd(h, "telemetry", on)
        self._broadcast(("telemetry", on))

    def _is_telem_sink(self) -> bool:
        """Only the leader (or a single-host engine) folds records into
        the process-global recorder/registry — a follower ships its raw
        records to the leader via the ``obs_drain`` control op instead."""
        return self.host_plan is None or self.is_leader

    def _drain_telemetry_once(self, force: bool = False) -> None:
        """Pop every pending local telemetry record into the trace
        recorder and metrics registry (cheap no-op when nothing pends)."""
        if not (self._is_telem_sink() or force):
            return
        for w, name in sorted(self._telem_names.items()):
            ring = self._rings.get(name)
            if ring is not None:
                self._fold_records(w, _telem.drain(ring), pid=0,
                                   host=self.host or "local")

    def _fold_records(self, w: int, records, *, pid: int, host: str) -> None:
        if records.shape[0] == 0:
            return
        rec = _trace.recorder()
        key = (int(pid), int(w))
        if key not in self._telem_tracked:
            self._telem_tracked.add(key)
            rec.set_process(pid, f"procs:{host}")
            rec.set_track(pid, int(w), f"worker {w}")
        _telem.records_to_events(records, worker=int(w), pid=pid,
                                 recorder=rec, registry=REGISTRY)

    def _drain_followers(self) -> None:
        """Pull follower hosts' raw telemetry records over the control
        links and fold them in under their host's trace pid."""
        if self.host_plan is None or not self.is_leader:
            return
        for i, h in enumerate(self._follower_hosts):
            got = self._ctl_cmd(h, "obs_drain")
            for w in sorted(got):
                rows = np.asarray(got[w], np.float64).reshape(
                    -1, _telem.TELEM_RECORD_F64)
                self._fold_records(w, rows, pid=1 + i, host=h)

    def flush_telemetry(self) -> None:
        """Drain every host's telemetry rings into the recorder/registry —
        the trace-export path (``Simulation.trace`` exit, ``REPRO_TRACE``
        atexit).  Also folds bridge counters in as one track per proxy."""
        if not self._launched or self._closed:
            return
        self._drain_telemetry_once()
        self._drain_followers()
        rec = _trace.recorder()
        for i, row in enumerate(self.bridge_stats()):
            link, role = int(row.get("link", i)), row.get("role", "x")
            REGISTRY.set(f"bridge.l{link}.{role}.bytes_tx", float(row.get("bytes_tx", 0)))
            REGISTRY.set(f"bridge.l{link}.{role}.bytes_rx", float(row.get("bytes_rx", 0)))
            if rec.enabled:
                tid = self.NW + i
                rec.set_track(0, tid, f"bridge {link} ({row.get('host', '?')})")
                rec.instant("bridge_counters", pid=0, tid=tid, cat="bridge",
                            args={k: v for k, v in row.items()
                                  if isinstance(v, (int, float, str))})

    def port_stats(self, state: ProcsState) -> dict[str, dict]:
        """Per external port: shm-ring occupancy (packets the host can pop /
        has parked) plus the owning worker's device-queue occupancy — the
        uniform ``Simulation.stats()["ports"]`` schema."""
        self._require(state)
        remote_ext: dict[str, tuple] = {}
        for h in self._follower_hosts:
            remote_ext.update(self._ctl_cmd(h, "ext_state"))
        wstats = {s["granule"]: s for s in self.worker_stats()}

        def rec(cid, name, is_in):
            rname = ext_ring_name(self._ring_prefix, cid)
            if rname in self._rings:
                size, free = self._rings[rname].size(), self._rings[rname].free()
            else:  # port homed on a follower host
                size, free = remote_ext[name]
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

    def _ext_remote(self, table: dict, name: str):
        """The follower host owning this external port's ring, or None if
        the port is local (the leader forwards host I/O over the control
        link so PySbTx/PySbRx keep working on a sharded fleet)."""
        if name not in table:
            raise KeyError(name)
        if self.host_plan is None:
            return None
        h = self._ext_home_host(table[name])
        return None if h == self.host else h

    def _ext_push_raw(self, name: str, arr: np.ndarray) -> int:
        """Push packets into an external ingress ring, local or follower-
        homed — no recovery bookkeeping (the controller's replay path
        uses this directly)."""
        h = self._ext_remote(self.graph.ext_in, name)
        if h is not None:
            return int(self._ctl_cmd(h, "ext_push", name, arr))
        return int(self._ext_ring(self.graph.ext_in, name).push_packets(arr))

    def _ext_pop_raw(self, name: str, max_n: int) -> np.ndarray:
        h = self._ext_remote(self.graph.ext_out, name)
        if h is not None:
            return self._ctl_cmd(h, "ext_pop", name, max_n)
        return self._ext_ring(self.graph.ext_out, name).pop_packets(
            max_n, self.dtype, self.W)

    def _payloads(self, payload) -> np.ndarray:
        if isinstance(payload, torch.Tensor):
            payload = payload.detach().cpu().numpy()
        return np.asarray(payload, self.dtype).reshape(-1, self.W)

    def _ext_pop_host(self, state: ProcsState, name: str, max_n: int) -> np.ndarray:
        """Host-facing pop: raw ring pops are journaled for recovery, and
        packets a replay regenerated that the host already received
        before the rewind are silently dropped (exactly-once delivery)."""
        skip = int(self._ext_discard.get(name, 0))
        got = self._ext_pop_raw(name, int(max_n) + skip)
        if len(got):
            self._recovery.note_ext_pop(state, name, len(got))
        if skip:
            dropped = min(skip, len(got))
            self._ext_discard[name] = skip - dropped
            got = got[dropped:]
        return got

    # recovery hooks: exactly-once host delivery across a rewind
    def _replay_ext_push(self, name: str, batch) -> None:
        self._ext_push_raw(name, np.asarray(batch, self.dtype).reshape(-1, self.W))

    def _set_ext_discard(self, discards: dict) -> None:
        self._ext_discard = {k: int(v) for k, v in discards.items() if v}

    def _ext_discard_state(self) -> dict:
        return {k: v for k, v in self._ext_discard.items() if v}

    def host_push(self, state: ProcsState, name: str, payload):
        state = self._require(state)
        arr = self._payloads(payload)[:1]
        n = self._ext_push_raw(name, arr)
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
        n = self._ext_push_raw(name, arr)
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
        for h in self._follower_hosts:
            self._ctl_send(h, "gather")
        tree = self._gather_local()
        for h in self._follower_hosts:
            remote = self._ctl_wait(h, timeout=max(self.timeout, 60.0))
            for k in ("slots", "credits", "ext"):
                tree[k].update(remote[k])
        workers: dict[str, Any] = {}
        for w, slots in tree["slots"].items():
            tree_w = read_bulk(self._bulk[w].buf, slots, copy=True)
            for r, g in enumerate(self._worker_members[w]):
                workers[f"g{g}"] = (tree_map(lambda x: x[r], tree_w)
                                    if self._is_batch[w] else tree_w)
        missing = [g for g in range(self.G) if f"g{g}" not in workers]
        if missing:
            raise AssertionError(f"gather missing granules {missing}")
        # every dict in key order: the reference's tree flattens so
        return {
            "credits": dict(sorted(tree["credits"].items())),
            "cycle": np.asarray(state.cycle),
            "epoch": np.asarray(state.epoch),
            "ext": dict(sorted(tree["ext"].items())),
            "workers": dict(sorted(workers.items())),
        }

    def _gather_local(self) -> dict:
        """This host's contribution to the fleet checkpoint: its workers'
        bulk records (``{worker: slots}``), the resting credit of every
        channel whose SENDER lives here (the credit's home at quiesce),
        and its external rings."""
        slots = self._broadcast(("gather",))
        credits = {}
        for _t, c in self._local_chans():
            if self.host_plan is not None and self._chan_hosts[c][0] != self.host:
                continue  # rx side of a cross-host channel: the tx host
                #           accounts its resting credit
            ring = self._rings[credit_ring_name(self._ring_prefix, c)]
            if self.host_plan is not None and len(set(self._chan_hosts[c])) > 1:
                self._await_credit(c, ring)
            snap = ring.snapshot()
            # at a command boundary exactly one credit is in flight
            if len(snap) != 1:
                raise AssertionError(
                    f"channel {c} holds {len(snap)} credits at a boundary")
            credits[f"c{c}"] = snap[0].copy()
        return {"slots": slots, "credits": credits, "ext": self._gather_ext_local()}

    def _await_credit(self, c: int, ring: ShmRing) -> None:
        """A cross-host channel's resting credit can still be in TCP
        flight at the command boundary (the receiver pushed it; the bridge
        pair is forwarding it home).  Poll the tx-side credit ring until
        it lands — a link that never delivers it raises RingTimeout, a
        RECOVERABLE fault (the recovery controller restores from the last
        coordinated snapshot)."""
        deadline = time.monotonic() + max(self.timeout, 10.0)
        while ring.size() != 1:
            self._check_workers()
            if time.monotonic() > deadline:
                raise self._fail(RingTimeout(
                    f"cross-host credit for channel {c} never arrived "
                    f"within {max(self.timeout, 10.0):.0f}s — link down "
                    "or bridge wedged"))
            time.sleep(0.002)

    def _gather_ext(self) -> dict:
        """FLEET-WIDE external-ring snapshot by port name in key order —
        the recovery controller's ext-dirty refresh hook.  Follower-homed
        ports ride along over the control links."""
        ext = {}
        if self.host_plan is not None and self.is_leader:
            for h in self._follower_hosts:
                ext.update(self._ctl_cmd(h, "ext_gather"))
        ext.update(self._gather_ext_local())
        return dict(sorted(ext.items()))

    def _gather_ext_local(self) -> dict:
        """THIS host's external rings' resident packets + seq counters.
        Checked rings snapshot WITH their headers, and the (producer,
        consumer) sequence counters ride along so a restore into a FRESH
        segment resumes the exact seq timeline."""
        ext = {}
        for name, (cid, is_in) in self.graph.ext_ports().items():
            rname = ext_ring_name(self._ring_prefix, cid)
            if rname not in self._rings:
                continue  # port homed on another host
            ring = self._rings[rname]
            snap = ring.snapshot()
            buf = np.zeros((self.capacity - 1, ring.stride), np.uint8)
            buf[: len(snap)] = snap
            ext[name] = {"buf": buf, "count": np.int32(len(snap)),
                         "seq": np.asarray(ring.seq_state(), np.int64)}
        return ext

    def scatter_state(self, state: ProcsState, tree: Tree) -> ProcsState:
        """Restore a ``gather_state`` tree into the running fleet: credits
        and external rings restored, data rings emptied, every worker's
        granules scattered (a follower's written into its workers' bulk
        segments here, its rings restored over the control link).  On a
        bridged fleet the restore runs inside a fence: restoring rings
        while a bridge pumps — or with a stale credit still in TCP flight
        — would corrupt the credit protocol."""
        state = self._require(state)
        self._recovery.note_scatter()
        tree = tree_map(lambda x: x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x), tree)
        slots = {}
        for w, members in enumerate(self._worker_members):
            rows = [tree["workers"][f"g{g}"] for g in members]
            payload = (tree_map(lambda *xs: np.stack(xs), *rows)
                       if self._is_batch[w] else rows[0])
            slots[w] = write_bulk(self._bulk[w].buf, payload)
        rings = {k: tree[k] for k in ("credits", "ext", "epoch")}
        self._fence_fleet()
        for h in self._follower_hosts:
            self._ctl_send(h, "scatter", rings, {w: slots[w] for w in range(self.NW)
                                                 if self._host_of_w[w] == h})
        self._scatter_local(rings, slots)
        for h in self._follower_hosts:
            self._ctl_wait(h, timeout=max(self.timeout, 300.0))
        self._resume_fleet()
        return state.replace(
            cycle=np.int32(np.asarray(tree["cycle"]).ravel()[0]),
            epoch=np.int32(np.asarray(tree["epoch"]).ravel()[0]),
        )

    def _scatter_local(self, tree: dict, slots: dict) -> None:
        """This host's share of a fleet-wide restore: credits land on each
        channel's tx host (the rx side of a cross-host channel resets to
        empty — its resting credit lives at the sender), every local data
        ring resets, local external rings restore, local workers load the
        bulk records ``slots`` names."""
        for _t, c in self._local_chans():
            ring = self._rings[credit_ring_name(self._ring_prefix, c)]
            if self.host_plan is None or self._chan_hosts[c][0] == self.host:
                ring.restore(np.asarray(tree["credits"][f"c{c}"])[None])
            else:
                ring.reset()
            self._rings[data_ring_name(self._ring_prefix, c)].reset()
        for name, (cid, is_in) in self.graph.ext_ports().items():
            rname = ext_ring_name(self._ring_prefix, cid)
            if rname not in self._rings:
                continue
            rec = tree["ext"][name]
            seq = tuple(int(x) for x in np.asarray(rec["seq"]).ravel())
            self._rings[rname].restore(np.asarray(rec["buf"])[: int(rec["count"])],
                                       seq=seq)
        epoch = int(np.asarray(tree["epoch"]).ravel()[0])
        self._broadcast({w: ("scatter", slots[w], epoch) for w in self._local_ws})

    # ------------------------------------------------------- bridge surface
    def bridge_stats(self) -> list[dict]:
        """One counter row per live bridge proxy, fleet-wide (leader) —
        ``Simulation.stats()["bridges"]``.  Empty on a single-host engine.
        Dead proxies and unreachable followers are skipped, not raised:
        stats must stay callable mid-fault."""
        if self.host_plan is None or not self._launched or self._closed:
            return []
        rows = self._local_bridge_stats()
        if self.is_leader:
            for h in self._follower_hosts:
                ctl = self._follower_ctls.get(h)
                p = self._follower_procs.get(h)
                if ctl is None or (p is not None and p.exitcode is not None):
                    continue
                try:
                    ctl.send(("bridge_stats",))
                    deadline = time.monotonic() + 10.0
                    msg = None
                    while msg is None:
                        ctl.poll(0.02)
                        msg = ctl.peek()
                        if msg is None and time.monotonic() > deadline:
                            break
                    # a pending typed fault stays queued for _check_workers
                    if msg is not None and msg[0] == "ok":
                        ctl.take()
                        rows.extend(msg[1])
                except (ConnectionError, OSError):
                    continue
        rows.sort(key=lambda r: (r["link"], r["host"]))
        return rows

    def _local_bridge_stats(self) -> list[dict]:
        rows = []
        for mid in sorted(self._bridge_conns):
            p = self._bridge_procs.get(mid)
            if p is None or p.exitcode is not None:
                continue
            conn = self._bridge_conns[mid]
            try:
                conn.send(("stats",))
                deadline = time.monotonic() + 5.0
                while not conn.poll(0.02):
                    if time.monotonic() > deadline or p.exitcode is not None:
                        raise TimeoutError
                kind, payload = conn.recv()
            except (TimeoutError, EOFError, OSError):
                continue
            if kind == "ok" and payload is not None:
                rows.append(payload)
        return rows

    # ------------------------------------------- follower control dispatch
    def _fleet_dispatch(self, op: str, args: tuple):
        """Serve one leader control command on a FOLLOWER launcher (called
        from ``fleet.follower_entry``).  Faults raised here are encoded and
        shipped back typed — the leader re-raises them as if local.  Bulk
        records stay in this host's workers' segments: the replies carry
        their slots."""
        if op == "run":
            return self._broadcast(("run", *args), progress=True)
        if op == "init":
            key, payloads = args
            self._generation += 1
            self._recovery.note_reset()
            for ring in self._rings.values():
                ring.reset()
            self._seed_credit_rings()
            self._broadcast({w: ("init", key, payloads.get(w)) for w in self._local_ws})
            return True
        if op == "fence":
            (gen,) = args
            self._bridges_all(("fence", int(gen)))
            return True
        if op == "resume":
            self._bridges_all(("resume",))
            return True
        if op == "gather":
            return self._gather_local()
        if op == "scatter":
            tree, slots = args
            self._scatter_local(tree, slots)
            return True
        if op == "views":
            return self._broadcast(("view",))
        if op == "probe":
            w, gi, slot, row = args
            return self._command(w, ("probe", gi, slot, row))
        if op == "wstats":
            return self._broadcast(("stats",))
        if op == "ext_state":
            out = {}
            for name, (cid, is_in) in self.graph.ext_ports().items():
                rname = ext_ring_name(self._ring_prefix, cid)
                if rname in self._rings:
                    r = self._rings[rname]
                    out[name] = (r.size(), r.free())
            return out
        if op == "ext_gather":
            return self._gather_ext_local()
        if op == "ext_push":
            name, arr = args
            return int(self._ext_ring(self.graph.ext_in, name)
                       .push_packets(np.asarray(arr)))
        if op == "ext_pop":
            name, n = args
            return self._ext_ring(self.graph.ext_out, name).pop_packets(
                int(n), self.dtype, self.W)
        if op == "bridge_stats":
            return self._local_bridge_stats()
        if op == "telemetry":
            (on,) = args
            self._telem_on = bool(on)
            self._broadcast(("telemetry", bool(on)))
            return True
        if op == "obs_drain":
            # ship raw per-worker records to the leader (the only sink)
            out = {}
            for w, name in sorted(self._telem_names.items()):
                ring = self._rings.get(name)
                if ring is None:
                    continue
                rows = _telem.drain(ring)
                if rows.shape[0]:
                    out[w] = rows
            return out
        if op == "linkfault":
            kind, link, arg = args
            mid = self._bridge_ids[int(link)]
            if kind == "linkkill":
                self._bridge_procs[mid].kill()
            elif kind == "linkslow":
                self._bridge_cmd(mid, ("slow", float(arg)))
            elif kind == "linkcorrupt":
                self._bridge_cmd(mid, ("corrupt",))
            else:
                raise RuntimeError(f"unknown link fault {kind!r}")
            return True
        raise RuntimeError(f"unknown fleet control op {op!r}")

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
