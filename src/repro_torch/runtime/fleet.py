"""Multi-host fleet runtime: host placement, rendezvous, control links,
as in ``repro.runtime.fleet``.

Shards a procs fleet across N *launcher* processes ("hosts") whose
workers' traffic crosses hosts only over TCP — the paper's multi-machine
deployment (§III-B), run on one machine over loopback so the tests
exercise the real wire path.  The pieces:

  * ``HostPlan`` — assigns each partition-tree granule to a named host.
    Placement is by contiguous granule ranges by default (``auto``), so
    host cuts land on partition-subtree boundaries and the number of
    cross-host channels stays small.
  * ``Link``/``build_links`` — one TCP link per host pair with boundary
    traffic, carrying ALL that pair's channels (``runtime.bridge`` pairs
    the per-channel shm rings over it).  Accept side = lower plan-order
    host; link ids are deterministic (plan order + channel ids), so every
    host derives the SAME link map independently — rendezvous only has to
    exchange ports, never topology.
  * Rendezvous — the leader (plan host 0) binds ONE control listener;
    follower launchers dial it and send a hello carrying their accept-
    side bridge ports; the leader aggregates the full ``link -> (addr,
    port)`` map and broadcasts it; dial-side bridges connect directly
    (worker traffic never transits the control link).  A per-incarnation
    token rides every hello/HELLO so a stale process from a previous
    incarnation can never splice into a re-rendezvoused fleet.
  * ``follower_entry`` — a follower IS a full ``ProcsEngine`` (same
    lowering, same rings, same monitor) restricted to its host's
    granules, serving the leader's control protocol: one pickled frame
    per engine op (init / run / gather / scatter / probe / stats / ext
    I/O), with typed ``("fault", ...)`` replies so a follower-side
    ``WorkerDiedError``/``RingCorruptionError`` re-raises ON THE LEADER
    and routes into the ordinary recovery path (cross-host recovery:
    teardown, re-rendezvous, restore, replay — ``runtime.recovery``).

Two things travel in shared memory instead of over the control link,
as a worker's spec and its bulk records already do on one host (a pipe
on the card's machine moves ~10 MB/s, ``scripts/torch_host_transport.py``):
the follower's build blob (the pickled graph, partition and engine
arguments: 54.5 MB at wafer-1M), named in ``FollowerBoot.build``, and the
bulk records of the control protocol (views, gathers, scatters: ~0.5 GB
a host at wafer-1M), which the leader reads from and writes into the
follower's workers' own bulk segments, named in the follower's hello.
So the fleet's hosts share one machine's ``/dev/shm``; the boundary
traffic between their workers crosses only the TCP bridges.

Env knobs: ``REPRO_HOSTS`` (host count ``"2"`` or names ``"a,b"``) and
``REPRO_BRIDGE_PORT`` (base port for deterministic bridge ports;
0/unset = ephemeral).  Explicit constructor args win over env.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import select
import socket
import sys
import time
import traceback

import numpy as np

from .fault_tolerance import FleetStallError, LinkDownError, WorkerDiedError


# ------------------------------------------------------------- host plans
@dataclasses.dataclass(frozen=True)
class HostPlan:
    """Granule -> host placement.  ``hosts[0]`` is the leader (it owns the
    user-facing engine object, the control listener, and ext-port I/O
    fan-out); the rest are follower launchers."""

    hosts: tuple
    assignment: tuple  # granule index -> host name

    @property
    def leader(self) -> str:
        return self.hosts[0]

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def host_of(self, g: int) -> str:
        return self.assignment[g]

    def index(self, host: str) -> int:
        return self.hosts.index(host)

    def granules_of(self, host: str) -> tuple:
        return tuple(g for g, h in enumerate(self.assignment) if h == host)

    @classmethod
    def auto(cls, hosts, n_granules: int) -> "HostPlan":
        """Contiguous equal split of granule ids over ``hosts`` (granule
        order follows the partition tree, so contiguous ranges hug
        subtree boundaries and minimise cross-host channels)."""
        hosts = tuple(hosts)
        if len(hosts) > n_granules:
            raise ValueError(
                f"host plan has {len(hosts)} hosts but the partition only "
                f"has {n_granules} granule(s)")
        chunks = np.array_split(np.arange(n_granules), len(hosts))
        assignment = [None] * n_granules
        for h, chunk in zip(hosts, chunks):
            for g in chunk:
                assignment[int(g)] = h
        return cls(hosts, tuple(assignment))

    def validate(self, n_granules: int) -> None:
        if len(self.assignment) != n_granules:
            raise ValueError(
                f"host plan assigns {len(self.assignment)} granule(s) but "
                f"the partition has {n_granules}")
        if len(set(self.hosts)) != len(self.hosts):
            raise ValueError(f"duplicate host names in plan: {self.hosts}")
        stray = sorted(set(self.assignment) - set(self.hosts))
        if stray:
            raise ValueError(f"granules assigned to unknown host(s) {stray}; "
                             f"plan hosts are {self.hosts}")
        for h in self.hosts:
            if h not in self.assignment:
                raise ValueError(f"host {h!r} has no granules assigned")


def resolve_host_plan(hosts, n_granules: int):
    """Constructor arg / ``REPRO_HOSTS`` env -> ``HostPlan`` or None.

    Accepts: None (env, else single-host), an int or digit-string host
    count (auto names ``h0..hN-1``), a comma list of names, a sequence of
    names, a ``{host: [granule, ...]}`` dict, or a ready ``HostPlan``.
    A count of 1 resolves to None — the plain single-host engine."""
    if hosts is None:
        hosts = os.environ.get("REPRO_HOSTS", "").strip() or None
        if hosts is None:
            return None
    if isinstance(hosts, HostPlan):
        plan = hosts
    elif isinstance(hosts, dict):
        names = tuple(hosts)
        assignment = [None] * n_granules
        for h, gs in hosts.items():
            for g in gs:
                if not (0 <= int(g) < n_granules):
                    raise ValueError(f"host {h!r} assigned granule {g}, but "
                                     f"the partition has {n_granules}")
                assignment[int(g)] = h
        missing = [g for g, h in enumerate(assignment) if h is None]
        if missing:
            raise ValueError(f"granule(s) {missing} not assigned to any host")
        plan = HostPlan(names, tuple(assignment))
    else:
        if isinstance(hosts, str):
            hosts = (int(hosts) if hosts.isdigit()
                     else tuple(s.strip() for s in hosts.split(",")
                                if s.strip()))
        if isinstance(hosts, int):
            if hosts <= 1:
                return None
            hosts = tuple(f"h{i}" for i in range(hosts))
        plan = HostPlan.auto(tuple(hosts), n_granules)
    if plan.n_hosts <= 1:
        return None
    plan.validate(n_granules)
    return plan


def resolve_base_port(port) -> int:
    """Explicit arg > ``REPRO_BRIDGE_PORT`` env > 0 (ephemeral)."""
    if port is not None:
        return int(port)
    return int(os.environ.get("REPRO_BRIDGE_PORT", "0") or 0)


# ------------------------------------------------------------------ links
@dataclasses.dataclass(frozen=True)
class Link:
    """One TCP link between a host pair, carrying every boundary channel
    whose endpoints straddle that pair.  ``chans`` is a tuple of
    ``(chan, src_host)`` sorted by channel id."""

    link: int
    accept: str   # lower plan-order host: binds the listener
    dial: str
    chans: tuple

    @property
    def label(self) -> str:
        return f"link{self.link}:{self.accept}<->{self.dial}"

    def peer_of(self, host: str) -> str:
        return self.dial if host == self.accept else self.accept


def build_links(plan: HostPlan, chan_hosts: dict) -> tuple:
    """Deterministic link map from ``chan -> (src_host, dst_host)``.

    Every host computes this independently from the (deterministic)
    lowering + plan, so rendezvous only exchanges ports."""
    order = {h: i for i, h in enumerate(plan.hosts)}
    pairs: dict = {}
    for c, (sh, dh) in sorted(chan_hosts.items()):
        if sh == dh:
            continue
        a, b = sorted((sh, dh), key=order.__getitem__)
        pairs.setdefault((a, b), []).append((c, sh))
    links = []
    for i, (a, b) in enumerate(sorted(pairs, key=lambda p: (order[p[0]],
                                                            order[p[1]]))):
        links.append(Link(i, a, b, tuple(sorted(pairs[(a, b)]))))
    return tuple(links)


# --------------------------------------------------------- control links
class CtlConn:
    """Framed pickled control messages over a fleet TCP socket.

    One message per frame (``bridge.FLAVOR_CTL``); ``poll`` lets the
    leader watch for early ``("fault", ...)`` frames from a follower
    while it is blocked on something else."""

    def __init__(self, sock: socket.socket):
        from .bridge import FrameReader

        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setblocking(False)
        self.sock = sock
        self._reader = FrameReader()
        self._msgs: list = []

    def fileno(self) -> int:
        return self.sock.fileno()

    def send(self, obj) -> None:
        data = pickle.dumps(obj)
        from .bridge import _FRAME, FLAVOR_CTL

        hdr = _FRAME.pack(FLAVOR_CTL, 0, 0, len(data))
        self.sock.setblocking(True)
        try:
            self.sock.sendall(hdr + data)
        finally:
            self.sock.setblocking(False)

    def _pump(self, timeout: float) -> None:
        r, _, _ = select.select([self.sock], [], [], timeout)
        if not r:
            return
        try:
            data = self.sock.recv(1 << 16)
        except BlockingIOError:
            return
        if not data:
            raise ConnectionError("control link closed by peer")
        self._reader.feed(data)
        while True:
            f = self._reader.next_frame()
            if f is None:
                break
            self._msgs.append(pickle.loads(f[3]))

    def poll(self, timeout: float = 0.0) -> bool:
        if not self._msgs:
            self._pump(timeout)
        return bool(self._msgs)

    def peek(self):
        """First buffered message without consuming it (None if none) —
        the leader's early-fault probe."""
        if not self._msgs:
            self._pump(0.0)
        return self._msgs[0] if self._msgs else None

    def take(self):
        """Consume the first buffered message (must exist — pair with
        ``poll``/``peek``)."""
        return self._msgs.pop(0)

    def recv(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._msgs:
            remain = 0.2 if deadline is None else deadline - time.monotonic()
            if remain <= 0:
                raise TimeoutError("no control message within "
                                   f"{timeout}s")
            self._pump(min(remain, 0.2))
        return self._msgs.pop(0)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def accept_followers(listener: socket.socket, expected: tuple, token: str,
                     timeout: float, on_wait=None) -> dict:
    """Leader side of rendezvous: accept one hello per expected follower
    host, verify the incarnation token, return
    ``{host: (CtlConn, accept_ports)}``.  ``on_wait`` runs each poll tick
    (the leader uses it to notice a follower that died before dialing)."""
    conns: dict = {}
    deadline = time.monotonic() + timeout
    while len(conns) < len(expected):
        if on_wait is not None:
            on_wait()
        r, _, _ = select.select([listener], [], [], 0.2)
        if not r:
            if time.monotonic() > deadline:
                missing = sorted(set(expected) - set(conns))
                raise TimeoutError(
                    f"follower host(s) {missing} never dialed the fleet "
                    f"control listener within {timeout:.0f}s")
            continue
        sock, _ = listener.accept()
        ctl = CtlConn(sock)
        op, payload = ctl.recv(timeout=30.0)
        if (op != "hello" or payload.get("token") != token
                or payload.get("host") not in expected):
            ctl.close()  # stale incarnation or stranger: refuse
            continue
        conns[payload["host"]] = (ctl, payload.get("accept_ports", {}),
                                  payload)
    return conns


# ------------------------------------------------------------ fault codec
def encode_fault(exc: BaseException) -> dict:
    """Typed fault payload for the control link (mirrors the worker pipe
    protocol, extended with the monitor's exception types)."""
    from .shmem import RingCorruptionError

    d = {"type": type(exc).__name__, "message": str(exc)}
    if isinstance(exc, WorkerDiedError):
        d.update(worker=exc.worker, reason=exc.reason,
                 log_tail=exc.log_tail, label=exc.label)
    elif isinstance(exc, FleetStallError):
        d.update(cycle=exc.cycle, details=exc.details)
    elif isinstance(exc, RingCorruptionError):
        d.update(args=exc.to_payload())
    return d


def decode_fault(d: dict, host: str = "") -> Exception:
    """Rebuild a follower's fault so it raises ON THE LEADER with the same
    type (recovery policy keys on isinstance) and a host-tagged label."""
    from .shmem import RingCorruptionError, RingTimeout

    t = d.get("type")
    label = d.get("label")
    if host and label:
        label = f"{label} [host {host}]"
    if t == "LinkDownError":
        return LinkDownError(d["worker"], d["reason"],
                             d.get("log_tail", ""), label=label)
    if t == "WorkerDiedError":
        return WorkerDiedError(d["worker"], d["reason"],
                               d.get("log_tail", ""), label=label)
    if t == "FleetStallError":
        return FleetStallError(d["cycle"], d["details"])
    if t == "RingCorruptionError":
        return RingCorruptionError(**d["args"])
    if t == "RingTimeout":
        return RingTimeout(d.get("message", "ring timeout on follower"))
    msg = d.get("message", "")
    return RuntimeError(f"follower {host or '?'} fault {t}: {msg}")


# -------------------------------------------------------------- followers
@dataclasses.dataclass(frozen=True)
class FollowerBoot:
    """Spawn args for one follower launcher process (picklable)."""

    host: str
    leader_addr: tuple        # ("127.0.0.1", ctl_port)
    token: str
    build: str                # shm segment: pickled (graph, partition, kwargs)
    timeout: float
    incarnation: int = 0      # leader's restart count (arms :r<N> faults)


def follower_entry(boot_pickle: bytes, log_path: str | None) -> None:
    """Follower launcher process entry: dial the leader, build the
    host-local ``ProcsEngine`` (same graph, same lowering, restricted to
    this host's granules), rendezvous the bridges, then serve the control
    protocol until "exit".  Any local fleet fault travels to the leader
    as a typed ``("fault", ...)`` frame; the follower then parks until
    the leader tears the incarnation down."""
    boot: FollowerBoot = pickle.loads(boot_pickle)
    if log_path:
        f = open(log_path, "a", buffering=1)
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        sys.stdout = os.fdopen(1, "w", buffering=1)
        sys.stderr = os.fdopen(2, "w", buffering=1)
    print(f"[follower {boot.host}] dialing leader {boot.leader_addr}",
          flush=True)
    from .bridge import connect_retry

    ctl = None
    engine = None
    try:
        ctl = CtlConn(connect_retry(tuple(boot.leader_addr),
                                    max(boot.timeout, 300.0)))
        from .launcher import ProcsEngine, helper_pids
        from .shmem import attach_shared_memory

        t0 = time.perf_counter()

        seg = attach_shared_memory(boot.build)
        try:
            graph, partition, kwargs = pickle.loads(seg.buf)
        finally:
            seg.close()
        if log_path:
            # this host's workers and bridges log beside its launcher
            kwargs["log_dir"] = os.path.join(os.path.dirname(log_path),
                                             f"host-{boot.host}")
            os.makedirs(kwargs["log_dir"], exist_ok=True)
        engine = ProcsEngine(graph, partition, host=boot.host, **kwargs)
        engine.launch_stats["blob_read_seconds"] = time.perf_counter() - t0
        # a local fault reaches the leader BEFORE this host tears its end
        # of the links down (the leader would see the collateral bridge
        # death first otherwise)
        engine._fault_report = lambda exc: ctl.send(("fault", encode_fault(exc)))
        # the leader's restart count arms incarnation-scoped (:r<N>) fault
        # actions identically on every host — set before any worker spawns;
        # same for the incarnation token the bridges' HELLO handshake
        # verifies (every host must present the LEADER's token)
        engine._incarnation = boot.incarnation
        engine._fleet_token = boot.token
        blob_read = engine.launch_stats["blob_read_seconds"]
        engine.launch()
        engine.launch_stats["blob_read_seconds"] = blob_read
        # the follower's own forkserver too: the leader kills what a
        # follower that died unclean leaves
        ctl.send(("hello", {"host": boot.host, "token": boot.token,
                            "accept_ports": engine._accept_ports,
                            "bulk": engine._bulk_names(),
                            "prefix": engine._ring_prefix,
                            "pids": engine._child_pids() + helper_pids()}))
        op, payload = ctl.recv(timeout=max(boot.timeout, 600.0))
        if op != "rendezvous":
            raise RuntimeError(f"expected rendezvous, got {op!r}")
        engine._finish_rendezvous(payload)
        import torch

        ctl.send(("ok", {"ready": boot.host,
                         "lowering_seconds": engine.lowering_seconds,
                         "launch": engine.launch_stats,
                         "cuda_initialized": torch.cuda.is_initialized()}))
        print(f"[follower {boot.host}] up: workers "
              f"{sorted(engine._local_ws)}, {len(engine._bridge_procs)} "
              f"bridge(s)", flush=True)
        _serve(ctl, engine, boot)
        print(f"[follower {boot.host}] clean exit", flush=True)
    except (ConnectionError, TimeoutError) as e:
        # Leader gone (or never reachable): nothing to report to.
        print(f"[follower {boot.host}] control link lost: {e}", flush=True)
        _leave(engine)
        os._exit(1)
    except Exception as e:  # noqa: BLE001 — reported to the leader
        traceback.print_exc()
        try:
            if ctl is not None and not (engine is not None and engine._fault_reported):
                ctl.send(("fault", encode_fault(e)))
        except Exception:
            pass
        _leave(engine)
        os._exit(1)
    finally:
        _leave(engine)
        if ctl is not None:
            ctl.close()


def _leave(engine) -> None:
    """Close the follower's engine, then stop its forkserver: a follower
    leaves by ``os._exit``, which runs no atexit hook, and its server would
    outlive it.  The server holds nothing to clean up, so it is killed at
    once: waiting for its interpreter (torch loaded) to shut down would
    lengthen every 2-host teardown and recovery."""
    from .launcher import stop_helpers

    if engine is not None:
        engine.close()
    stop_helpers(timeout=0.0)


def _serve(ctl: CtlConn, engine, boot: FollowerBoot) -> None:
    """The follower's command loop: one engine op per control frame."""
    from .shmem import RingCorruptionError, RingTimeout

    while True:
        msg = ctl.recv(timeout=None)
        op, args = msg[0], msg[1:]
        if op == "exit":
            ctl.send(("ok", None))
            return
        try:
            ctl.send(("ok", engine._fleet_dispatch(op, args)))
        except (WorkerDiedError, FleetStallError, RingCorruptionError,
                RingTimeout) as e:
            traceback.print_exc()
            if not engine._fault_reported:
                ctl.send(("fault", encode_fault(e)))
            _park(ctl)
            return
        except Exception:  # noqa: BLE001 — reported to the leader
            tb = traceback.format_exc()
            sys.stderr.write(tb)
            ctl.send(("err", tb))


def _park(ctl: CtlConn) -> None:
    """After reporting a fault: the local engine is closed; wait (bounded)
    for the leader's teardown "exit" so the leader never races a
    half-dead follower during re-rendezvous."""
    deadline = time.monotonic() + 600.0
    try:
        while time.monotonic() < deadline:
            msg = ctl.recv(timeout=1.0) if ctl.poll(0.2) else None
            if msg is None:
                continue
            if msg[0] == "exit":
                ctl.send(("ok", None))
                return
            ctl.send(("fault", {"type": "RuntimeError",
                                "message": "follower is faulted"}))
    except (ConnectionError, TimeoutError):
        return


__all__ = [
    "CtlConn", "FollowerBoot", "HostPlan", "Link", "accept_followers",
    "build_links", "decode_fault", "encode_fault", "follower_entry",
    "resolve_base_port", "resolve_host_plan",
]
