"""TCP ring bridge — one shm ring pair per host, a framed socket between
(paper §III-B's "fast queues that span machines"), as in
``repro.runtime.bridge``, byte for byte on the wire.

A cross-host boundary channel keeps the standard single-host anatomy on
BOTH hosts: the sender's host owns a local slab ring + credit ring (the
worker's side), and the receiver's host owns its own local pair.  The
bridge proxy process pairs them over TCP:

  * sender host:  pop slab records from the local data ring -> SLAB
    frames on the wire; CREDIT frames from the wire -> push into the
    local credit ring (the sender's next credit);
  * receiver host: SLAB frames -> push into the local data ring; pop the
    receiver's post-fill credits from the local credit ring -> CREDIT
    frames back.

Records travel VERBATIM (``ShmRing.pop_record``/``push_record``): a
checked slab record crosses the wire with its ``[seq][crc32]`` header
intact and is verified only by the far consumer, so corruption anywhere
— producer shm, the TCP path, receiver shm — trips the SAME
``RingCorruptionError`` surface as a single-host run (end-to-end
integrity, nothing re-framed).  The bridge never originates or drops a
record (it only adds latency), so the credit protocol's
one-record-per-exchange invariant and the per-tier staleness bound hold
unchanged across hosts.

Wire format: length-prefixed frames ``[u8 flavor][u8 gen][u32 chan]
[u32 len][payload]``.  Flavors: SLAB / CREDIT (boundary records), PKT
(host packet records on the fleet control link), CTL (pickled control
messages), FENCE (generation barrier: both sides discard in-flight
frames at a quiesced boundary before a ring reset), HELLO (rendezvous
handshake: token + link id, so a stale incarnation can never splice into
a re-rendezvoused fleet).

The proxy is a first-class fleet member: it publishes heartbeats and
"blocked on ring/link" status words into the SAME heartbeat shm as the
granule workers (``fault_tolerance.ProcessMonitor``), answers a command
pipe (fence / resume / stats / slow / corrupt / exit), and accumulates
the per-link observability row surfaced as
``Simulation.stats()["bridges"]``.

A proxy moves bytes between shared memory and a socket: it imports no
CUDA state and touches no card, whatever device the fleet's workers use.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import select
import socket
import struct
import sys
import time

from .fault_tolerance import (
    OP_CREDIT_PUSH, OP_LINK_WAIT, OP_SLAB_POP, OP_SLAB_PUSH, encode_blocked,
)
from .shmem import ShmRing

# ------------------------------------------------------------ wire framing
FLAVOR_SLAB = 1    # boundary slab record, verbatim (checked header included)
FLAVOR_CREDIT = 2  # boundary credit record, verbatim (raw u32)
FLAVOR_PKT = 3     # host packet record (fleet control link ext forwarding)
FLAVOR_CTL = 4     # pickled control message (fleet launcher protocol)
FLAVOR_FENCE = 5   # generation barrier (quiesced-boundary ring reset)
FLAVOR_HELLO = 6   # rendezvous handshake: pickled {token, link, host}

_FRAME = struct.Struct("<BBII")  # flavor, gen, chan, payload length
_MAX_FRAME = 1 << 28             # sanity bound: no record approaches this


def send_frame(sock_, flavor: int, gen: int, chan: int,
               payload: bytes) -> int:
    """Send one length-prefixed frame; returns bytes put on the wire."""
    hdr = _FRAME.pack(flavor, gen & 0xFF, chan, len(payload))
    sock_.sendall(hdr + payload)
    return len(hdr) + len(payload)


class FrameReader:
    """Incremental frame parser over a byte stream (nonblocking reads feed
    ``feed``; complete frames come out of ``next_frame``)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def next_frame(self):
        """(flavor, gen, chan, payload) or None if incomplete."""
        if len(self._buf) < _FRAME.size:
            return None
        flavor, gen, chan, n = _FRAME.unpack_from(self._buf, 0)
        if n > _MAX_FRAME:
            raise ValueError(f"oversized frame: {n} bytes (flavor {flavor})")
        end = _FRAME.size + n
        if len(self._buf) < end:
            return None
        payload = bytes(self._buf[_FRAME.size:end])
        del self._buf[:end]
        return flavor, gen, chan, payload


def recv_frame(sock_, reader: FrameReader, timeout: float):
    """Blocking read of one complete frame through ``reader`` (buffered
    bytes are consumed first).  Raises ConnectionError on EOF, TimeoutError
    on deadline."""
    deadline = time.monotonic() + timeout
    while True:
        f = reader.next_frame()
        if f is not None:
            return f
        remain = deadline - time.monotonic()
        if remain <= 0:
            raise TimeoutError(f"no frame within {timeout}s")
        r, _, _ = select.select([sock_], [], [], min(remain, 0.2))
        if not r:
            continue
        data = sock_.recv(1 << 16)
        if not data:
            raise ConnectionError("peer closed the link")
        reader.feed(data)


def send_msg(sock_, obj, flavor: int = FLAVOR_CTL, gen: int = 0,
             chan: int = 0) -> int:
    """Pickle ``obj`` into one frame (the fleet control protocol)."""
    return send_frame(sock_, flavor, gen, chan, pickle.dumps(obj))


def recv_msg(sock_, reader: FrameReader, timeout: float,
             expect: int = FLAVOR_CTL):
    flavor, gen, chan, payload = recv_frame(sock_, reader, timeout)
    if flavor != expect:
        raise ValueError(f"expected frame flavor {expect}, got {flavor}")
    return pickle.loads(payload)


def connect_retry(addr: tuple[str, int], timeout: float) -> socket.socket:
    """Dial with retries until ``timeout`` (the peer's listener is
    reported before this runs, so retries only absorb scheduling skew)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            s = socket.create_connection(addr, timeout=min(timeout, 10.0))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


# ------------------------------------------------------------- bridge spec
@dataclasses.dataclass(frozen=True)
class BridgeChannel:
    """One bridged boundary channel, seen from THIS host.

    ``side`` is "tx" when the slab producer is local (slabs flow out,
    credits flow in) and "rx" when the consumer is local."""
    chan: int
    side: str                 # "tx" | "rx"
    data_name: str            # local slab ring (checked)
    data_capacity: int
    data_slot_bytes: int
    credit_name: str          # local credit ring (raw u32)
    credit_capacity: int


@dataclasses.dataclass(frozen=True)
class BridgeSpec:
    """Everything one bridge proxy process needs (picklable spawn arg)."""
    link: int                 # global link index (fleet link map order)
    label: str                # e.g. "link0:h0<->h1"
    host: str                 # this side's host name
    peer: str                 # far side's host name
    role: str                 # "accept" | "dial"
    token: str                # fleet incarnation token (handshake check)
    port: int                 # accept side: port to bind (0 = ephemeral)
    channels: tuple           # tuple[BridgeChannel, ...]
    timeout: float
    hb_name: str | None       # heartbeat shm (shared with the workers)
    hb_index: int             # NW + local bridge index


class BridgeProxy:
    """The pump: local rings <-> framed TCP link (single-threaded)."""

    def __init__(self, spec: BridgeSpec, conn):
        self.spec = spec
        self.conn = conn                  # command pipe to the launcher
        self.gen = 0
        self.sock: socket.socket | None = None
        self.reader = FrameReader()
        self._listener: socket.socket | None = None
        self._paused = False
        self._corrupt_next = False
        self._peer_fence: int | None = None
        self._pending: tuple[int, bytes] | None = None  # (chan, record)
        self._exit = False
        # local ring attachments
        self.data: dict[int, ShmRing] = {}
        self.credit: dict[int, ShmRing] = {}
        self.tx_chans = tuple(c.chan for c in spec.channels
                              if c.side == "tx")
        self.rx_chans = tuple(c.chan for c in spec.channels
                              if c.side == "rx")
        for c in spec.channels:
            self.data[c.chan] = ShmRing.attach(
                c.data_name, c.data_capacity, c.data_slot_bytes,
                checked=True, label=f"slab:c{c.chan}")
            self.credit[c.chan] = ShmRing.attach(
                c.credit_name, c.credit_capacity, 4)
        # heartbeat record (first-class fleet member)
        self._hb_shm = self._hb = None
        if spec.hb_name:
            from .worker import attach_heartbeat

            self._hb_shm, self._hb = attach_heartbeat(spec.hb_name,
                                                      spec.hb_index)
        # observability counters (the stats()["bridges"] row)
        self.bytes_tx = self.bytes_rx = 0
        self.slabs_tx = self.slabs_rx = 0
        self.credits_tx = self.credits_rx = 0
        self.frames = 0
        self._rtt_mean = 0.0
        self._rtt_n = 0
        self._slab_sent_t: dict[int, float] = {}
        self._t0 = time.monotonic()
        self._wait_s = 0.0
        # rendezvous wall time, kept OUT of the steady-state pump window:
        # counting cold-start (peer spawn, TCP dial retries) in the
        # wait_fraction denominator used to dilute the stall metric
        self._connect_s = 0.0

    # ------------------------------------------------------------ heartbeat
    def _beat(self, status: int = 0) -> None:
        if self._hb is not None:
            self._hb[0] = float(self.frames)
            self._hb[1] = time.time()
            self._hb[2] = float(status)

    # ------------------------------------------------------------ lifecycle
    def _log(self, msg: str) -> None:
        print(f"[bridge {self.spec.label}/{self.spec.host}] {msg}",
              flush=True)

    def rendezvous(self) -> None:
        """Accept side binds + reports its port, dial side waits for the
        launcher's "dial" command; both then exchange HELLO frames and
        verify the fleet token + link id."""
        spec = self.spec
        if spec.role == "accept":
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(("127.0.0.1", spec.port))
            self._listener.listen(1)
            port = self._listener.getsockname()[1]
            self.conn.send(("ready", port))
            deadline = time.monotonic() + max(spec.timeout, 300.0)
            while True:
                r, _, _ = select.select([self._listener], [], [], 0.2)
                if r:
                    self.sock, _ = self._listener.accept()
                    break
                if self.conn.poll(0) and self._handle_cmd_prelink():
                    return
                if time.monotonic() > deadline:
                    raise TimeoutError("no peer dialed the link")
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        else:
            self.conn.send(("ready", None))
            deadline = time.monotonic() + max(spec.timeout, 300.0)
            while True:
                if self.conn.poll(0.2):
                    cmd = self.conn.recv()
                    if cmd[0] == "exit":
                        self._exit = True
                        self.conn.send(("ok", None))
                        return
                    assert cmd[0] == "dial", cmd
                    self.sock = connect_retry(tuple(cmd[1]), spec.timeout)
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError("launcher never sent the dial map")
        hello = {"token": spec.token, "link": spec.link, "host": spec.host}
        send_msg(self.sock, hello, flavor=FLAVOR_HELLO)
        peer = recv_msg(self.sock, self.reader,
                        max(spec.timeout, 300.0), expect=FLAVOR_HELLO)
        if peer.get("token") != spec.token or peer.get("link") != spec.link:
            raise ConnectionError(
                f"rendezvous handshake mismatch on {spec.label}: "
                f"got {peer}, want token={spec.token} link={spec.link}"
            )
        self.sock.settimeout(max(spec.timeout, 60.0))
        # link is up: close the connect window and restart the steady-
        # state clock, so wait_fraction measures pump stalls only
        self._connect_s = time.monotonic() - self._t0
        self._t0 = time.monotonic()
        self._wait_s = 0.0
        self.conn.send(("up", peer.get("host")))
        self._log(f"link up ({spec.role}, peer {peer.get('host')})")

    def _handle_cmd_prelink(self) -> bool:
        """Pre-link command handling (only exit makes sense)."""
        cmd = self.conn.recv()
        if cmd[0] == "exit":
            self._exit = True
            self.conn.send(("ok", None))
            return True
        self.conn.send(("err", f"command {cmd[0]!r} before link up"))
        return False

    # ----------------------------------------------------------------- pump
    def serve(self) -> None:
        self.rendezvous()
        while not self._exit:
            progressed = self._pump_once()
            if self.conn.poll(0):
                self._handle_cmd()
                progressed = True
            if not progressed:
                t = time.monotonic()
                self._beat(encode_blocked(
                    OP_LINK_WAIT,
                    self.tx_chans[0] if self.tx_chans
                    else (self.rx_chans[0] if self.rx_chans else 0)))
                time.sleep(100e-6)
                self._wait_s += time.monotonic() - t
            else:
                self._beat(0)

    def _pump_once(self) -> bool:
        progressed = False
        if self._paused:
            return False
        # retry a parked inbound record first (ordering: nothing newer may
        # land before it)
        if self._pending is not None:
            if not self._flush_pending():
                return False
            progressed = True
        # local -> wire
        for c in self.tx_chans:
            rec = self.data[c].pop_record()
            if rec is not None:
                self._send_record(FLAVOR_SLAB, c, rec)
                progressed = True
        for c in self.rx_chans:
            rec = self.credit[c].pop_record()
            if rec is not None:
                self._send_record(FLAVOR_CREDIT, c, rec)
                progressed = True
        # wire -> local
        r, _, _ = select.select([self.sock], [], [], 0)
        if r:
            data = self.sock.recv(1 << 16)
            if not data:
                raise ConnectionError("peer closed the link")
            self.bytes_rx += len(data)
            self.reader.feed(data)
            progressed = True
        while self._pending is None:
            f = self.reader.next_frame()
            if f is None:
                break
            self._dispatch_frame(*f)
            progressed = True
        return progressed

    def _send_record(self, flavor: int, chan: int, rec: bytes) -> None:
        if flavor == FLAVOR_SLAB:
            if self._corrupt_next:
                self._corrupt_next = False
                rec = bytearray(rec)
                rec[8 if len(rec) > 8 else 0] ^= 0xFF
                rec = bytes(rec)
                self._log(f"fault injection: corrupted slab frame on "
                          f"c{chan} (on the wire)")
            self._slab_sent_t[chan] = time.monotonic()
            self.slabs_tx += 1
        else:
            self.credits_tx += 1
        self.bytes_tx += send_frame(self.sock, flavor, self.gen, chan, rec)
        self.frames += 1

    def _dispatch_frame(self, flavor: int, gen: int, chan: int,
                        payload: bytes) -> None:
        if flavor == FLAVOR_FENCE:
            self._peer_fence = gen
            return
        if gen != (self.gen & 0xFF):
            return  # stale generation (pre-fence leftovers)
        if flavor == FLAVOR_SLAB:
            self.slabs_rx += 1
            self.frames += 1
            if not self.data[chan].push_record(payload):
                self._pending = (chan, payload)
                self._beat(encode_blocked(OP_SLAB_PUSH, chan))
        elif flavor == FLAVOR_CREDIT:
            self.credits_rx += 1
            self.frames += 1
            t0 = self._slab_sent_t.get(chan)
            if t0 is not None:
                rtt = time.monotonic() - t0
                self._rtt_n += 1
                self._rtt_mean += (rtt - self._rtt_mean) / self._rtt_n
            if not self.credit[chan].push_record(payload):
                self._pending = (chan, payload)
                self._beat(encode_blocked(OP_CREDIT_PUSH, chan))
        else:
            raise ValueError(f"unexpected frame flavor {flavor} mid-pump")

    def _flush_pending(self) -> bool:
        chan, payload = self._pending
        ring = (self.data if chan in self.rx_chans else self.credit)[chan]
        if ring.push_record(payload):
            self._pending = None
            return True
        return False

    # ------------------------------------------------------------- commands
    def _handle_cmd(self) -> None:
        cmd = self.conn.recv()
        op = cmd[0]
        if op == "exit":
            self._exit = True
            self.conn.send(("ok", None))
        elif op == "stats":
            self.conn.send(("ok", self.stats()))
        elif op == "fence":
            self._fence(int(cmd[1]))
            self.conn.send(("ok", None))
        elif op == "resume":
            self._paused = False
            self.conn.send(("ok", None))
        elif op == "slow":
            secs = float(cmd[1]) if len(cmd) > 1 and cmd[1] else 0.05
            self._log(f"fault injection: pausing the pump {secs}s")
            end = time.monotonic() + secs
            while time.monotonic() < end:
                self._beat(encode_blocked(
                    OP_LINK_WAIT, self.tx_chans[0] if self.tx_chans else 0))
                time.sleep(min(0.01, max(0.0, end - time.monotonic())))
            self.conn.send(("ok", None))
        elif op == "corrupt":
            self._corrupt_next = True
            self.conn.send(("ok", None))
        else:
            self.conn.send(("err", f"unknown bridge command {op!r}"))

    def _fence(self, gen: int) -> None:
        """Generation barrier at a quiesced boundary: exchange FENCE
        frames, discard anything in flight from the old generation, and
        pause the pump until "resume" (the launcher resets/reseeds the
        rings in between).  Records discarded here are by construction
        re-seeded by the caller (init) or restored (scatter)."""
        send_frame(self.sock, FLAVOR_FENCE, gen, 0, b"")
        deadline = time.monotonic() + max(self.spec.timeout, 60.0)
        while self._peer_fence is None or self._peer_fence != (gen & 0xFF):
            f = self.reader.next_frame()
            if f is not None:
                if f[0] == FLAVOR_FENCE:
                    self._peer_fence = f[1]
                continue  # pre-fence frames of the old generation: discard
            if time.monotonic() > deadline:
                raise TimeoutError(f"peer never fenced (gen {gen})")
            r, _, _ = select.select([self.sock], [], [], 0.2)
            if r:
                data = self.sock.recv(1 << 16)
                if not data:
                    raise ConnectionError("peer closed during fence")
                self.reader.feed(data)
        self.gen = gen
        self._peer_fence = None
        self._pending = None
        self._slab_sent_t.clear()
        self._paused = True
        self._log(f"fenced at generation {gen}")

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        total = max(time.monotonic() - self._t0, 1e-9)
        return {
            "link": self.spec.link,
            "label": self.spec.label,
            "host": self.spec.host,
            "peer": self.spec.peer,
            "role": self.spec.role,
            "channels": len(self.spec.channels),
            "bytes_tx": int(self.bytes_tx),
            "bytes_rx": int(self.bytes_rx),
            "slabs_tx": int(self.slabs_tx),
            "slabs_rx": int(self.slabs_rx),
            "credits_tx": int(self.credits_tx),
            "credits_rx": int(self.credits_rx),
            "credit_rtt_s": float(self._rtt_mean),
            "wait_fraction": float(self._wait_s / total),
            "connect_s": float(self._connect_s),
        }

    def close(self) -> None:
        for ring in (*self.data.values(), *self.credit.values()):
            ring.close()
        self.data.clear()
        self.credit.clear()
        if self._hb_shm is not None:
            self._hb = None
            try:
                self._hb_shm.close()
            except Exception:
                pass
        for s in (self.sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except Exception:
                    pass


def bridge_entry(conn, spec_pickle: bytes, log_path: str | None) -> None:
    """Bridge proxy process entry point (same spawn idiom as
    ``worker_entry``): captured log, command pipe, heartbeat membership.
    Any link failure — peer reset, EOF, frame timeout — exits nonzero, so
    the launcher's ProcessMonitor converts it into ``LinkDownError`` (a
    RECOVERABLE fault) within one poll interval."""
    spec: BridgeSpec = pickle.loads(spec_pickle)
    if log_path:
        f = open(log_path, "a", buffering=1)
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        sys.stdout = os.fdopen(1, "w", buffering=1)
        sys.stderr = os.fdopen(2, "w", buffering=1)
    proxy = None
    try:
        proxy = BridgeProxy(spec, conn)
        proxy._log(f"channels tx={list(proxy.tx_chans)} "
                   f"rx={list(proxy.rx_chans)} role={spec.role}")
        proxy.serve()
        proxy._log("clean exit")
    except Exception as e:  # noqa: BLE001 — any link failure is terminal
        print(f"[bridge {spec.label}/{spec.host}] FATAL: "
              f"{type(e).__name__}: {e}", flush=True)
        try:
            if proxy is not None:
                proxy.close()
        finally:
            os._exit(1)
    finally:
        if proxy is not None:
            proxy.close()
        try:
            conn.close()
        except Exception:
            pass


__all__ = [
    "FLAVOR_SLAB", "FLAVOR_CREDIT", "FLAVOR_PKT", "FLAVOR_CTL",
    "FLAVOR_FENCE", "FLAVOR_HELLO", "BridgeChannel", "BridgeSpec",
    "BridgeProxy", "FrameReader", "bridge_entry", "connect_retry",
    "recv_frame", "recv_msg", "send_frame", "send_msg",
]
