"""Lock-free SPSC rings over POSIX shared memory (paper §III-B),
as in ``repro.runtime.shmem``, whose byte layout this copy keeps: a ring
created by either package can be attached and read by the other.

This is the paper's headline data structure, reproduced at its native
layer: a single-producer single-consumer ring buffer in a shared-memory
segment, connecting two *free-running OS processes* with no locks and no
syscalls on the fast path.  The layout mirrors the paper's queue page —

    byte   0:  head (u32, next slot to WRITE; producer-owned)
    byte  64:  tail (u32, next slot to READ;  consumer-owned)
    byte 128:  capacity slots of ``slot_bytes`` each

— head and tail on separate cache lines so producer and consumer never
false-share (§III-B's "cache-friendly" split), and the ring arithmetic is
**bit-compatible with ``repro_torch.core.queue``**: ``head == tail`` is empty,
``(head + 1) % capacity == tail`` is full, so a ring of capacity C holds
at most C - 1 records (property-tested against the in-process QueueArray
semantics in ``tests/test_torch_shmem.py``).

Ordering: the producer writes the slot payload *before* publishing
``head``; the consumer reads the payload before publishing ``tail``.
CPython's GIL plus x86-TSO store ordering make the aligned u32
publication atomic and ordered for this use — the same argument the
paper makes for its acquire/release pair, at Python's abstraction level.

Three record flavors sit on the same ring:

  * **packet rings** (host Tx/Rx ports): one slot = one W-word packet;
  * **slab rings** (boundary channels): one slot = one epoch's exchange
    slab, ``u32 count + E*W payload`` — the free-running runtime's unit
    of synchronization (DESIGN.md §Runtime);
  * **credit rings** (reverse direction of each boundary channel): one
    slot = one u32 credit, the receiver's post-fill free space.

Blocking helpers (``push_wait`` / ``pop_wait``) spin with a short sleep
and honor a deadline plus an optional liveness ``check`` callback, so a
dead peer surfaces as ``RingTimeout`` (→ ``WorkerDiedError`` in the
launcher) instead of a hang.

Integrity: a ring created with ``checked=True`` prefixes every
record with a ``[u32 seq][u32 crc32]`` header.  The producer stamps a
monotonically increasing sequence number and the crc32 of the payload;
the consumer verifies BOTH before the payload is used, so a torn write,
a stray memory scribble, or a protocol slip (skipped/duplicated record)
raises ``RingCorruptionError`` — naming the channel and the
expected/actual values — instead of silently corrupting simulator state.
The two sequence counters live in the shm header (producer's next to
``head``, consumer's next to ``tail``) so both sides agree across
processes; slab and host-port packet rings are checked, the 4-byte
credit rings are not (their payload IS the protocol invariant, asserted
by ``gather_state``).
"""
from __future__ import annotations

import functools
import time
import zlib
from typing import Callable

import numpy as np

_HEAD_OFF = 0
_PROD_SEQ_OFF = 8    # producer cache line, next to head
_TAIL_OFF = 64
_CONS_SEQ_OFF = 72   # consumer cache line, next to tail
_DATA_OFF = 128
_HDR_BYTES = 8       # [u32 seq][u32 crc32] per checked record


class RingTimeout(RuntimeError):
    """A blocking ring operation exceeded its deadline."""


class RingCorruptionError(RuntimeError):
    """A checked ring record failed its sequence or crc32 verification.

    Carries the channel label, the mismatch kind (``"seq"`` | ``"crc"``),
    and the expected/actual values so the failure names exactly which
    boundary channel went bad — routed into the recovery path by the
    launcher."""

    def __init__(self, channel: str, kind: str, expected: int, actual: int,
                 seq: int | None = None):
        self.channel = channel
        self.kind = kind
        self.expected = int(expected)
        self.actual = int(actual)
        self.seq = None if seq is None else int(seq)
        if kind == "seq":
            msg = (f"ring corruption on {channel}: record sequence expected "
                   f"{self.expected}, got {self.actual}")
        else:
            msg = (f"ring corruption on {channel}: crc32 mismatch at seq "
                   f"{self.seq} (expected {self.expected:#010x}, got "
                   f"{self.actual:#010x})")
        super().__init__(msg)

    def to_payload(self) -> dict:
        """Picklable reconstruction args (worker → launcher fault reply)."""
        return {"channel": self.channel, "kind": self.kind,
                "expected": self.expected, "actual": self.actual,
                "seq": self.seq}


class Segment:
    """One named POSIX shared-memory segment, mapped with no file
    descriptor left open.

    ``multiprocessing.shared_memory.SharedMemory`` keeps two descriptors
    a segment for its lifetime (its own and the one ``mmap`` duplicates),
    and a fleet holds one segment a ring: two rings a boundary channel,
    thousands on a wide torus, past a common ``ulimit -n``.  This class
    opens the segment under the same name (``/dev/shm/<name>`` on Linux,
    so either package attaches the other's), maps it with the C library's
    ``mmap`` and closes the descriptor at once: the mapping keeps the
    memory.  It offers ``name``, ``buf`` (a ``memoryview``), ``size``,
    ``close`` and ``unlink``, the part of ``SharedMemory`` the rings use.
    ``close`` unmaps only once every view of ``buf`` is gone (else
    ``BufferError``, as ``SharedMemory`` raises).

    A created segment is registered with the resource tracker, as
    ``SharedMemory`` registers it, so a launcher that dies unlinks its
    segments; an attached one is not (the creator owns its lifetime)."""

    def __init__(self, name: str, size: int, *, create: bool):
        import ctypes
        import mmap
        import os
        import _posixshmem
        from multiprocessing import resource_tracker

        self.name = name
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            else:
                size = os.fstat(fd).st_size
            libc = _libc()
            addr = libc.mmap(None, size, mmap.PROT_READ | mmap.PROT_WRITE,
                             mmap.MAP_SHARED, fd, 0)
            if addr in (None, ctypes.c_void_p(-1).value):
                err = ctypes.get_errno()
                raise OSError(err, f"mmap of shared memory {name!r}: "
                                   f"{os.strerror(err)}")
        except BaseException:
            os.close(fd)
            if create:
                _posixshmem.shm_unlink("/" + name)
            raise
        os.close(fd)
        self.size = int(size)
        self._addr = addr
        self._arr = np.ctypeslib.as_array(
            (ctypes.c_ubyte * self.size).from_address(addr))
        self.buf: memoryview | None = memoryview(self._arr)
        self._tracked = create
        if create:
            resource_tracker.register("/" + name, "shared_memory")

    def close(self) -> None:
        if self.buf is None:
            return
        self.buf.release()  # BufferError while a view of it lives
        self.buf = self._arr = None
        _libc().munmap(self._addr, self.size)

    def unlink(self) -> None:
        import _posixshmem
        from multiprocessing import resource_tracker

        _posixshmem.shm_unlink("/" + self.name)
        if self._tracked:
            self._tracked = False
            resource_tracker.unregister("/" + self.name, "shared_memory")


@functools.cache
def _libc():
    """The C library's ``mmap``/``munmap`` with their signatures declared."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.munmap.restype = ctypes.c_int
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    return libc


def create_shared_memory(name: str, size: int) -> Segment:
    """Create (exclusively) and map a segment of ``size`` bytes."""
    return Segment(name, size, create=True)


def attach_shared_memory(name: str) -> Segment:
    """Attach to an existing segment WITHOUT registering it with the
    resource tracker.

    The launcher owns every segment's lifetime (create + unlink).  A
    worker that registered the name a second time with the shared
    resource tracker (CPython bpo-38119) would, at its exit, unlink — or
    warn about — a segment its peers are still using; leaving the attach
    side unregistered leaves exactly one owner."""
    return Segment(name, 0, create=False)


class ShmRing:
    """One SPSC ring in a named shared-memory segment.

    Exactly one process may push and one may pop (they can be the same
    process).  ``capacity`` counts slots; at most ``capacity - 1`` records
    are ever resident — the ``core.queue`` convention.
    """

    def __init__(self, shm: Segment, capacity: int,
                 slot_bytes: int, *, owner: bool, checked: bool = False,
                 label: str = ""):
        self._shm = shm
        self.name = shm.name
        self.capacity = int(capacity)
        self.slot_bytes = int(slot_bytes)          # payload bytes per record
        self.checked = bool(checked)
        self.label = label or shm.name
        self.stride = self.slot_bytes + (_HDR_BYTES if checked else 0)
        self._owner = owner
        self._corrupt_next = False                 # fault-injection hook
        buf = shm.buf
        self._head = np.frombuffer(buf, np.uint32, count=1, offset=_HEAD_OFF)
        self._tail = np.frombuffer(buf, np.uint32, count=1, offset=_TAIL_OFF)
        self._pseq = np.frombuffer(buf, np.uint32, count=1,
                                   offset=_PROD_SEQ_OFF)
        self._cseq = np.frombuffer(buf, np.uint32, count=1,
                                   offset=_CONS_SEQ_OFF)
        self._slots = np.frombuffer(
            buf, np.uint8, count=self.capacity * self.stride,
            offset=_DATA_OFF,
        ).reshape(self.capacity, self.stride)

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, name: str, capacity: int, slot_bytes: int, *,
               checked: bool = False, label: str = "") -> "ShmRing":
        if capacity < 2:
            raise ValueError(f"ring capacity must be >= 2, got {capacity}")
        stride = slot_bytes + (_HDR_BYTES if checked else 0)
        size = _DATA_OFF + capacity * stride
        shm = create_shared_memory(name, size)
        shm.buf[:_DATA_OFF] = bytes(_DATA_OFF)
        ring = cls(shm, capacity, slot_bytes, owner=True, checked=checked,
                   label=label)
        return ring

    @classmethod
    def attach(cls, name: str, capacity: int, slot_bytes: int, *,
               checked: bool = False, label: str = "") -> "ShmRing":
        return cls(attach_shared_memory(name), capacity, slot_bytes,
                   owner=False, checked=checked, label=label)

    def close(self) -> None:
        # Release numpy views before closing the mmap (else BufferError).
        self._head = self._tail = self._slots = None
        self._pseq = self._cseq = None
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # ------------------------------------------------------------ occupancy
    @property
    def head(self) -> int:
        return int(self._head[0])

    @property
    def tail(self) -> int:
        return int(self._tail[0])

    def size(self) -> int:
        return (self.head - self.tail) % self.capacity

    def free(self) -> int:
        return (self.capacity - 1) - self.size()

    def empty(self) -> bool:
        return self.head == self.tail

    def full(self) -> bool:
        return (self.head + 1) % self.capacity == self.tail

    def reset(self) -> None:
        """Drop all records (single-threaded use only — e.g. session reset,
        while no worker is running)."""
        self._head[0] = 0
        self._tail[0] = 0
        self._pseq[0] = 0
        self._cseq[0] = 0

    # ------------------------------------------------------------ integrity
    def corrupt_next_push(self) -> None:
        """Fault injection: flip a payload byte of the NEXT pushed record
        AFTER its crc is stamped, so the consumer's verification trips."""
        self._corrupt_next = True

    def _write_slot(self, h: int, view: np.ndarray) -> None:
        """Write one record into slot ``h`` (checked layout: seq+crc hdr)."""
        slot = self._slots[h]
        if not self.checked:
            slot[: view.size] = view
            return
        slot[_HDR_BYTES: _HDR_BYTES + view.size] = view
        if view.size < self.slot_bytes:
            slot[_HDR_BYTES + view.size:] = 0
        seq = int(self._pseq[0])
        crc = zlib.crc32(slot[_HDR_BYTES:].tobytes())
        slot[0:4] = np.frombuffer(np.uint32(seq).tobytes(), np.uint8)
        slot[4:8] = np.frombuffer(np.uint32(crc).tobytes(), np.uint8)
        if self._corrupt_next:
            self._corrupt_next = False
            slot[_HDR_BYTES] ^= 0xFF
        self._pseq[0] = np.uint32(seq + 1)

    def _verify_slot(self, idx: int, expect_seq: int) -> None:
        # Verify a COPY: a raising frame must not pin a live view of the
        # shm buffer in its traceback (the mmap could never close).
        rec = self._slots[idx].tobytes()
        seq = int.from_bytes(rec[0:4], "little")
        if seq != expect_seq % (1 << 32):
            raise RingCorruptionError(self.label, "seq", expect_seq, seq)
        crc_stored = int.from_bytes(rec[4:8], "little")
        crc_actual = zlib.crc32(rec[_HDR_BYTES:])
        if crc_stored != crc_actual:
            raise RingCorruptionError(self.label, "crc", crc_stored,
                                      crc_actual, seq=seq)

    # ------------------------------------------------------------- raw slots
    def push_bytes(self, payload) -> bool:
        """Write one record.  Returns False when full (nothing written)."""
        h, t = self.head, self.tail
        if (h + 1) % self.capacity == t:
            return False
        view = np.frombuffer(payload, np.uint8)
        self._write_slot(h, view)
        self._head[0] = (h + 1) % self.capacity  # publish AFTER the payload
        return True

    def pop_bytes(self) -> bytes | None:
        """Read one record's payload (a copy).  Returns None when empty.
        On a checked ring the record is verified BEFORE the payload is
        returned (raises ``RingCorruptionError`` on mismatch)."""
        h, t = self.head, self.tail
        if h == t:
            return None
        if self.checked:
            self._verify_slot(t, int(self._cseq[0]))
            out = self._slots[t, _HDR_BYTES:].tobytes()
            self._cseq[0] = np.uint32(int(self._cseq[0]) + 1)
        else:
            out = self._slots[t].tobytes()
        self._tail[0] = (t + 1) % self.capacity
        return out

    # -------------------------------------------- verbatim records (bridges)
    # A TCP bridge (the reference's ``runtime.bridge``) forwards records
    # BETWEEN rings without interpreting them: a checked record travels with its
    # [seq][crc32] header intact, so the far-side consumer's verification
    # covers the wire too (end-to-end integrity, no re-framing).  The
    # local seq counters still advance so native push/pop interoperate
    # with forwarded records on the same ring.
    def pop_record(self) -> bytes | None:
        """Pop one record VERBATIM (checked rings include the seq+crc
        header), without verification.  Returns None when empty."""
        h, t = self.head, self.tail
        if h == t:
            return None
        out = self._slots[t].tobytes()
        if self.checked:
            self._cseq[0] = np.uint32(int(self._cseq[0]) + 1)
        self._tail[0] = (t + 1) % self.capacity
        return out

    def push_record(self, record: bytes) -> bool:
        """Push one VERBATIM record (stride bytes, headers preserved —
        the producer seq is NOT re-stamped).  Returns False when full."""
        view = np.frombuffer(record, np.uint8)
        if view.size != self.stride:
            raise ValueError(
                f"verbatim record is {view.size}B, ring stride is "
                f"{self.stride}B ({self.label})"
            )
        h, t = self.head, self.tail
        if (h + 1) % self.capacity == t:
            return False
        self._slots[h, :] = view
        if self.checked:
            self._pseq[0] = np.uint32(int(self._pseq[0]) + 1)
        self._head[0] = (h + 1) % self.capacity
        return True

    def _wait(self, ready: Callable[[], bool], timeout: float,
              check: Callable[[], None] | None, what: str) -> None:
        deadline = time.monotonic() + timeout
        delay = 20e-6
        while not ready():
            if check is not None:
                check()
            if time.monotonic() > deadline:
                raise RingTimeout(
                    f"{what} on ring {self.name} timed out after {timeout}s "
                    f"(size={self.size()}/{self.capacity - 1})"
                )
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def push_bytes_wait(self, payload, timeout: float,
                        check: Callable[[], None] | None = None) -> None:
        self._wait(lambda: not self.full(), timeout, check, "push")
        assert self.push_bytes(payload)

    def pop_bytes_wait(self, timeout: float,
                       check: Callable[[], None] | None = None) -> bytes:
        self._wait(lambda: not self.empty(), timeout, check, "pop")
        out = self.pop_bytes()
        assert out is not None
        return out

    # ------------------------------------------- packet records (host ports)
    # One slot = one packet of W words; dtype fixed at ring construction by
    # slot_bytes = W * itemsize.  Batched push/pop move what fits and report
    # the count — the same partial-landing contract as queue.fill_single.
    def push_packets(self, arr: np.ndarray) -> int:
        """Push up to len(arr) packets ((k, slot_bytes) as raw rows after a
        view cast); records beyond ``free()`` are refused.  Returns count."""
        if len(arr) == 0:
            return 0
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(len(arr), -1)
        if raw.shape[1] != self.slot_bytes:
            raise ValueError(
                f"packet rows are {raw.shape[1]}B, ring slots {self.slot_bytes}B"
            )
        n = min(len(raw), self.free())
        h = self.head
        for i in range(n):  # small k (<= capacity-1); clarity over vectorizing
            self._write_slot((h + i) % self.capacity, raw[i])
        if n:
            self._head[0] = (h + n) % self.capacity
        return n

    def peek_packets(self, max_n: int, dtype, words: int) -> np.ndarray:
        """Read up to ``max_n`` packets WITHOUT consuming them — the caller
        commits with ``advance(n)`` after it knows how many landed
        downstream (partial host-tier ingest).  Checked rings verify every
        peeked record (seq + crc) before returning payloads."""
        n = min(max_n, self.size())
        t = self.tail
        idx = (t + np.arange(n)) % self.capacity
        if self.checked:
            base = int(self._cseq[0])
            for j in range(n):
                self._verify_slot(int(idx[j]), base + j)
            raw = np.ascontiguousarray(self._slots[idx][:, _HDR_BYTES:])
        else:
            raw = self._slots[idx]
        return raw.view(np.dtype(dtype)).reshape(n, words).copy()

    def advance(self, n: int) -> None:
        """Consume ``n`` records previously ``peek``ed."""
        if n:
            if self.checked:
                self._cseq[0] = np.uint32(int(self._cseq[0]) + n)
            self._tail[0] = (self.tail + n) % self.capacity
    def pop_packets(self, max_n: int, dtype, words: int) -> np.ndarray:
        out = self.peek_packets(max_n, dtype, words)
        self.advance(len(out))
        return out

    # --------------------------------------- slab records (boundary channels)
    # One slot = u32 count + E*W payload words: one epoch's exchange slab.
    def push_slab_wait(self, count: int, slab: np.ndarray, timeout: float,
                       check: Callable[[], None] | None = None) -> None:
        rec = np.empty((self.slot_bytes,), np.uint8)
        rec[:4] = np.frombuffer(np.uint32(count).tobytes(), np.uint8)
        raw = np.ascontiguousarray(slab).view(np.uint8).reshape(-1)
        rec[4:4 + raw.size] = raw
        self.push_bytes_wait(rec, timeout, check)

    def pop_slab_wait(self, shape, dtype, timeout: float,
                      check: Callable[[], None] | None = None
                      ) -> tuple[int, np.ndarray]:
        rec = self.pop_bytes_wait(timeout, check)
        count = int(np.frombuffer(rec, np.uint32, count=1)[0])
        slab = np.frombuffer(rec, np.dtype(dtype), offset=4,
                             count=int(np.prod(shape))).reshape(shape)
        return count, slab

    # ------------------------------------------------------- credit records
    def push_u32(self, value: int, timeout: float,
                 check: Callable[[], None] | None = None) -> None:
        self.push_bytes_wait(np.uint32(value).tobytes(), timeout, check)

    def pop_u32_wait(self, timeout: float,
                     check: Callable[[], None] | None = None) -> int:
        return int(np.frombuffer(self.pop_bytes_wait(timeout, check),
                                 np.uint32, count=1)[0])

    # --------------------------------------------- checkpoint gather-scatter
    def seq_state(self) -> tuple[int, int]:
        """(producer_seq, consumer_seq) — captured alongside ``snapshot()``
        so a restore into a FRESH segment (fleet respawn) resumes the exact
        sequence-number timeline and stays bit-identical to a fault-free
        run."""
        return int(self._pseq[0]), int(self._cseq[0])

    def snapshot(self) -> np.ndarray:
        """Resident records, oldest first, WITHOUT consuming them —
        (size, stride) u8 (checked rings include the seq+crc headers).
        Single-threaded use only (session rest)."""
        n = self.size()
        idx = (self.tail + np.arange(n)) % self.capacity
        return self._slots[idx].copy()

    def restore(self, records: np.ndarray,
                seq: tuple[int, int] | None = None) -> None:
        """Replace the ring contents with ``records`` ((k, stride) u8).

        For a checked ring, ``seq`` restores the exact producer/consumer
        sequence counters (from ``seq_state()``); without it they are
        resynced from the resident records' headers (0 when empty)."""
        records = np.asarray(records, np.uint8).reshape(-1, self.stride)
        if len(records) > self.capacity - 1:
            raise ValueError(
                f"{len(records)} records > ring capacity-1={self.capacity - 1}"
            )
        self.reset()
        self._slots[: len(records)] = records
        self._head[0] = len(records)
        if self.checked:
            if seq is not None:
                self._pseq[0] = np.uint32(seq[0])
                self._cseq[0] = np.uint32(seq[1])
            elif len(records):
                first = int.from_bytes(records[0, 0:4].tobytes(), "little")
                self._cseq[0] = np.uint32(first)
                self._pseq[0] = np.uint32(first + len(records))

    def __repr__(self):
        kind = "checked " if self.checked else ""
        return (f"ShmRing({self.label!r}, {kind}{self.size()}/"
                f"{self.capacity - 1} x {self.slot_bytes}B)")


def slab_slot_bytes(E: int, W: int, itemsize: int) -> int:
    """Slot size for a boundary-channel slab ring (u32 count + E*W words)."""
    return 4 + E * W * itemsize
