"""The port's shared-memory SPSC rings (``repro_torch.runtime.shmem``), with
no processes.

  * the reference's random push/pop script property: the same script runs
    against a ring and the port's in-process ``core.queue`` and every
    observable (flags, popped payloads, size/free/empty/full) must agree,
    wraparound and the full/empty edges included;
  * the byte layout is the reference's: a ring created by the port is
    attached and read by ``repro.runtime.shmem.ShmRing`` and the other way
    round — packets, slab records, u32 credit records and checked records —
    and a corrupted checked record raises ``RingCorruptionError`` in both;
  * a segment keeps no file descriptor open once mapped.

Tolerance: exact (bytes and integer counters).
"""
import gc
import os

import numpy as np
import pytest
import torch

from repro.runtime import shmem as jshm
from repro_torch.core import queue as qmod
from repro_torch.runtime import shmem as tshm
from repro_torch.runtime.shmem import RingCorruptionError, ShmRing, slab_slot_bytes


def _name(tag: str) -> str:
    return f"tt_{tag}_{os.getpid()}_{np.random.randint(1 << 30)}"


def _apply_script(ops, cap, W=2):
    """One push/pop script against BOTH the ring and a one-queue
    ``QueueArray``, every observable compared step by step."""
    ring = ShmRing.create(_name("ring"), cap, W * 4)
    try:
        q = qmod.make_queues(1, W, cap)
        for do_push, do_pop, val in ops:
            assert ring.size() == int(qmod.size(q)[0])
            assert ring.free() == int(qmod.free(q)[0])
            assert ring.empty() == bool(qmod.empty(q)[0])
            assert ring.full() == bool(qmod.full(q)[0])
            payload = np.full((W,), val, np.float32)
            if do_pop:
                got = ring.pop_packets(1, np.float32, W)
                front, tail, valid = qmod.pop_single(q.buf[0], q.head[0], q.tail[0], cap)
                q.tail[0] = tail
                if bool(valid):
                    assert len(got) == 1
                    np.testing.assert_array_equal(got[0], front.numpy())
                else:
                    assert len(got) == 0
            if do_push:
                ok_ring = ring.push_packets(payload[None]) == 1
                buf, head, ok = qmod.push_single(q.buf[0], q.head[0], q.tail[0], cap,
                                                 torch.from_numpy(payload))
                q.buf[0] = buf
                q.head[0] = head
                assert ok_ring == bool(ok)
    finally:
        ring.close()


@pytest.mark.parametrize("seed", range(6))
def test_ring_matches_queue_semantics(seed):
    """Random push/pop interleavings at capacity 4: a 50-op script laps
    the 4-slot ring many times over."""
    rng = np.random.RandomState(seed)
    ops = [(bool(rng.randint(2)), bool(rng.randint(2)), float(rng.uniform(0, 100)))
           for _ in range(50)]
    _apply_script(ops, cap=4)


def test_ring_full_empty_edges():
    ring = ShmRing.create(_name("edge"), 4, 8)
    try:
        assert ring.empty() and not ring.full() and ring.free() == 3
        assert ring.pop_bytes() is None  # pop empty -> None
        for i in range(3):
            assert ring.push_packets(np.full((1, 2), float(i), np.float32)) == 1
        assert ring.full() and ring.free() == 0
        # push into a full ring is refused, like the paper's queue
        assert ring.push_packets(np.zeros((1, 2), np.float32)) == 0
        got = ring.pop_packets(10, np.float32, 2)
        np.testing.assert_array_equal(got[:, 0], [0.0, 1.0, 2.0])
        assert ring.empty()
    finally:
        ring.close()


def test_ring_batch_partial_and_wraparound():
    ring = ShmRing.create(_name("batch"), 5, 8)
    try:
        arr = np.arange(12, dtype=np.float32).reshape(6, 2)
        assert ring.push_packets(arr) == 4  # capacity-1 slots land
        assert ring.peek_packets(2, np.float32, 2).shape == (2, 2)
        ring.advance(2)
        assert ring.push_packets(arr) == 2  # wraps around the slot array
        got = ring.pop_packets(10, np.float32, 2)
        np.testing.assert_array_equal(got[:, 0], [4.0, 6.0, 0.0, 2.0])
        # slab + snapshot/restore round trip
        slab_ring = ShmRing.create(_name("slab"), 3, slab_slot_bytes(3, 2, 4))
        try:
            slab_ring.push_slab_wait(2, np.ones((3, 2), np.float32), 1.0)
            snap = slab_ring.snapshot()
            cnt, slab = slab_ring.pop_slab_wait((3, 2), np.float32, 1.0)
            assert cnt == 2
            slab_ring.restore(snap)
            cnt2, slab2 = slab_ring.pop_slab_wait((3, 2), np.float32, 1.0)
            assert cnt2 == cnt and np.array_equal(slab, slab2)
        finally:
            slab_ring.close()
    finally:
        ring.close()


@pytest.mark.parametrize("creator", ["port", "reference"])
@pytest.mark.parametrize("checked", [False, True])
def test_ring_layout_across_packages(creator, checked):
    """A ring one package creates, the other attaches: packets, slab
    records and u32 records written on either side read back the same
    bytes on the other, the seq counters and occupancy agree, and a
    snapshot is the same bytes."""
    mine, other = (tshm, jshm) if creator == "port" else (jshm, tshm)
    name = _name(f"x{creator}{int(checked)}")
    E, W = 3, 2
    slot = slab_slot_bytes(E, W, 4)
    a = mine.ShmRing.create(name, 4, slot, checked=checked)
    b = other.ShmRing.attach(name, 4, slot, checked=checked)
    try:
        slab = np.arange(E * W, dtype=np.float32).reshape(E, W)
        a.push_slab_wait(2, slab, 1.0)
        assert b.size() == 1 and b.free() == 2
        np.testing.assert_array_equal(a.snapshot(), b.snapshot())
        cnt, got = b.pop_slab_wait((E, W), np.float32, 1.0)
        assert cnt == 2 and np.array_equal(got, slab)
        # and back: one u32 record and a batch of packets from the attacher
        b.push_bytes_wait(np.uint32(41).tobytes() + bytes(slot - 4), 1.0)
        assert int(np.frombuffer(a.pop_bytes_wait(1.0)[:4], np.uint32)[0]) == 41
        assert a.seq_state() == b.seq_state()
        rows = np.full((3, slot // 4), 7.0, np.float32)
        assert b.push_packets(rows) == 3 and a.full()
        np.testing.assert_array_equal(a.pop_packets(3, np.float32, slot // 4), rows)
        assert a.empty() and b.empty()
    finally:
        b.close()
        a.close()


@pytest.mark.parametrize("creator", ["port", "reference"])
def test_corrupt_checked_record_raises_in_both(creator):
    """A checked record whose payload is flipped after its crc was stamped
    fails verification on either package's consumer, naming the channel
    and the crc mismatch; an unchecked credit ring carries u32 records
    both ways."""
    mine, other = (tshm, jshm) if creator == "port" else (jshm, tshm)
    for reader_pkg in (mine, other):
        name = _name(f"c{creator}")
        w = mine.ShmRing.create(name, 3, 8, checked=True, label="slab:c9")
        r = (w if reader_pkg is mine
             else reader_pkg.ShmRing.attach(name, 3, 8, checked=True, label="slab:c9"))
        try:
            w.corrupt_next_push()
            assert w.push_packets(np.ones((1, 2), np.float32)) == 1
            with pytest.raises(reader_pkg.RingCorruptionError, match="slab:c9.*crc32"):
                r.pop_packets(1, np.float32, 2)
        finally:
            if r is not w:
                r.close()
            w.close()
    name = _name(f"u{creator}")
    w = mine.ShmRing.create(name, 4, 4)
    r = other.ShmRing.attach(name, 4, 4)
    try:
        w.push_u32(61, 1.0)
        assert r.pop_u32_wait(1.0) == 61
        r.push_u32(5, 1.0)
        assert w.pop_u32_wait(1.0) == 5
    finally:
        r.close()
        w.close()


def test_sequence_slip_raises():
    """A checked ring whose consumer counter disagrees with the record's
    sequence number raises ``RingCorruptionError`` of kind "seq"."""
    ring = ShmRing.create(_name("seq"), 4, 8, checked=True, label="slab:c3")
    try:
        ring.push_packets(np.ones((2, 2), np.float32))
        ring.restore(ring.snapshot()[1:], seq=(2, 0))  # consumer expects seq 0
        with pytest.raises(RingCorruptionError) as exc:
            ring.pop_packets(1, np.float32, 2)
        assert exc.value.kind == "seq" and exc.value.actual == 1
    finally:
        ring.close()


def test_segment_keeps_no_descriptor():
    """Creating and attaching segments opens no file descriptor that
    outlives the call; closing the creator unlinks the name.  The
    collector runs first and stays off while the descriptors are counted,
    so that no finalizer of an earlier test's garbage closes one of its
    own descriptors between the two counts."""
    gc.collect()
    gc.disable()
    try:
        fds = len(os.listdir("/proc/self/fd"))
        rings = [ShmRing.create(_name(f"fd{i}"), 3, 4) for i in range(64)]
        peers = [ShmRing.attach(r.name, 3, 4) for r in rings]
        assert len(os.listdir("/proc/self/fd")) == fds
    finally:
        gc.enable()
    for p in peers:
        p.close()
    for r in rings:
        r.close()
        assert not os.path.exists(f"/dev/shm/{r.name}")
