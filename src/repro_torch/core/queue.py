"""SPSC queues as ring buffers (paper §III-B), as in ``repro.core.queue``.

The paper's queue is a 4KB page: 4B head (next write), 4B tail (next read),
and 62 slots of 64B packets.  Semantics reproduced exactly:

  * write: ``next_head = (head+1) % capacity``; FULL if ``next_head == tail``;
    otherwise write slot ``head`` and advance.
  * read:  EMPTY if ``tail == head``; otherwise read slot ``tail`` and advance.

so a queue of capacity C holds at most C-1 packets.

A ``QueueArray`` stores N queues with stacked buffers, and every operation
is masked and batched over them.  Operations are functional: they return
new tensors and leave their inputs untouched.  The ones a graph-engine
cycle and exchange run (:func:`cycle`, :func:`stage_drain`,
:func:`stage_fill`) have in-place twins (:func:`cycle_`,
:func:`stage_drain_`, :func:`stage_fill_`) that write ``buf``/``head``/
``tail`` where they lie, with the same bits and no host sync (no boolean
indexing), for a state the engine owns on the card: the functional form
copies the whole buffer each call.  ``%`` on tensors is
``torch.remainder``, which takes the divisor's sign like Python and
``jnp``, so ``(head - tail) % capacity`` is never negative.
"""
from __future__ import annotations

import torch

from .struct import static_field, tensor_dataclass

# Paper default: 62 packet slots per queue (4KB page / 64B packets).
DEFAULT_CAPACITY = 62


@tensor_dataclass
class QueueArray:
    """``n`` SPSC ring buffers with a shared capacity and payload width.

    buf:  (n, capacity, payload_words) payload storage
    head: (n,) int32 — next slot to write
    tail: (n,) int32 — next slot to read
    """

    buf: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor
    capacity: int = static_field(default=DEFAULT_CAPACITY)

    @property
    def n(self) -> int:
        return self.buf.shape[0]

    @property
    def payload_words(self) -> int:
        return self.buf.shape[2]


def make_queues(
    n: int,
    payload_words: int,
    capacity: int = DEFAULT_CAPACITY,
    dtype=torch.float32,
    device=None,
) -> QueueArray:
    return QueueArray(
        buf=torch.zeros((n, capacity, payload_words), dtype=dtype, device=device),
        head=torch.zeros((n,), dtype=torch.int32, device=device),
        tail=torch.zeros((n,), dtype=torch.int32, device=device),
        capacity=capacity,
    )


# --------------------------------------------------------------------------
# Occupancy queries (pre-cycle snapshot reads).
# --------------------------------------------------------------------------

def size(q: QueueArray) -> torch.Tensor:
    """(n,) number of packets currently enqueued."""
    return (q.head - q.tail) % q.capacity


def free(q: QueueArray) -> torch.Tensor:
    """(n,) number of packets that can still be pushed (capacity-1 max)."""
    return (q.capacity - 1) - size(q)


def empty(q: QueueArray) -> torch.Tensor:
    return q.head == q.tail


def full(q: QueueArray) -> torch.Tensor:
    return (q.head + 1) % q.capacity == q.tail


def peek(q: QueueArray) -> tuple[torch.Tensor, torch.Tensor]:
    """Front packet of every queue: ((n, W) payload, (n,) valid)."""
    rows = torch.arange(q.n, device=q.buf.device)
    return q.buf[rows, q.tail.long()], ~empty(q)


def _ring_index(start: torch.Tensor, k: int, capacity: int) -> torch.Tensor:
    """(..., k) slot indices ``(start + offs) % capacity``, int64."""
    offs = torch.arange(k, dtype=torch.int32, device=start.device)
    return ((start.unsqueeze(-1) + offs) % capacity).long()


# --------------------------------------------------------------------------
# Single-cycle handshake update (paper §II-A bridge semantics).
# --------------------------------------------------------------------------

def cycle(
    q: QueueArray,
    push_payload: torch.Tensor,
    push_valid: torch.Tensor,
    pop_ready: torch.Tensor,
) -> tuple[QueueArray, torch.Tensor, torch.Tensor]:
    """Apply one simulation cycle of handshakes to all queues at once.

    Per queue: the producer drives ``(push_payload, push_valid)`` and sees
    ``ready = ~full`` (pre-cycle); the consumer sees ``(front, ~empty)``
    (pre-cycle) and drives ``pop_ready``.  Both handshakes may fire in the
    same cycle — push touches ``head``, pop touches ``tail``, so they
    commute.  Returns (new_queues, did_push, did_pop).
    """
    do_push = push_valid & ~full(q)
    do_pop = pop_ready & ~empty(q)
    rows = torch.arange(q.n, device=q.buf.device)
    h = q.head.long()
    buf = q.buf.clone()
    buf[rows, h] = torch.where(
        do_push[:, None], push_payload.to(buf.dtype), q.buf[rows, h]
    )
    head = torch.where(do_push, (q.head + 1) % q.capacity, q.head)
    tail = torch.where(do_pop, (q.tail + 1) % q.capacity, q.tail)
    return q.replace(buf=buf, head=head, tail=tail), do_push, do_pop


def cycle_(
    q: QueueArray,
    push_payload: torch.Tensor,
    push_valid: torch.Tensor,
    pop_ready: torch.Tensor,
) -> tuple[QueueArray, torch.Tensor, torch.Tensor]:
    """:func:`cycle` in place: the same bits written into ``q``'s own
    ``buf``, ``head`` and ``tail`` (one slot a queue, its head's, read and
    written back).  Returns (q, did_push, did_pop)."""
    do_push = push_valid & ~full(q)
    do_pop = pop_ready & ~empty(q)
    rows = torch.arange(q.n, device=q.buf.device)
    h = q.head.long()
    q.buf[rows, h] = torch.where(
        do_push[:, None], push_payload.to(q.buf.dtype), q.buf[rows, h]
    )
    q.head.copy_(torch.where(do_push, (q.head + 1) % q.capacity, q.head))
    q.tail.copy_(torch.where(do_pop, (q.tail + 1) % q.capacity, q.tail))
    return q, do_push, do_pop


# --------------------------------------------------------------------------
# Single-queue host-side handshakes (external-port I/O) on one queue's raw
# (capacity, W) storage, so engines never re-implement the ring arithmetic.
# --------------------------------------------------------------------------

def push_single(buf, head, tail, capacity, payload):
    """Push ``payload`` into one queue. Returns (buf, head, did_push)."""
    ok = (head + 1) % capacity != tail
    out = buf.clone()
    out[head.long()] = torch.where(ok, payload.to(buf.dtype), buf[head.long()])
    return out, torch.where(ok, (head + 1) % capacity, head), ok


def pop_single(buf, head, tail, capacity):
    """Pop one queue's front. Returns (front, tail, did_pop)."""
    valid = head != tail
    return buf[tail.long()], torch.where(valid, (tail + 1) % capacity, tail), valid


def fill_single(buf, head, tail, capacity, payloads, limit=None):
    """Push up to ``len(payloads)`` packets into one queue (host batch I/O).

    payloads: (k, W) with k <= capacity-1.  Packets beyond the queue's free
    space are NOT written (the host-side caller keeps them buffered).
    ``limit`` optionally caps the count further.  Returns
    (buf, head, n_pushed).
    """
    k = payloads.shape[0]
    if k > capacity - 1:
        raise ValueError(f"fill_single: {k} packets > capacity-1={capacity - 1}")
    n_free = (capacity - 1) - (head - tail) % capacity
    count = torch.clamp(n_free.to(torch.int32), max=k)
    if limit is not None:
        count = torch.minimum(count, torch.as_tensor(limit, dtype=torch.int32,
                                                     device=count.device))
    idx = _ring_index(head, k, capacity)
    offs = torch.arange(k, device=buf.device)
    out = buf.clone()
    out[idx] = torch.where((offs < count)[:, None], payloads.to(buf.dtype), buf[idx])
    return out, (head + count) % capacity, count


def drain_single(buf, head, tail, capacity, max_n: int, limit=None):
    """Pop up to ``max_n`` packets from one queue (host batch I/O).
    Returns (payloads (max_n, W), tail, count); rows beyond ``count`` are
    stale and must be masked by the caller."""
    n_avail = (head - tail) % capacity
    count = torch.clamp(n_avail, max=max_n).to(torch.int32)
    if limit is not None:
        count = torch.minimum(count, torch.as_tensor(limit, dtype=torch.int32,
                                                     device=count.device))
    idx = _ring_index(tail, max_n, capacity)
    return buf[idx], (tail + count) % capacity, count


# --------------------------------------------------------------------------
# Host-port operations on one queue of a QueueArray, addressed by ``idx``
# (an int row for the single netlist, a (dev..., row) tuple for the
# partitioned engines).
# --------------------------------------------------------------------------

def _set(x: torch.Tensor, idx, value) -> torch.Tensor:
    out = x.clone()
    out[idx] = value
    return out


def host_push(q: QueueArray, idx, payload):
    """Push one packet into queue ``idx``.  Returns (queues, did_push)."""
    buf, head, ok = push_single(
        q.buf[idx], q.head[idx], q.tail[idx], q.capacity, payload
    )
    return q.replace(buf=_set(q.buf, idx, buf), head=_set(q.head, idx, head)), ok


def host_pop(q: QueueArray, idx):
    """Pop queue ``idx``'s front.  Returns (queues, front, valid)."""
    front, tail, valid = pop_single(q.buf[idx], q.head[idx], q.tail[idx], q.capacity)
    return q.replace(tail=_set(q.tail, idx, tail)), front, valid


def host_push_many(q: QueueArray, idx, payloads):
    """Batched push into queue ``idx``: what fits lands, the rest is
    refused (count returned) — oversize batches are truncated to the ring
    maximum of capacity-1, never an error.  Returns (queues, n_pushed)."""
    payloads = payloads[: q.capacity - 1]
    buf, head, n = fill_single(
        q.buf[idx], q.head[idx], q.tail[idx], q.capacity, payloads
    )
    return q.replace(buf=_set(q.buf, idx, buf), head=_set(q.head, idx, head)), n


def host_pop_many(q: QueueArray, idx, max_n: int):
    """Batched pop from queue ``idx``.  Returns (queues, payloads
    (max_n, W), count); rows beyond count are stale."""
    pays, tail, cnt = drain_single(
        q.buf[idx], q.head[idx], q.tail[idx], q.capacity, max_n
    )
    return q.replace(tail=_set(q.tail, idx, tail)), pays, cnt


# --------------------------------------------------------------------------
# Epoch (bulk) operations — used by the tier exchange.  These move up to
# ``max_n`` packets per queue in one op.
# --------------------------------------------------------------------------

def drain(q: QueueArray, max_n: int, limit: torch.Tensor | None = None):
    """Pop up to ``max_n`` packets from each queue.

    limit: optional (n,) per-queue cap (credit count from the receiver).
    Returns (new_queues, payloads (n, max_n, W), count (n,)).
    Slots beyond ``count`` contain stale data; consumers must mask by count.
    """
    count = torch.clamp(size(q), max=max_n).to(torch.int32)
    if limit is not None:
        count = torch.minimum(count, limit.to(torch.int32))
    idx = _ring_index(q.tail, max_n, q.capacity)  # (n, max_n)
    W = q.buf.shape[2]
    payloads = torch.gather(q.buf, 1, idx[:, :, None].expand(-1, -1, W))
    return q.replace(tail=(q.tail + count) % q.capacity), payloads, count


def fill(q: QueueArray, payloads: torch.Tensor, count: torch.Tensor) -> QueueArray:
    """Push ``count[i]`` packets from ``payloads[i]`` into queue i.

    Counts are clamped to ``free(q)``.  ``max_n <= capacity-1`` keeps every
    row's slot window free of wrap-around aliases, so the scatter is unique.
    """
    max_n = payloads.shape[1]
    if max_n > q.capacity - 1:
        raise ValueError(
            f"fill: max_n={max_n} must be <= capacity-1={q.capacity - 1}"
        )
    count = torch.minimum(count.to(torch.int32), free(q))
    idx = _ring_index(q.head, max_n, q.capacity)  # (n, max_n)
    W = q.buf.shape[2]
    idx3 = idx[:, :, None].expand(-1, -1, W)
    offs = torch.arange(max_n, device=q.buf.device)
    rows = torch.where(
        (offs[None, :] < count[:, None])[:, :, None],
        payloads.to(q.buf.dtype), torch.gather(q.buf, 1, idx3),
    )
    buf = q.buf.clone().scatter_(1, idx3, rows)
    return q.replace(buf=buf, head=(q.head + count) % q.capacity)


def _sub(q: QueueArray, idx: torch.Tensor) -> QueueArray:
    return QueueArray(buf=q.buf[idx], head=q.head[idx], tail=q.tail[idx],
                      capacity=q.capacity)


def stage_drain(
    q: QueueArray, idx: torch.Tensor, max_n: int,
    limit: torch.Tensor | None = None,
):
    """Drain up to ``max_n`` packets from queue rows ``idx`` into a slab.

    The tier-exchange staging primitive: one gather selects the egress
    rows, one bulk :func:`drain` empties them into a contiguous
    ``(len(idx), max_n, W)`` slab (credit-bounded when ``limit`` is
    given).  Only rows whose count is above 0 are written back, so padding
    ``idx`` entries (masked by a 0 ``limit``) never write, even when
    duplicated.  Returns ``(new_q, slab, count)``.
    """
    idx = idx.long()
    sub2, slab, count = drain(_sub(q, idx), max_n, limit=limit)
    sel = count > 0
    tail = q.tail.clone()
    tail[idx[sel]] = sub2.tail[sel]
    return q.replace(tail=tail), slab, count


def stage_fill(
    q: QueueArray, idx: torch.Tensor, payloads: torch.Tensor, count: torch.Tensor,
) -> QueueArray:
    """Land a slab into queue rows ``idx`` — the inverse of
    :func:`stage_drain`.

    ``payloads``: (len(idx), max_n, W); ``count``: (len(idx),).  Rows whose
    count (after clamping to the free space) is 0 are not written, so
    duplicate padding indices never write.
    """
    idx = idx.long()
    sub = _sub(q, idx)
    sel = torch.minimum(count.to(torch.int32), free(sub)) > 0
    sub2 = fill(sub, payloads, count)
    buf, head = q.buf.clone(), q.head.clone()
    buf[idx[sel]] = sub2.buf[sel]
    head[idx[sel]] = sub2.head[sel]
    return q.replace(buf=buf, head=head)


def stage_drain_(
    q: QueueArray, idx: torch.Tensor, max_n: int,
    limit: torch.Tensor | None = None,
):
    """:func:`stage_drain` in place.  Every staged row's tail is written
    back, a row whose count is 0 with the value it had, so padding ``idx``
    entries that repeat one scratch row all write that row's own tail and
    the result does not depend on the scatter's order.  Returns
    ``(q, slab, count)``."""
    idx = idx.long()
    sub = _sub(q, idx)
    sub2, slab, count = drain(sub, max_n, limit=limit)
    q.tail[idx] = torch.where(count > 0, sub2.tail, sub.tail)
    return q, slab, count


def stage_fill_(
    q: QueueArray, idx: torch.Tensor, payloads: torch.Tensor, count: torch.Tensor,
) -> QueueArray:
    """:func:`stage_fill` in place.  Every staged row is written back, a row
    that takes no packet with what it held, so repeated padding rows write
    one value whatever the scatter's order.  Returns ``q``."""
    idx = idx.long()
    sub = _sub(q, idx)
    sel = torch.minimum(count.to(torch.int32), free(sub)) > 0
    sub2 = fill(sub, payloads, count)
    q.buf[idx] = torch.where(sel[:, None, None], sub2.buf, sub.buf)
    q.head[idx] = torch.where(sel, sub2.head, sub.head)
    return q
