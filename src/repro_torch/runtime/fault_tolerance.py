"""Fault tolerance & elasticity runtime, as in ``repro.runtime.fault_tolerance``.

Pieces (composed by the multiprocess simulation launcher,
``repro_torch.runtime.launcher``):

  * ``Watchdog`` — per-step timing with EWMA baseline; flags straggler steps
    (step > mean + k*sigma) and hung steps (> hard timeout).  On a real
    multi-host deployment the flags feed the coordinator; here they are
    logged and surfaced in metrics, and tests assert the detection logic.
  * ``run_resumable`` — the crash/restart loop: training state checkpoints
    every ``ckpt_every``; on any exception the loop restores the latest
    checkpoint (data-pipeline cursor included) and continues.  Elastic:
    the restore path reshard-places arrays onto whatever mesh the restarted
    process built (checkpoint/checkpointing.py).
  * ``FailureInjector`` — deterministic fault injection for tests/drills
    (the paper's cloud runs lose ECS tasks; we simulate that).
  * ``WorkerDiedError`` / ``ProcessMonitor`` — the free-running runtime's
    failure surface: the launcher polls worker liveness (ANY exit while
    replies are pending, clean or not) and per-epoch heartbeats while
    awaiting replies, and a dead or hung granule simulator raises a
    ``WorkerDiedError`` carrying the worker's captured log tail — a
    diagnosis, never a silent hang (``tests/test_torch_procs.py`` kills a
    worker mid-run to prove it).
  * ``FleetStallError`` + the stall-graph helpers — when no
    heartbeat advances fleet-wide, the per-worker "blocked on ring X"
    status words are decoded into a credit wait-for graph; a cycle is a
    true deadlock and raises ``FleetStallError`` naming it, an acyclic
    chain names its root worker instead.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Watchdog:
    ewma_alpha: float = 0.1
    sigma_k: float = 4.0
    hard_timeout_s: float = 600.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    stragglers: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> dict:
        flag = False
        if self.n >= 5:
            sd = math.sqrt(max(self.var, 1e-12))
            if dt > self.mean + self.sigma_k * sd and dt > 1.5 * self.mean:
                flag = True
                self.stragglers.append((step, dt))
        if self.n == 0:
            self.mean, self.var = dt, 0.0
        else:
            d = dt - self.mean
            self.mean += self.ewma_alpha * d
            self.var = (1 - self.ewma_alpha) * (self.var + self.ewma_alpha * d * d)
        self.n += 1
        return {
            "step_time_s": dt,
            "step_time_mean_s": self.mean,
            "straggler": flag,
            "hung": dt > self.hard_timeout_s,
        }


class WorkerDiedError(RuntimeError):
    """A granule worker process died (any unexpected exit, clean or not)
    or went silent past the heartbeat timeout.  The message carries the
    worker id, its exit status, and the tail of its captured log so the
    failure is diagnosable from the exception alone."""

    def __init__(self, worker: int, reason: str, log_tail: str = "",
                 label: str | None = None):
        self.worker = worker
        self.reason = reason
        self.log_tail = log_tail
        self.label = label or f"worker {worker}"
        msg = f"{self.label} {reason}"
        if log_tail:
            msg += f"\n--- {self.label} log tail ---\n{log_tail}"
        super().__init__(msg)


class LinkDownError(WorkerDiedError):
    """A TCP ring bridge died or its link dropped (the reference's
    ``runtime.bridge``; the port's bridge is ROADMAP Queue 1 item 10.3,
    so nothing in the port raises this yet).

    Subclasses ``WorkerDiedError`` so a recovery controller's RECOVERABLE
    surface covers it unchanged: a dead bridge is healed the same way as
    a dead worker — teardown, re-rendezvous, restore, replay.  ``worker``
    is the bridge's monitor id (``NW + local bridge index``); ``label``
    names the link."""


class FleetStallError(RuntimeError):
    """No heartbeat advanced fleet-wide AND the credit wait-for graph —
    reconstructed from the per-worker "blocked on ring X" status words in
    the heartbeat shm — contains a cycle: a true deadlock, not a slow or
    dead worker.  Carries the detected cycle so the diagnosis names the
    exact channels instead of a generic hang."""

    def __init__(self, cycle: list[int], details: list[str]):
        self.cycle = list(cycle)
        self.details = list(details)
        ring = " -> ".join(f"w{w}" for w in self.cycle + self.cycle[:1])
        msg = "fleet-wide stall: credit wait-for cycle " + ring
        if details:
            msg += "\n  " + "\n  ".join(details)
        super().__init__(msg)


# ------------------------------------------------------- stall diagnosis
# Workers publish a "blocked on ring X" status word in their heartbeat
# record before every blocking ring op (0 = running).  The launcher decodes
# those words into a wait-for graph over workers when the whole fleet goes
# quiet: pop-waits point at the ring's producer, push-waits at its consumer.
OP_CREDIT_POP, OP_SLAB_POP, OP_SLAB_PUSH, OP_CREDIT_PUSH = 1, 2, 3, 4
# A bridge proxy waiting on its TCP peer: nothing LOCAL holds it up, so
# it contributes no wait-for edge — if workers point at it, the bridge is
# the stall's root and gets named directly (never an innocent worker).
OP_LINK_WAIT = 5
STALL_OPS = {OP_CREDIT_POP: "credit-pop", OP_SLAB_POP: "slab-pop",
             OP_SLAB_PUSH: "slab-push", OP_CREDIT_PUSH: "credit-push",
             OP_LINK_WAIT: "link-wait"}
_STALL_BASE = 1_000_000


def encode_blocked(op: int, chan: int) -> int:
    """Status word for "blocked in ring op ``op`` on channel ``chan``"."""
    return op * _STALL_BASE + chan


def decode_blocked(code: int) -> tuple[int, int]:
    """Inverse of ``encode_blocked`` → (op, chan)."""
    return divmod(int(code), _STALL_BASE)


def stall_wait_edges(blocked: dict[int, int],
                     chan_workers: dict[int, tuple[int, int]],
                     ) -> tuple[dict[int, int], dict[int, str]]:
    """Wait-for edges ``waiter -> holder`` from per-worker status words.

    ``blocked`` maps worker -> status word (0 = not blocked);
    ``chan_workers`` maps channel id -> (producer_worker, consumer_worker)
    of the channel's slab direction.  On a bridged fleet the remote end
    of a cross-host channel is its local bridge proxy's monitor id, so
    the graph stays host-local and blames the bridge, not a worker.
    Self-edges (both ends of a channel batched into one worker) are
    dropped; ``OP_LINK_WAIT`` (a bridge waiting on its TCP peer)
    contributes no edge — nothing local holds it up.  Returns
    (edges, details)."""
    edges: dict[int, int] = {}
    details: dict[int, str] = {}
    for w, code in blocked.items():
        if code <= 0:
            continue
        op, chan = decode_blocked(code)
        if op == OP_LINK_WAIT:
            details[w] = f"member {w} blocked on its TCP link (c{chan})"
            continue
        if op not in STALL_OPS or chan not in chan_workers:
            continue
        sw, dw = chan_workers[chan]
        # Waiting to POP a slab (or PUSH a credit) → the slab producer is
        # behind; waiting to POP a credit (or PUSH a slab) → the consumer.
        peer = dw if op in (OP_CREDIT_POP, OP_SLAB_PUSH) else sw
        if peer == w:
            continue
        edges[w] = peer
        details[w] = (f"worker {w} blocked on {STALL_OPS[op]} c{chan} "
                      f"(w{sw}->w{dw}), held up by worker {peer}")
    return edges, details


def find_stall_cycle(edges: dict[int, int]) -> list[int] | None:
    """First cycle in a functional wait-for graph, or None."""
    for start in sorted(edges):
        path: list[int] = []
        seen: dict[int, int] = {}
        w = start
        while w in edges and w not in seen:
            seen[w] = len(path)
            path.append(w)
            w = edges[w]
        if w in seen:
            return path[seen[w]:]
    return None


def read_log_tail(path: str | None, max_bytes: int = 2048) -> str:
    """Last ``max_bytes`` of a worker's captured log ('' when absent)."""
    if not path or not os.path.exists(path):
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode(errors="replace").strip()
    except OSError:
        return ""


class ProcessMonitor:
    """Liveness/progress checks over a set of worker processes.

    ``check()`` raises ``WorkerDiedError`` for the first worker that (a)
    exited, or (b) — when a heartbeat reader is wired — made no progress
    for ``hang_timeout_s`` while a reply is pending.  Designed to be
    called from inside reply-wait loops, so a dead peer becomes an
    exception in bounded time instead of a hang.
    """

    def __init__(self, procs: dict[int, Any], log_paths: dict[int, str],
                 heartbeat: Callable[[int], float] | None = None,
                 hang_timeout_s: float = 120.0,
                 diagnose: Callable[[tuple[int, ...]], Exception | None]
                 | None = None,
                 labels: dict[int, str] | None = None,
                 link_ids: frozenset | set | None = None):
        self.procs = procs
        self.log_paths = log_paths
        self.heartbeat = heartbeat  # worker -> last-beat wallclock
        self.hang_timeout_s = hang_timeout_s
        self.diagnose = diagnose    # fleet-wide stall -> richer exception
        # Bridge proxies are first-class fleet members: ``labels`` names
        # them in diagnoses, ``link_ids`` routes their deaths to
        # ``LinkDownError`` so a dropped TCP link is distinguishable from
        # a dead granule worker (and both stay RECOVERABLE).
        self.labels = labels or {}
        self.link_ids = frozenset(link_ids or ())
        self._last_progress = {w: time.time() for w in procs}
        self._last_beat = {w: -1.0 for w in procs}

    def died(self, w: int, reason: str) -> WorkerDiedError:
        """The member-appropriate death exception (bridge -> LinkDownError)."""
        cls = LinkDownError if w in self.link_ids else WorkerDiedError
        return cls(w, reason, read_log_tail(self.log_paths.get(w)),
                   label=self.labels.get(w))

    def arm(self, w: int) -> None:
        """Start worker ``w``'s silence clock now: a command was just sent
        to it.  Between commands a worker beats nothing, so without this a
        launcher that paused longer than ``hang_timeout_s`` between two
        commands (a slow predicate, a user at a prompt) would find the
        worker "hung" at the next command's first check."""
        self._last_progress[w] = time.time()

    def check(self, waiting_on: tuple[int, ...] | None = None) -> None:
        now = time.time()
        for w, p in self.procs.items():
            if p is not None and p.exitcode is not None:
                # check() only runs while a reply is pending, so ANY exit
                # here — clean or not — is a fault.  exitcode 0 used to be
                # invisible to this check and only surfaced via the slow
                # heartbeat timeout.
                how = (f"died with exitcode {p.exitcode}" if p.exitcode
                       else "exited cleanly (exitcode 0) while replies "
                            "were still pending")
                raise self.died(w, how)
        if self.heartbeat is None or not waiting_on:
            return
        hung, quiet = [], []
        for w in waiting_on:
            beat = self.heartbeat(w)
            if beat != self._last_beat[w]:
                self._last_beat[w] = beat
                self._last_progress[w] = now
                continue
            silent = now - self._last_progress[w]
            if silent > self.hang_timeout_s:
                hung.append(w)
            if silent > self.hang_timeout_s / 2:
                quiet.append(w)
        if not hung:
            return
        # When EVERY pending worker has gone quiet (half-timeout grace
        # absorbs threshold-crossing skew), the hang is fleet-wide: hand
        # the full set to the diagnoser, which reconstructs the credit
        # wait-for graph and names the deadlock cycle / root worker.
        if self.diagnose is not None and set(quiet) >= set(waiting_on):
            exc = self.diagnose(tuple(waiting_on))
            if exc is not None:
                raise exc
        w = hung[0]
        raise self.died(
            w,
            f"made no progress for {self.hang_timeout_s:.0f}s "
            "(hung or deadlocked)",
        )


class FailureInjector:
    """Deterministic fault injection: fires once at each of the given
    (absolute) step numbers.  Without ``on_fail`` it raises RuntimeError
    (the training-loop drill); with it, the callback runs instead — the
    plan-driven worker faults of the reference's ``runtime.faultinject`` (kill,
    hang, corrupt-a-slab, ...) are built on this same trigger."""

    def __init__(self, fail_at: tuple[int, ...] = (),
                 on_fail: Callable[[int], None] | None = None):
        self.fail_at = set(fail_at)
        self.on_fail = on_fail

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            if self.on_fail is not None:
                self.on_fail(step)
                return
            raise RuntimeError(f"injected failure at step {step}")


def run_resumable(
    *,
    total_steps: int,
    make_state: Callable[[], Any],          # fresh (step0) training state
    restore_state: Callable[[], Any | None],  # latest checkpoint or None
    train_one: Callable[[Any, int], Any],    # state, step -> state
    save_state: Callable[[Any, int], None],
    ckpt_every: int = 50,
    max_restarts: int = 10,
    watchdog: Watchdog | None = None,
    on_metrics: Callable[[int, dict], None] | None = None,
) -> Any:
    """Crash-safe training loop: any exception -> restore + continue."""
    restarts = 0
    while True:
        try:
            restored = restore_state()
            if restored is None:
                state, step = make_state(), 0
            else:
                state, step = restored
            while step < total_steps:
                t0 = time.monotonic()
                state = train_one(state, step)
                step += 1
                if watchdog is not None:
                    m = watchdog.observe(step, time.monotonic() - t0)
                    if on_metrics:
                        on_metrics(step, m)
                if step % ckpt_every == 0 or step == total_steps:
                    save_state(state, step)
            return state
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any worker failure
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts") from e
            # loop: restore from latest checkpoint and continue
            continue
