"""Coordinated snapshots + automatic fleet recovery, as in
``repro.runtime.recovery``.

The free-running runtime's failure surface (``runtime.fault_tolerance``,
``runtime.shmem``) turns every fleet pathology into a typed exception:
``WorkerDiedError`` (dead or hung process), ``FleetStallError`` (credit
wait-for cycle), ``RingCorruptionError`` (seq/crc mismatch on a checked
ring), ``RingTimeout`` (worker-side ring deadline).  This module is the
policy layer above that surface: with ``ProcsEngine(on_fault="recover")``
(env ``REPRO_ON_FAULT``) those faults are *healed* instead of raised.

**Snapshot consistency.**  A coordinated snapshot is just
``gather_state`` taken at a command boundary: every worker has replied to
its ``run`` command, so the whole fleet sits at the SAME epoch with every
data ring empty, exactly one credit in flight per channel (asserted by
the gather), and the external rings quiescent.  That cut is consistent
by construction — no marker algorithm needed, the command protocol IS
the barrier.  The controller chunks ``run_epochs`` so a boundary lands on
every multiple of ``snapshot_every`` and snapshots there, and takes one
at each run entry whose epoch moved (under ``run(until=...)``, whose
procs loop runs one epoch a call, that is a snapshot every epoch, as in
the reference).

**Recovery sequence.**  On a recoverable fault mid-chunk:

  1. the detection path has already torn down the remnant fleet
     (``ProcsEngine.close()`` before the raise);
  2. back off ``backoff_s * 2**(restarts-1)`` (a crash loop must not spin);
  3. ``engine._reopen()`` — fresh ring namespace, fresh processes, same
     lowering.  The reference respawns against a warm persistent XLA
     cache; the port keeps none (a CUDA graph cannot outlive its
     process), so each new worker pays its CUDA context, its template
     state and the capture of its ``("C", n)`` graphs again;
  4. ``scatter_state`` the last snapshot (granule states, in-flight
     credits, external-ring packets AND their integrity seq counters);
  5. resume the chunk loop from the snapshot epoch — the lost epochs are
     simply re-run.

Replay determinism is inherited, not engineered: the runtime is bit-
identical to the lockstep engines from any quiesced state, so re-running
epochs ``s..t`` from the epoch-``s`` snapshot produces the same state and
the same host-visible traffic as the fault-free timeline.  Host I/O
between runs is handled by snapshot refresh: the engine reports every
host push/pop to the controller, and the controller re-captures just the
external rings (same epoch) or the full tree (epoch moved) before the
next run — so recovery never re-delivers packets the host already
popped, and never loses ones it pushed.  The reports double as a
**journal**: if the re-capture gather *itself* faults, the only state not
in the last snapshot is the host I/O performed at the current boundary —
so the journaled pops become re-delivery *discards* (the replay
regenerates those packets; the host-facing pop drops them) and the
journaled pushes are *re-injected* into their external rings exactly
when the replay reaches the boundary where the host originally pushed
them, keeping replayed ingress cycle-identical.

**MTTR model** (the reference measures it in
``benchmarks/fault_recovery.py``; ``chip_smoke.py`` ``procs-full`` splits
it on the card)::

    MTTR ≈ detect + backoff + respawn + restore + replay
    detect  ~ heartbeat timeout (kill: one poll interval via exitcode)
    respawn ~ forkserver fork + CUDA context + template + graph captures
    replay  ≤ snapshot_every * epoch_time  (the cadence knob)
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any

import numpy as np

from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from .fault_tolerance import FleetStallError, WorkerDiedError
from .shmem import RingCorruptionError, RingTimeout

#: Fleet faults the controller heals; anything else (a worker traceback,
#: a protocol bug) propagates — recovery must not mask logic errors.
RECOVERABLE = (WorkerDiedError, FleetStallError, RingCorruptionError,
               RingTimeout)

_POLICIES = ("raise", "recover")


def resolve_on_fault(on_fault: Any = "auto") -> str:
    """Resolve the fault policy: explicit argument > ``REPRO_ON_FAULT`` >
    default "raise" — the same precedence as the other runtime knobs."""
    if on_fault is None:
        on_fault = "auto"
    on_fault = str(on_fault).lower()
    if on_fault == "auto":
        on_fault = (os.environ.get("REPRO_ON_FAULT", "raise").lower()
                    or "raise")
    if on_fault not in _POLICIES:
        raise ValueError(
            f"on_fault={on_fault!r}: choose 'raise' or 'recover' "
            "(or 'auto' to defer to REPRO_ON_FAULT)"
        )
    return on_fault


class RecoveryController:
    """Snapshot cadence + respawn/restore/replay policy for one engine.

    Deliberately knows the engine only through its public protocol plus
    a handful of recovery hooks (``_run_epochs_raw``, ``_reopen``,
    ``_handle_at``, ``_replay_ext_push``, ``_set_ext_discard``,
    ``_ext_discard_state``) — no launcher import, no ring knowledge."""

    def __init__(self, engine, *, snapshot_every: int = 16,
                 max_restarts: int = 3, backoff_s: float = 0.25):
        self.engine = engine
        self.snapshot_every = max(1, int(snapshot_every))
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.restarts = 0
        self.snapshots = 0
        self.recovered_epochs = 0
        self._snapshot = None
        self._snapshot_epoch = -1
        self._ext_dirty = False
        self._last_recovery: dict | None = None
        # host-I/O journal since the snapshot's ext capture (pushes keep
        # their payloads, pops just a count), plus the recovery carry-over
        # it folds into: pending re-injections [(epoch, {port: [batch]})]
        # and the (discards, injections) pair frozen with the snapshot
        self._jrnl_push: dict[str, list] = {}
        self._jrnl_pop: dict[str, int] = {}
        self._inject: list[tuple] = []
        self._snap_host: tuple = ({}, [])

    # ------------------------------------------------- engine notifications
    def note_reset(self) -> None:
        """``init`` rewound the fleet — any snapshot is from a dead
        timeline."""
        self._snapshot = None
        self._snapshot_epoch = -1
        self._ext_dirty = False
        self._jrnl_push, self._jrnl_pop = {}, {}
        self._inject = []
        self._snap_host = ({}, [])
        self.engine._set_ext_discard({})

    def note_ext_push(self, state, name: str, batch) -> None:
        """Host pushed ``batch`` into external ring ``name``: mark the
        snapshot ext-dirty AND journal the payloads — if the repair
        gather faults, these are the packets a rewind would lose."""
        if self._snapshot is not None:
            self._ext_dirty = True
            self._jrnl_push.setdefault(name, []).append(
                np.array(batch, copy=True))

    def note_ext_pop(self, state, name: str, n: int) -> None:
        """Host popped ``n`` packets from external ring ``name``: if the
        repair gather faults, a rewound replay regenerates them — the
        journal count becomes the re-delivery discard."""
        if self._snapshot is not None:
            self._ext_dirty = True
            self._jrnl_pop[name] = self._jrnl_pop.get(name, 0) + int(n)

    def note_scatter(self) -> None:
        """An explicit user restore replaced the fleet's history — the
        snapshot no longer describes the current timeline."""
        self._snapshot = None
        self._snapshot_epoch = -1
        self._ext_dirty = False
        self._jrnl_push, self._jrnl_pop = {}, {}
        self._inject = []
        self._snap_host = ({}, [])
        self.engine._set_ext_discard({})

    # ------------------------------------------------------------ main loop
    def run_epochs(self, state, n_epochs: int):
        """Chunked run: a command boundary (and a snapshot) on every
        multiple of ``snapshot_every``; any recoverable fault inside a
        chunk triggers respawn + restore + replay of that chunk.  Chunks
        additionally cut at pending re-injection boundaries so journaled
        host pushes re-enter their rings at the exact epoch the host
        originally pushed them."""
        eng = self.engine
        target = int(state.epoch) + int(n_epochs)
        try:
            self._ensure_snapshot(state)
        except RECOVERABLE as fault:
            # a fault can surface inside the gather itself (a worker that
            # died since the last command) — recoverable only if an
            # earlier snapshot exists to rewind to
            if self._snapshot is None:
                raise
            state = self._recover(fault, state)
        while True:
            try:
                self._apply_inject(state)
                here = int(state.epoch)
                if here >= target:
                    return state
                nxt = min(target, self._next_boundary(here))
                for e, _ in self._inject:
                    if here < e < nxt:
                        nxt = e
                state = eng._run_epochs_raw(state, nxt - here)
                if (int(state.epoch) % self.snapshot_every == 0
                        and int(state.epoch) != self._snapshot_epoch):
                    self._take_snapshot(state)
            except RECOVERABLE as fault:
                state = self._recover(fault, state)

    def _next_boundary(self, epoch: int) -> int:
        return (epoch // self.snapshot_every + 1) * self.snapshot_every

    def _apply_inject(self, state) -> None:
        """Re-push journaled host payloads whose boundary the replay has
        reached — replayed epochs then see ingress identical to the
        faulted timeline's."""
        here = int(state.epoch)
        while self._inject and self._inject[0][0] <= here:
            _, pushes = self._inject.pop(0)
            for name, batches in pushes.items():
                for batch in batches:
                    self.engine._replay_ext_push(name, batch)

    # ------------------------------------------------------------ snapshots
    def _absorb_host_io(self) -> None:
        """The snapshot (or its ext refresh) now covers every host push
        and pop so far: drop the journal and freeze the recovery
        carry-over (pending discards + injections) alongside it."""
        self._jrnl_push, self._jrnl_pop = {}, {}
        self._ext_dirty = False
        self._snap_host = (self.engine._ext_discard_state(),
                           list(self._inject))

    def _take_snapshot(self, state) -> None:
        t0 = time.monotonic()
        self._snapshot = self.engine.gather_state(state)
        self._snapshot_epoch = int(state.epoch)
        self._absorb_host_io()
        self.snapshots += 1
        dur = time.monotonic() - t0
        REGISTRY.observe("recovery.snapshot.s", dur)
        _trace.span("snapshot", t0, dur, cat="recovery",
                    args={"epoch": self._snapshot_epoch,
                          "incarnation": int(self.engine._incarnation)})

    def _ensure_snapshot(self, state) -> None:
        """Entering a run: make the snapshot describe the CURRENT quiesced
        fleet, so a fault in the first chunk has something exact to
        restore.  Host I/O since the last snapshot only touched the
        external rings (the fleet was idle), so an unchanged epoch needs
        only the cheap ext-entry refresh; a moved epoch (user scattered or
        ran through another path) needs the full gather."""
        if self._snapshot is None or int(state.epoch) != self._snapshot_epoch:
            self._take_snapshot(state)
        elif self._ext_dirty:
            self._snapshot["ext"] = self.engine._gather_ext()
            self._absorb_host_io()

    # ------------------------------------------------------------- recovery
    def _recover(self, fault, state):
        eng = self.engine
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"fleet recovery exhausted after {self.max_restarts} "
                f"restart(s); last fault: {type(fault).__name__}: {fault}"
            ) from fault
        assert self._snapshot is not None  # _ensure_snapshot ran first
        t0 = time.perf_counter()
        delay = self.backoff_s * (2 ** (self.restarts - 1))
        replay = int(state.epoch) - self._snapshot_epoch
        # Fold any un-absorbed host-I/O journal into the snapshot-paired
        # carry-over: the journal holds exactly the I/O the host performed
        # at the current (quiesced) boundary — the only state the snapshot
        # misses when the repair gather itself faulted.  Pops become
        # re-delivery discards, pushes a re-injection pinned to this
        # boundary's epoch.  Folding first makes a second fault idempotent.
        disc, pend = self._snap_host
        disc, pend = dict(disc), list(pend)
        if self._jrnl_pop or self._jrnl_push:
            for name, n in self._jrnl_pop.items():
                disc[name] = disc.get(name, 0) + int(n)
            if self._jrnl_push:
                pend.append((int(state.epoch),
                             {k: list(v) for k, v in self._jrnl_push.items()}))
            self._snap_host = (disc, pend)
            self._jrnl_push, self._jrnl_pop = {}, {}
        print(
            f"[recovery] {type(fault).__name__} at epoch >= "
            f"{int(state.epoch)}: restart {self.restarts}/"
            f"{self.max_restarts}, backoff {delay:.2f}s, restoring epoch "
            f"{self._snapshot_epoch}",
            file=sys.stderr, flush=True,
        )
        if delay > 0:
            time.sleep(delay)
        snap, snap_epoch = self._snapshot, self._snapshot_epoch
        eng._reopen()
        handle = eng._handle_at(snap_epoch)
        handle = eng.scatter_state(handle, snap)
        # scatter_state drops the snapshot AND the host carry-over (it
        # can't tell a user restore from ours) — reinstate both: the
        # restored fleet IS the snapshot, and the replay it is about to
        # re-run owes the host the journaled discards + injections
        self._snapshot, self._snapshot_epoch = snap, int(handle.epoch)
        self._ext_dirty = False
        self._snap_host = (disc, pend)
        self._inject = sorted(pend, key=lambda ep: ep[0])
        eng._set_ext_discard(dict(disc))
        self.recovered_epochs += max(0, replay)
        self._last_recovery = {
            "fault": type(fault).__name__,
            "restored_epoch": self._snapshot_epoch,
            "confirmed_epochs_replayed": max(0, replay),
            "backoff_s": delay,
            "restore_seconds": time.perf_counter() - t0,
        }
        REGISTRY.inc("recovery.restarts")
        REGISTRY.observe("recovery.restore.s",
                         self._last_recovery["restore_seconds"])
        _trace.instant("recovery_incident", cat="recovery",
                       args={**self._last_recovery,
                             "incarnation": int(eng._incarnation)})
        return handle

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "policy": self.engine.on_fault,
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "snapshot_every": self.snapshot_every,
            "snapshots": self.snapshots,
            "last_snapshot_epoch": self._snapshot_epoch,
            "recovered_epochs": self.recovered_epochs,
            "incarnation": self.engine._incarnation,
            "last_recovery": (dict(self._last_recovery)
                              if self._last_recovery else None),
        }
