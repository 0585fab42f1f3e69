"""Deterministic, plan-driven fault injection for the procs fleet, as in
``repro.runtime.faultinject``.

Drilling the recovery path needs *reproducible* losses.  A fault plan is
a comma-separated list of actions, each ``kind:worker@epoch`` with
optional ``:``-separated modifiers, e.g.::

    REPRO_FAULT_PLAN="kill:1@5"            # SIGKILL worker 1 before epoch 5
    REPRO_FAULT_PLAN="exit0:2@3"           # worker 2 exits CLEANLY mid-run
    REPRO_FAULT_PLAN="hang:0@4"            # worker 0 stops dead (no beats)
    REPRO_FAULT_PLAN="slow:1@2:0.05"       # +50ms per epoch from epoch 2 on
    REPRO_FAULT_PLAN="mute:1@2"            # worker 1 drops heartbeats
    REPRO_FAULT_PLAN="corrupt:0@2:c7"      # flip a byte in worker 0's next
                                           #   slab push on channel 7
    REPRO_FAULT_PLAN="kill:1@5, kill:1@9:r1"  # second kill arms only in
                                           #   fleet incarnation 1 (post-
                                           #   recovery), so drills can
                                           #   fault the REPLAY too
    REPRO_FAULT_PLAN="linkkill:0@3"        # kill bridge LINK 0's proxy
                                           #   (multi-host fleets only; the
                                           #   port's single-host launcher
                                           #   refuses link kinds)

Modifiers: ``r<N>`` — the fleet incarnation (restart count) the action
arms in, default 0, so a fired kill does not re-fire during the recovery
replay; ``c<N>`` — a channel id (``corrupt``); a bare float — seconds
(``slow``).

Execution is epoch-deterministic: each worker evaluates its actions at
the top of ``one_epoch``, before the epoch's first cycle-graph replay and
any ring operation, against its own ``epochs_done`` counter, through the
same ``fault_tolerance.FailureInjector`` trigger the training loop uses
(fire-once semantics), so a drill is bit-reproducible regardless of
fleet interleaving.  No fault lands inside a CUDA graph capture: the
captures happen at worker start, before any epoch.  The launcher filters
the plan per worker and per incarnation at spawn time and ships the
actions inside the spawn arguments — workers never re-parse the
environment (no double-fire).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Sequence

from .fault_tolerance import FailureInjector

#: Link (bridge-proxy) fault kinds: the action's target index is a
#: BRIDGE LINK index (the reference's ``runtime.fleet`` link map order),
#: not a worker —
#: ``linkkill:0@3`` kills link 0's bridge proxy at the epoch-3 command
#: boundary, ``linkslow:0@3:0.05`` stalls its pump 50ms, ``linkcorrupt``
#: flips a byte in its next forwarded slab frame ON THE WIRE (the far
#: consumer's seq+crc verification trips — end-to-end detection).  They
#: parse here; a single-host launcher refuses them (no bridged links).
LINK_KINDS = ("linkkill", "linkslow", "linkcorrupt")

KINDS = ("kill", "exit0", "hang", "slow", "mute", "corrupt") + LINK_KINDS

_TOKEN = re.compile(r"^(?P<kind>[a-z0-9]+):(?P<worker>\d+)@(?P<epoch>\d+)"
                    r"(?P<mods>(?::[^:,\s]+)*)$")


@dataclass(frozen=True)
class FaultAction:
    """One planned fault: do ``kind`` to ``worker`` just before it runs
    epoch ``epoch`` (its local ``epochs_done`` counter), in fleet
    incarnation ``restart``."""
    kind: str
    worker: int
    epoch: int
    arg: float | None = None   # slow: seconds/epoch; corrupt: channel id
    restart: int = 0           # fleet incarnation this action arms in

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")


def parse_fault_plan(text: str) -> tuple[FaultAction, ...]:
    """Parse a ``REPRO_FAULT_PLAN`` string into actions (see module doc)."""
    actions = []
    for token in re.split(r"[,\s]+", text.strip()):
        if not token:
            continue
        m = _TOKEN.match(token)
        if m is None:
            raise ValueError(
                f"bad fault-plan token {token!r}; expected "
                "kind:worker@epoch[:c<chan>][:r<restart>][:<seconds>]")
        arg, restart = None, 0
        for mod in m.group("mods").split(":"):
            if not mod:
                continue
            if re.fullmatch(r"r\d+", mod):
                restart = int(mod[1:])
            elif re.fullmatch(r"c\d+", mod):
                arg = float(mod[1:])
            else:
                arg = float(mod)  # raises ValueError on junk
        actions.append(FaultAction(m.group("kind"), int(m.group("worker")),
                                   int(m.group("epoch")), arg, restart))
    return tuple(actions)


def resolve_fault_plan(plan) -> tuple[FaultAction, ...]:
    """Resolve a constructor argument / env var into actions.

    Explicit non-None argument wins (a plan string or a sequence of
    ``FaultAction``); otherwise ``REPRO_FAULT_PLAN``; otherwise empty —
    the same precedence as the other runtime env knobs."""
    if plan is None:
        plan = os.environ.get("REPRO_FAULT_PLAN", "")
    if isinstance(plan, str):
        return parse_fault_plan(plan)
    return tuple(plan)


def actions_for(plan: Sequence[FaultAction], worker: int,
                incarnation: int) -> tuple[FaultAction, ...]:
    """The subset of a plan armed for one worker in one fleet incarnation
    (link actions are launcher-executed and never ship to workers)."""
    return tuple(a for a in plan
                 if a.worker == worker and a.restart == incarnation
                 and a.kind not in LINK_KINDS)


def split_plan(plan: Sequence[FaultAction],
               ) -> tuple[tuple[FaultAction, ...], tuple[FaultAction, ...]]:
    """(worker actions, link actions) — link faults target bridge links
    and are executed by the launcher at run boundaries, everything else
    ships to the targeted worker at spawn time."""
    return (tuple(a for a in plan if a.kind not in LINK_KINDS),
            tuple(a for a in plan if a.kind in LINK_KINDS))


class WorkerFaultInjector:
    """Executes a worker's armed actions at epoch boundaries.

    Built on ``FailureInjector`` (fire-once per action); the worker calls
    ``before_epoch(worker)`` at the top of every epoch."""

    def __init__(self, actions: Sequence[FaultAction]):
        self._worker = None
        self._armed = [
            (a, FailureInjector(fail_at=(a.epoch,),
                                on_fail=self._executor(a)))
            for a in actions
        ]

    def __bool__(self):
        return bool(self._armed)

    def before_epoch(self, worker) -> None:
        self._worker = worker
        for _, inj in self._armed:
            inj.maybe_fail(worker.epochs_done)

    # ------------------------------------------------------------- executors
    def _executor(self, a: FaultAction):
        return lambda _step: getattr(self, f"_do_{a.kind}")(a)

    def _log(self, a: FaultAction, what: str) -> None:
        """One log line a fired action, stamped with the wall clock (a
        drill reads it back from the worker's log to time detection)."""
        import sys
        import time
        print(f"[faultinject] epoch {self._worker.epochs_done} at "
              f"t={time.time():.6f}: {what} ({a.kind}:{a.worker}@{a.epoch})",
              flush=True)
        sys.stderr.flush()

    def _do_kill(self, a: FaultAction) -> None:
        import signal
        self._log(a, "SIGKILL self")
        os.kill(os.getpid(), signal.SIGKILL)

    def _do_exit0(self, a: FaultAction) -> None:
        # a CLEAN exit mid-run must still be flagged by
        # ProcessMonitor.check (exitcode 0 is not innocence)
        import sys
        self._log(a, "clean os._exit(0) mid-run")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

    def _do_hang(self, a: FaultAction) -> None:
        import time
        self._log(a, "hanging forever (heartbeats stop)")
        time.sleep(1e8)

    def _do_slow(self, a: FaultAction) -> None:
        self._worker.slow_per_epoch = float(a.arg if a.arg is not None
                                            else 0.05)
        self._log(a, f"straggling +{self._worker.slow_per_epoch}s/epoch")

    def _do_mute(self, a: FaultAction) -> None:
        self._worker.hb_muted = True
        self._log(a, "dropping heartbeats (process stays alive)")

    def _do_corrupt(self, a: FaultAction) -> None:
        w = self._worker
        chan = int(a.arg) if a.arg is not None else None
        ring = w.corruptible_ring(chan)
        ring.corrupt_next_push()
        self._log(a, f"corrupting next slab push on {ring.label}")
