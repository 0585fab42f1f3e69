"""repro_torch.runtime — the free-running multiprocess runtime, as in
``repro.runtime``.

The paper's deployment model, realized literally: one *prebuilt* granule
simulator per OS process, connected at runtime by lock-free shared-memory
SPSC queues, free-running with no global barrier.

  shmem            SPSC rings over POSIX shared memory, byte layout and
                   semantics bit-compatible with the reference's and with
                   core/queue.py (§III-B)
  worker           per-granule worker process: the granule state on its
                   device (its cycle graphs captured once on the card) +
                   credit-gated free run
  launcher         ProcsEngine — Network.build(engine="procs"): spawn,
                   wire, and drive the fleet behind the Simulation facade
  fault_tolerance  watchdogs, crash/restart loops, WorkerDiedError with
                   captured worker log tails, fleet stall diagnosis
                   (credit wait-for graph -> FleetStallError)
  faultinject      deterministic, plan-driven worker faults for drills
                   (REPRO_FAULT_PLAN: kill/exit0/hang/slow/mute/corrupt)
  recovery         coordinated snapshots + respawn/restore/replay — the
                   self-healing policy behind ProcsEngine(on_fault=
                   "recover") / REPRO_ON_FAULT
  bridge           TCP ring bridge proxies: a cross-host channel's local
                   ring pairs joined by one framed socket a host pair
  fleet            multi-host fleets (ProcsEngine(hosts=...) /
                   REPRO_HOSTS): host plans, the link map, rendezvous,
                   follower launchers and their control protocol
"""
from .fault_tolerance import FleetStallError, LinkDownError, WorkerDiedError
from .faultinject import FaultAction, parse_fault_plan
from .launcher import ProcsEngine, ProcsState
from .recovery import RECOVERABLE, RecoveryController, resolve_on_fault
from .shmem import RingCorruptionError, RingTimeout, ShmRing

__all__ = [
    "FaultAction", "FleetStallError", "LinkDownError", "ProcsEngine",
    "ProcsState", "RECOVERABLE", "RecoveryController", "RingCorruptionError",
    "RingTimeout", "ShmRing", "WorkerDiedError", "parse_fault_plan",
    "resolve_on_fault",
]
