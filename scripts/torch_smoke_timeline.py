"""Run phases of ``chip_smoke.py`` with a timeline: every log line gets
the seconds since start, and the helpers the fleet phases call
(``ProcsEngine``'s launch, gathers, close, the drills, ``gc.collect``)
log their own seconds as ``[prof] <name> <s> s``.  It shows where a
phase's wall time goes beyond the spans the phase itself reports.

Run it from the root of a checkout on a machine with one CUDA card, with
the phases as ``chip_smoke.py`` takes them:

    python3 scripts/torch_smoke_timeline.py --phases build,procs-full,fleet-full
"""
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

#: chip_smoke's helpers, then ProcsEngine's methods, that are timed
HELPERS = ("procs_wafer", "same_leaves", "graph_yardstick", "telemetry_run", "recover_epochs",
           "kill_drill", "fleet_cell", "link_drill", "single_host_done", "log_fleet_trace",
           "watch_incarnations", "snapshot_seconds", "arm_link_fault")
METHODS = ("close", "launch", "gather_group", "gather_state", "profile_epochs",
           "worker_stats", "fault_stats", "scatter_state")


def install() -> None:
    """Stamp ``chip_smoke.log`` and wrap the helpers in timers."""
    import gc

    from repro_torch.runtime.launcher import ProcsEngine

    t0 = time.perf_counter()
    plain_log = cs.log

    def log(msg: str) -> None:
        plain_log(f"{time.perf_counter() - t0:8.1f} {msg}")

    def timed(owner, name: str, label: str) -> None:
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrap(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                log(f"[prof] {label} {time.perf_counter() - t:.2f} s")
        setattr(owner, name, wrap)

    cs.log = log
    for name in HELPERS:
        timed(cs, name, name)
    for name in METHODS:
        timed(ProcsEngine, name, f"ProcsEngine.{name}")
    timed(gc, "collect", "gc.collect")


if __name__ == "__main__":  # the fleets' workers import this module again
    install()
    sys.exit(cs.main(sys.argv[1:]))
