"""Op-level roofline terms of one step: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the optimized HLO of a compiled step.  The port
emits no HLO; it counts the aten ops the step dispatches
(``obs.op_counts.count``, re-exported here: ``with count() as c:
step(*args)``), the hand-written kernels by their plain versions'
counts.  Nothing is fused, so the bytes are an upper bound on the step's
HBM traffic.

``roofline_terms`` gives the reference's keys; the terms are the counts
of the program dispatched on one card, against the H100's published
peaks (989 TFLOP/s bf16 dense, 3.35 TB/s HBM; ``chip_smoke.py`` prints
the card's name and power limit beside every number).  One card has no
collectives: ``collective_s`` is 0.
"""
from __future__ import annotations

from ..obs.op_counts import Counts, count

PEAK_FLOPS = 989e12   # bf16 dense, one H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12      # bytes/s, one H100 SXM


# ------------------------------------------------------------- terms
def roofline_terms(counts: Counts, n_chips: int = 1, **_) -> dict:
    """The reference's roofline terms (seconds a step, a chip) and totals
    from a step's counts; the port's counts are one card's program."""
    return {
        "compute_s": counts.flops / PEAK_FLOPS,
        "memory_s": counts.bytes / HBM_BW,
        "collective_s": 0.0,
        "hlo_flops": counts.flops * n_chips,
        "hlo_flops_per_chip": counts.flops,
        "hlo_bytes_per_chip": counts.bytes,
        "collective_wire_bytes": 0.0,
        "collective_counts": {},
        "collective_raw_bytes": {},
    }


def dominant_term(terms: dict) -> str:
    trio = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(trio, key=trio.get)


__all__ = ["Counts", "HBM_BW", "PEAK_FLOPS", "count", "dominant_term", "roofline_terms"]
