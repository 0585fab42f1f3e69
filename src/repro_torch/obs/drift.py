"""Perfmodel drift detection: measured phase times vs predictions, as in
``repro.obs.drift``.

The telemetry ring (``obs.telemetry``) measures a procs worker's phase
costs directly.  This module closes the loop: fold the measured per-phase
means back into ``core/perfmodel``'s epoch-time predictions and surface
the relative error as the ``perfmodel.model_drift`` gauge — a large
drift means the analytic model (used to pick worker counts and overlap
mode) no longer describes the machine the fleet is actually running on.
"""
from __future__ import annotations

from ..core import perfmodel

#: phases folded into the communication term of the perfmodel.
COMM_PHASES = ("exchange_issue", "exchange_commit")
#: phases folded into the residual (per-epoch fixed work).
RESIDUAL_PHASES = ("ingest", "flush")


def _mean(snapshot: dict, name: str) -> float:
    m = snapshot.get(name)
    if isinstance(m, dict):
        return float(m.get("mean", 0.0))
    return 0.0


def phase_means(snapshot: dict, prefix: str = "procs") -> dict:
    """Per-epoch mean seconds per phase from a registry snapshot.

    ``exchange_issue``/``exchange_commit`` histograms record one sample
    per (tier, epoch), so their per-epoch cost is ``mean * samples /
    epoch_samples``; ``step``/``ingest``/``flush``/``epoch`` record one
    sample per epoch.
    """
    out: dict = {}
    epoch_h = snapshot.get(f"{prefix}.phase.epoch.s")
    n_epochs = int(epoch_h.get("count", 0)) if isinstance(epoch_h, dict) \
        else 0
    for phase in ("step", "ingest", "flush", "epoch"):
        out[phase] = _mean(snapshot, f"{prefix}.phase.{phase}.s")
    for phase in COMM_PHASES:
        h = snapshot.get(f"{prefix}.phase.{phase}.s")
        if isinstance(h, dict) and n_epochs > 0:
            out[phase] = float(h.get("sum", 0.0)) / n_epochs
        else:
            out[phase] = _mean(snapshot, f"{prefix}.phase.{phase}.s")
    return out


def compute_drift(snapshot: dict, *, overlap: bool = False,
                  prefix: str = "procs", registry=None) -> dict:
    """Compare measured epoch time against the perfmodel prediction.

    Returns ``{t_step, t_comm, t_residual, predicted_s, measured_s,
    model_drift}`` (empty dict when the snapshot holds no epoch
    samples).  When ``registry`` is given, also publishes
    ``perfmodel.model_drift`` / ``perfmodel.predicted_epoch.s`` /
    ``perfmodel.measured_epoch.s`` gauges.
    """
    means = phase_means(snapshot, prefix)
    measured = means.get("epoch", 0.0)
    if measured <= 0.0:
        return {}
    t_step = means.get("step", 0.0)
    t_comm = sum(means.get(p, 0.0) for p in COMM_PHASES)
    t_residual = sum(means.get(p, 0.0) for p in RESIDUAL_PHASES)
    if overlap:
        predicted = perfmodel.overlapped_epoch_time(t_step, t_comm,
                                                    t_residual)
    else:
        predicted = perfmodel.serial_epoch_time(t_step, t_comm, t_residual)
    drift = abs(measured - predicted) / measured
    out = {
        "t_step": t_step,
        "t_comm": t_comm,
        "t_residual": t_residual,
        "predicted_s": predicted,
        "measured_s": measured,
        "model_drift": drift,
    }
    if registry is not None:
        registry.set("perfmodel.model_drift", drift)
        registry.set("perfmodel.predicted_epoch.s", predicted)
        registry.set("perfmodel.measured_epoch.s", measured)
    return out


__all__ = ["COMM_PHASES", "RESIDUAL_PHASES", "compute_drift", "phase_means"]
