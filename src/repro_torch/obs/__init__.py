"""Flight recorder of the port, as in ``repro.obs``.

  * ``registry`` — process-global metrics registry (counters / gauges /
    histograms under stable dotted names; near-zero-cost when disabled);
  * ``trace`` — bounded structured trace buffers (span / instant events)
    exported as Chrome/Perfetto ``trace.json``, driven by
    ``Simulation.trace(path)`` or the ``REPRO_TRACE`` env knob;
  * ``schema`` — the ONE validated ``Simulation.stats()`` schema every
    engine shares, plus the Perfetto trace-format validator (CLI:
    ``python -m repro_torch.obs.schema trace.json``);
  * ``report`` — ``python -m repro_torch.obs.report trace.json``: top
    stalls, straggler ranking, per-phase breakdown from a trace file;
  * ``telemetry`` — the procs workers' shm phase-record rings (one
    48-byte record a phase, dropped and counted when full);
  * ``drift`` — measured phase means against ``core/perfmodel``'s
    epoch-time prediction, the ``perfmodel.model_drift`` gauge.
"""
from . import drift, registry, schema, telemetry, trace  # noqa: F401
from .registry import REGISTRY, MetricsRegistry  # noqa: F401
from .trace import TraceRecorder  # noqa: F401

__all__ = ["REGISTRY", "MetricsRegistry", "TraceRecorder", "drift", "registry",
           "schema", "telemetry", "trace"]
