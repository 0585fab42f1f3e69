"""Process-global metrics registry (a copy of ``repro.obs.registry``).

Counters, gauges and histograms under stable dotted names
(``layer.component.metric``, e.g. ``fused.dispatch.count``).  Every layer
of the port publishes into ONE process-global ``REGISTRY``;
``Simulation.stats()["metrics"]`` is a snapshot view of it.

Cost model: publishing is a dict lookup plus a float add.  With the
registry *disabled* every ``inc``/``set``/``observe`` is a single
attribute check and an immediate return.
"""
from __future__ import annotations

import re

_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_-]+)+$")


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded summary (count/sum/min/max) — no per-sample storage."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> dict:
        mean = (self.sum / self.count) if self.count else 0.0
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "mean": float(mean),
            "min": float(self.min) if self.count else 0.0,
            "max": float(self.max) if self.count else 0.0,
        }


class MetricsRegistry:
    """Dotted-name -> metric map.  Creation validates the name once;
    the hot publishing paths never re-validate."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    # ------------------------------------------------------------- creation
    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            if not _NAME_RE.match(name):
                raise ValueError(
                    f"metric name {name!r} is not dotted lowercase "
                    "(layer.component.metric)"
                )
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # ------------------------------------------------------ hot-path verbs
    def inc(self, name: str, n: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        if not self.enabled:
            return
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        if not self.enabled:
            return
        self.histogram(name).observe(v)

    # -------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """``{name: number}`` for counters/gauges, ``{name: summary
        dict}`` for histograms — the ``stats()["metrics"]`` view."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = float(m.value)
        return out

    def counters(self) -> dict:
        """``{name: value}`` of every counter."""
        return {n: m.value for n, m in self._metrics.items()
                if isinstance(m, Counter)}

    def clear(self) -> None:
        self._metrics.clear()


#: The process-global registry every layer publishes into.
REGISTRY = MetricsRegistry()

__all__ = ["REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram"]
