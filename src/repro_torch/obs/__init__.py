"""Observability of the port: the process-global metrics registry."""
from .registry import REGISTRY, MetricsRegistry

__all__ = ["REGISTRY", "MetricsRegistry"]
