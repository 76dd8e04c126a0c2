"""Observability substrate: tracing spans + metrics registry.

  * :mod:`trace <repro_torch.obs.trace>` — nestable spans into a
    thread-safe ring buffer; zero-cost when disabled; ``profile=True``
    spans also enter ``torch.profiler.record_function``.
  * :mod:`metrics <repro_torch.obs.metrics>` — counters, gauges and
    p50/p95/p99 histograms in a named registry with JSON snapshot and
    Prometheus text exposition. Engine and cache metrics are backed by it.
"""
from . import metrics, trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_TIME_BUCKETS, UNIT_BUCKETS,
                      escape_label_value, validate_metric_name)
from .trace import TraceEvent, Tracer

__all__ = [
    "Counter", "DEFAULT_TIME_BUCKETS", "Gauge", "Histogram",
    "MetricsRegistry", "TraceEvent", "Tracer", "UNIT_BUCKETS",
    "escape_label_value", "metrics", "trace", "validate_metric_name",
]
