"""Observability substrate: tracing spans, metrics registry, export and
the live telemetry plane.

  * :mod:`trace <repro_torch.obs.trace>` — nestable spans into a
    thread-safe ring buffer; zero-cost when disabled; ``profile=True``
    spans also enter ``torch.profiler.record_function``.
  * :mod:`metrics <repro_torch.obs.metrics>` — counters, gauges and
    p50/p95/p99 histograms in a named registry with JSON snapshot and
    Prometheus text exposition. Engine and cache metrics are backed by it.
  * :mod:`export <repro_torch.obs.export>` — Chrome/Perfetto
    ``trace_event`` JSON, a structural schema validator, a text flame
    summary and the SLO view of a trace.
  * :mod:`telemetry <repro_torch.obs.telemetry>` — a background
    collector sampling a registry into bounded time-series rings,
    declarative SLO burn-rate alert rules with firing/resolved
    transitions, and a stdlib HTTP endpoint (``/metrics``, ``/healthz``,
    ``/snapshot``).
"""
from . import export, metrics, telemetry, trace
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_TIME_BUCKETS, UNIT_BUCKETS,
                      escape_label_value, validate_metric_name)
from .telemetry import (AlertRule, AlertState, SeriesRing,
                        TelemetryCollector, TelemetryServer,
                        TELEMETRY_SCHEMA, default_slo_rules)
from .trace import TraceEvent, Tracer

__all__ = [
    "AlertRule", "AlertState", "Counter", "DEFAULT_TIME_BUCKETS", "Gauge",
    "Histogram", "MetricsRegistry", "SeriesRing", "TELEMETRY_SCHEMA",
    "TelemetryCollector", "TelemetryServer", "TraceEvent", "Tracer",
    "UNIT_BUCKETS", "escape_label_value", "export", "default_slo_rules",
    "metrics", "telemetry", "trace", "validate_metric_name",
]
