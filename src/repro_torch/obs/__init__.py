"""Observability substrate: tracing spans, metrics registry, export and
the live telemetry plane.

  * :mod:`trace <repro_torch.obs.trace>` — nestable spans into a
    thread-safe ring buffer; one flag check when disabled; while a
    ``torch.profiler`` records, every span is also a
    ``record_function`` annotation of the same name.
  * :mod:`metrics <repro_torch.obs.metrics>` — counters, gauges and
    p50/p95/p99 histograms in a named registry with JSON snapshot and
    Prometheus text exposition. Engine and cache metrics are backed by it.
  * :mod:`export <repro_torch.obs.export>` — Chrome/Perfetto
    ``trace_event`` JSON, a structural schema validator, a text flame
    summary, the SLO view of a trace, and memtrace counter-track
    rendering and merging.
  * :mod:`memtrace <repro_torch.obs.memtrace>` — cycle-level
    memory-system traces: per-buffer occupancy and port-pressure samples
    from the schedule simulator, downsampled into schema-stamped
    ``memtrace/v1`` artifacts, with allocation-vs-peak waste joined to
    the shared-memory rings the CUDA kernel reserves.
  * :mod:`telemetry <repro_torch.obs.telemetry>` — a background
    collector sampling a registry into bounded time-series rings,
    declarative SLO burn-rate alert rules with firing/resolved
    transitions, and a stdlib HTTP endpoint (``/metrics``, ``/healthz``,
    ``/snapshot``).
"""
from . import export, memtrace, metrics, telemetry, trace
from .memtrace import MEMTRACE_SCHEMA
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_TIME_BUCKETS, UNIT_BUCKETS,
                      escape_label_value, validate_metric_name)
from .telemetry import (AlertRule, AlertState, SeriesRing,
                        TelemetryCollector, TelemetryServer,
                        TELEMETRY_SCHEMA, default_slo_rules)
from .trace import TraceEvent, Tracer

__all__ = [
    "AlertRule", "AlertState", "Counter", "DEFAULT_TIME_BUCKETS", "Gauge",
    "Histogram", "MEMTRACE_SCHEMA", "MetricsRegistry", "SeriesRing",
    "TELEMETRY_SCHEMA", "TelemetryCollector", "TelemetryServer",
    "TraceEvent", "Tracer", "UNIT_BUCKETS", "escape_label_value",
    "export", "default_slo_rules", "memtrace", "metrics", "telemetry",
    "trace", "validate_metric_name",
]
