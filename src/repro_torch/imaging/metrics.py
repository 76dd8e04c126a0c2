"""Serving metrics for the frame/video engines, on the obs registry.

Tracks the quantities the ROADMAP's serving story is judged on —
throughput (frames/sec, wall and execute-only), request latency
(submit -> completion, with p50/p95/p99 from a bucketed histogram),
queue wait, and the shared-memory footprint of the resident compiled
executors (the accelerator's "SRAM bill": the bytes each CTA of the
fused kernel reserves for its ring line buffers). Counters live in an
:class:`repro_torch.obs.MetricsRegistry` behind an attribute API
(``metrics.frames_submitted += 1`` works — the attributes are properties
over registry counters), so the engines keep their single-threaded
plain-python increments while a shared registry turns N engines + caches
into one scrapeable telemetry plane
(``metrics.registry.to_prometheus_text()``).
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, UNIT_BUCKETS,
                                     MetricsRegistry)

_COUNTERS = {
    "frames_offered": "submit() calls that reached a decision",
    "frames_submitted": "frames accepted into an engine queue",
    "frames_completed": "frames executed and delivered",
    "frames_rejected": "admission refusals (backpressure, malformed, "
                       "rate-limited)",
    "frames_shed": "admitted frames dropped by the overload policy",
    "frames_cancelled": "admitted frames drained by a stream close",
    "frames_failed": "frames lost to an exhausted fallback ladder",
    "deadline_missed": "frames completed after their SLA deadline",
    "executor_retries": "executor/compile attempts retried with backoff",
    "fallback_frames": "frames served by a non-primary ladder rung",
    "batches": "executor batches dispatched",
    "execute_s": "seconds inside executor calls (device-synchronous)",
}


class EngineMetrics:
    """Registry-backed engine counters behind the historical attributes.

    ``registry`` defaults to a private one; pass a shared registry (and
    a distinct ``prefix`` per engine) to aggregate several engines and
    their PlanCache into one exposition endpoint.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 prefix: str = "engine"):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.prefix = prefix
        self.started_at = time.perf_counter()
        self._c = {k: self.registry.counter(f"{prefix}_{k}", help=h)
                   for k, h in _COUNTERS.items()}
        self.batch_fill = self.registry.histogram(
            f"{prefix}_batch_fill", buckets=UNIT_BUCKETS,
            help="live slots / total slots per batch")
        self.latency_s = self.registry.histogram(
            f"{prefix}_latency_s", buckets=DEFAULT_TIME_BUCKETS,
            help="submit -> completion seconds")
        self.queue_wait_s = self.registry.histogram(
            f"{prefix}_queue_wait_s", buckets=DEFAULT_TIME_BUCKETS,
            help="head-of-batch seconds queued before assembly")
        self.retry_backoff_s = self.registry.histogram(
            f"{prefix}_retry_backoff_s", buckets=DEFAULT_TIME_BUCKETS,
            help="jittered backoff delays slept before retries")
        self.deadline_miss_s = self.registry.histogram(
            f"{prefix}_deadline_miss_s", buckets=DEFAULT_TIME_BUCKETS,
            help="overrun past the SLA deadline for late completions")
        self._smem = self.registry.gauge(
            f"{prefix}_smem_high_water_bytes",
            help="max per-CTA shared memory across executed batches")
        self.per_pipeline: dict[str, int] = {}
        # distinct row-group factors served; a set mutated in place —
        # snapshot() renders the sorted view (no re-sort per batch)
        self.rows_per_step_seen: set[int] = set()

    # ------------------------------------------------------------- observe
    def observe_batch(self, pipeline: str, n_frames: int, slots: int,
                      execute_s: float, smem_bytes: int,
                      rows_per_step: int = 1) -> None:
        self.batches += 1
        self.frames_completed += n_frames
        self.batch_fill.observe(n_frames / slots)
        self.execute_s += execute_s
        self._smem.set_max(smem_bytes)
        self.per_pipeline[pipeline] = self.per_pipeline.get(pipeline, 0) \
            + n_frames
        self.rows_per_step_seen.add(rows_per_step)

    def observe_latency(self, seconds: float) -> None:
        self.latency_s.observe(seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        self.queue_wait_s.observe(seconds)

    def observe_retry(self, delay_s: float) -> None:
        self.executor_retries += 1
        self.retry_backoff_s.observe(delay_s)

    def observe_deadline_miss(self, overrun_s: float) -> None:
        self.deadline_missed += 1
        self.deadline_miss_s.observe(max(overrun_s, 0.0))

    # ------------------------------------------------------------ readouts
    @property
    def smem_high_water(self) -> int:
        return self._smem.value

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self.started_at

    @property
    def in_flight(self) -> int:
        """Admitted but not yet resolved — the reconciliation residue.
        Every admitted frame ends completed, shed, cancelled, or failed;
        rejected frames were never admitted, so they sit outside this
        residue (but inside :meth:`reconcile`'s offered identity)."""
        return (self.frames_submitted - self.frames_completed
                - self.frames_shed - self.frames_cancelled
                - self.frames_failed)

    def reconcile(self) -> dict:
        """The control plane's accounting identity, both sides spelled
        out: ``offered == completed + shed + rejected + cancelled +
        failed + in_flight``. ``balanced`` is the invariant the chaos
        soak gates on — a frame that vanished (or was double-counted)
        anywhere in admission/shed/cancel/failure paths breaks it."""
        accounted = (self.frames_completed + self.frames_shed
                     + self.frames_rejected + self.frames_cancelled
                     + self.frames_failed + self.in_flight)
        return {
            "offered": self.frames_offered,
            "completed": self.frames_completed,
            "shed": self.frames_shed,
            "rejected": self.frames_rejected,
            "cancelled": self.frames_cancelled,
            "failed": self.frames_failed,
            "in_flight": self.in_flight,
            "accounted": accounted,
            "balanced": self.frames_offered == accounted,
        }

    def snapshot(self) -> dict:
        wall = self.wall_s
        return {
            "frames_offered": self.frames_offered,
            "frames_submitted": self.frames_submitted,
            "frames_completed": self.frames_completed,
            "frames_rejected": self.frames_rejected,
            "frames_shed": self.frames_shed,
            "frames_cancelled": self.frames_cancelled,
            "frames_failed": self.frames_failed,
            "deadline_missed": self.deadline_missed,
            "executor_retries": self.executor_retries,
            "fallback_frames": self.fallback_frames,
            "frames_in_flight": self.in_flight,
            "reconciliation": self.reconcile(),
            "batches": self.batches,
            "mean_batch_fill": self.batch_fill.mean,
            "fps_wall": self.frames_completed / wall if wall > 0 else 0.0,
            "fps_execute": (self.frames_completed / self.execute_s
                            if self.execute_s > 0 else 0.0),
            "latency": self.latency_s.snapshot(),
            "queue_wait": self.queue_wait_s.snapshot(),
            "retry_backoff": self.retry_backoff_s.snapshot(),
            "deadline_miss": self.deadline_miss_s.snapshot(),
            "smem_high_water_bytes": self.smem_high_water,
            "per_pipeline": dict(self.per_pipeline),
            "rows_per_step_seen": sorted(self.rows_per_step_seen),
        }


def _counter_property(key: str) -> property:
    def _get(self):
        return self._c[key].value

    def _set(self, value):
        self._c[key].value = value

    return property(_get, _set)


for _k in _COUNTERS:
    setattr(EngineMetrics, _k, _counter_property(_k))
del _k
