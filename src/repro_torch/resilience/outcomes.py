"""Structured per-frame outcomes for the serving control plane.

Every frame a client offers to an engine ends in exactly one of six
states, and each state has a concrete result type the client can hold:

  * **completed** — the engine's own ``CompletedFrame`` /
    ``CompletedVideoFrame`` (defined next to the engines; they predate
    this module and carry the output array).
  * **rejected** (:class:`RejectedFrame`) — refused at admission:
    malformed input, unknown pipeline/stream, over the stream's rate
    limit, or a saturated queue with nothing worth shedding. Rejected
    frames were never admitted; ``retryable`` says whether resubmitting
    later can succeed (backpressure/rate limits: yes; malformed: no).
  * **shed** (:class:`ShedFrame`) — admitted, then dropped by the
    overload policy: evicted to make room for higher-priority work, or
    expired past its deadline while queued.
  * **cancelled** (:class:`CancelledFrame`) — admitted, then drained
    because its stream closed before it was served.
  * **failed** (:class:`FailedFrame`) — reached the executor but every
    rung of the fallback ladder raised; the error is carried instead of
    the output.
  * **in flight** — still queued (no result object yet).

The reconciliation identity the metrics enforce (see
``imaging.metrics.EngineMetrics.reconcile``):

    offered == completed + shed + rejected + cancelled + failed + in_flight

All outcome types are falsy so ``if engine.submit(req):`` keeps reading
as "was it admitted" whether the engine returns ``True``/``False``
(legacy strict mode) or ``True``/``RejectedFrame`` (resilient mode).
"""
from __future__ import annotations

import dataclasses

# rejection reasons — ``RejectedFrame.reason`` is always one of these
REJECT_REASONS = (
    "unknown_pipeline",     # no such pipeline registered in the cache
    "unknown_stream",       # video frame for a stream id that never was
    "temporal_pipeline",    # frame-history pipeline offered to FrameEngine
    "missing_inputs",       # required input stages absent
    "bad_shape",            # not 2D / mismatched across inputs / wrong (h, w)
    "bad_dtype",            # not a real numeric array
    "nonfinite",            # NaN or Inf pixels
    "rate_limited",         # stream's token bucket is empty (retryable)
    "saturated",            # queue full, nothing shed-worthy (retryable)
)

# shed reasons — ``ShedFrame.reason``
SHED_REASONS = (
    "overload",             # evicted at admission for better work
    "deadline",             # expired past its SLA while queued
)


@dataclasses.dataclass
class RejectedFrame:
    """Refused at admission — quarantined instead of raising mid-loop."""
    reason: str
    pipeline: str | None = None
    detail: str = ""
    retryable: bool = False
    rid: int | None = None           # FrameEngine request id
    stream: int | None = None        # VideoEngine stream id

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class ShedFrame:
    """Admitted work dropped by the overload policy before execution."""
    reason: str
    pipeline: str
    priority: int = 1
    rid: int | None = None
    stream: int | None = None
    deadline: float | None = None    # absolute, obs-clock seconds
    overdue_s: float = 0.0           # how far past the deadline when shed

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class CancelledFrame:
    """Admitted work drained because its stream closed underneath it."""
    pipeline: str
    stream: int | None = None
    rid: int | None = None
    reason: str = "stream_closed"

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class FailedFrame:
    """Executed and lost: every fallback rung raised. The engine stays
    consistent (queues drained, counters reconciled) and the error
    travels to the caller instead of escaping mid-``step``."""
    pipeline: str
    error: str
    rid: int | None = None
    stream: int | None = None
    latency_s: float = 0.0

    def __bool__(self) -> bool:
        return False
