"""Fault-tolerant serving control plane for the frame/video engines.

The paper's compiler guarantees theoretical-maximum throughput for
well-formed steady streams; this package is what lets those guarantees
*degrade gracefully* under everything else — overload, malformed input,
and mid-flight faults:

  * :mod:`admission <repro_torch.resilience.admission>` — request
    screening on the host (malformed frames become structured
    rejections, never mid-loop exceptions), priority classes, per-stream
    token-bucket rate limits.
  * :mod:`deadline <repro_torch.resilience.deadline>` — submit-time SLA
    deadlines on the obs clock, and the shed-on-overload policy (drop
    lowest-priority, most-deadline-expired work first when queues
    saturate).
  * :mod:`policy <repro_torch.resilience.policy>` — bounded retries
    with seeded jittered backoff, per-attempt timeouts, circuit
    breakers, and the fallback ladder (tuned plan → default plan →
    reference rung, the eager PyTorch oracle on the engine's device).
  * :mod:`outcomes <repro_torch.resilience.outcomes>` — the result types
    closing the accounting identity
    ``offered == completed + shed + rejected + cancelled + failed +
    in_flight``.
  * :mod:`chaos <repro_torch.resilience.chaos>` — the seeded
    fault-injection harness (imported explicitly, not re-exported here:
    it is a test instrument, not part of the serving API).

Engines opt in by constructing with ``resilience=ResilienceConfig(...)``;
with the default ``resilience=None`` they keep their strict
raise-at-admission behavior.
"""
from __future__ import annotations

import dataclasses

from .admission import AdmissionController, Priority, TokenBucket, \
    screen_frames
from .deadline import overdue_s, pick_shed_victim, split_expired
from .outcomes import (CancelledFrame, FailedFrame, RejectedFrame,
                       ShedFrame)
from .policy import (AttemptTimeout, CircuitBreaker, FallbackLadder,
                     LadderExhausted, RetryPolicy)


@dataclasses.dataclass
class ResilienceConfig:
    """One knob bundle an engine threads through its whole control plane.

    ``rate``/``burst`` feed per-stream token buckets (None = unlimited);
    ``default_deadline_s`` stamps requests that carry no deadline of
    their own (None = no SLA unless the request asks); ``shed_*`` gate
    the two shedding policies; ``retry`` wraps every executor attempt;
    ``breaker_*`` parametrize the per-(pipeline, rung) circuit breakers;
    ``reference_fallback`` enables the ladder's last rung (the eager
    PyTorch oracle on the engine's device — slow, but it has no plan,
    executor or cache to fail, so "zero lost frames" holds even with
    every compiled path broken).
    """
    rate: float | None = None
    burst: float = 8.0
    default_deadline_s: float | None = None
    shed_on_overload: bool = True
    shed_expired: bool = True
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker_failures: int = 3
    breaker_reset_s: float = 1.0
    reference_fallback: bool = True
    seed: int = 0


__all__ = [
    "AdmissionController", "AttemptTimeout", "CancelledFrame",
    "CircuitBreaker", "FailedFrame", "FallbackLadder", "LadderExhausted",
    "Priority", "RejectedFrame", "ResilienceConfig", "RetryPolicy",
    "ShedFrame", "TokenBucket", "overdue_s", "pick_shed_victim",
    "screen_frames", "split_expired",
]
