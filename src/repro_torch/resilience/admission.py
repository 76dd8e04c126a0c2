"""Admission control: request screening, priority classes, rate limits.

The front door of the serving control plane. The paper's compiler
guarantees throughput only for well-formed steady streams; this module
is where everything else is turned away *before* it can poison an
assembled batch or starve better work:

  * :func:`screen_frames` — structural validation of a request's input
    arrays (dtype, shape, finiteness) on the host, before any copy to
    the device, returning a rejection *reason* instead of raising:
    malformed requests become structured
    :class:`~repro_torch.resilience.outcomes.RejectedFrame` results.
  * :class:`TokenBucket` — the per-stream rate limiter. Classic
    refill-on-read bucket: ``rate`` tokens/second up to ``burst``; a
    submit that finds the bucket empty is rejected ``rate_limited``
    (retryable — the client is early, not wrong).
  * :class:`Priority` — three admission classes. Priority does not
    reorder the FIFO (per-stream completion order stays submission
    order — the engines' contract); it decides who is *shed* when
    queues saturate: LOW work is evicted before NORMAL before HIGH.
  * :class:`AdmissionController` — per-key bucket bookkeeping over an
    injectable clock (tests pass a fake; engines pass the obs clock so
    rate windows share the trace timebase).
"""
from __future__ import annotations

import enum
import time
from typing import Callable, Mapping

import numpy as np


class Priority(enum.IntEnum):
    """Admission classes; lower value = more protected from shedding."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


def screen_frames(frames: Mapping[str, object], needed: frozenset | set,
                  expect_shape: tuple[int, int] | None = None
                  ) -> tuple[str, str] | None:
    """Validate a request's input arrays; None = clean, else
    ``(reason, detail)`` naming the first defect found.

    Checks, in order: every required input stage present; every array a
    real numeric 2D array; all inputs sharing one (H, W) shape (equal to
    ``expect_shape`` when the stream pins one); every pixel finite. The
    finiteness scan is O(pixels) on the host — the price of quarantining
    NaN frames at the door instead of letting them silently corrupt a
    batch (zero idle slots, tile halos) or a video stream's frame rings.
    """
    missing = set(needed) - set(frames)
    if missing:
        return ("missing_inputs",
                f"missing {sorted(missing)}, got {sorted(frames)}")
    shapes = set()
    for name in sorted(needed):
        arr = np.asarray(frames[name])
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.integer)):
            return ("bad_dtype", f"input {name!r} has dtype {arr.dtype}")
        if arr.ndim != 2:
            return ("bad_shape", f"input {name!r} has shape {arr.shape}, "
                                 f"expected 2D (H, W)")
        shapes.add(arr.shape)
        if not np.isfinite(arr).all():
            return ("nonfinite", f"input {name!r} contains NaN/Inf")
    if len(shapes) > 1:
        return ("bad_shape", f"inputs disagree on shape: {sorted(shapes)}")
    if expect_shape is not None and shapes and shapes != {tuple(expect_shape)}:
        return ("bad_shape", f"frame shape {shapes.pop()} != "
                             f"{tuple(expect_shape)}")
    return None


class TokenBucket:
    """Refill-on-read token bucket: ``rate`` tokens/s, capacity ``burst``.

    ``try_take`` is the only operation — there is no blocking acquire;
    a dry bucket means *reject now, retry later* (the admission layer's
    whole philosophy). Starts full so a fresh stream gets its burst.
    """

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got {rate}/{burst}")
        self.rate = rate
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


class AdmissionController:
    """Per-key token buckets behind one knob pair (rate, burst).

    Keys are whatever the engine streams by — pipeline name for the
    FrameEngine, stream id for the VideoEngine. ``rate=None`` disables
    rate limiting entirely (every ``allow`` is True) so the controller
    can always be in the path. ``forget`` drops a closed stream's bucket
    so churny workloads don't accumulate dead state.
    """

    def __init__(self, rate: float | None, burst: float = 8.0,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._buckets: dict = {}

    def allow(self, key) -> bool:
        if self.rate is None:
            return True
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(self.rate, self.burst,
                                                 clock=self._clock)
        return b.try_take()

    def forget(self, key) -> None:
        self._buckets.pop(key, None)

    def __len__(self) -> int:
        return len(self._buckets)
