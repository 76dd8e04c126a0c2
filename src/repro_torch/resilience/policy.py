"""Retry, timeout, circuit-breaker, and fallback-ladder policies.

The mid-flight half of the control plane: what happens when a compile
or an executor call *fails* after admission let the work in.

  * :class:`RetryPolicy` — bounded retries with jittered exponential
    backoff and an optional per-attempt timeout. The jitter RNG is a
    seeded ``random.Random`` owned by the policy, so a seeded chaos run
    replays the exact same backoff schedule. The timeout runs the
    attempt on a fresh daemon thread and abandons it on expiry — Python
    cannot preempt a wedged kernel launch or device wait, but the
    *caller* regains control, which is the no-hangs property the soak
    proves. The attempt runs on its caller's card and stream.
  * :class:`CircuitBreaker` — consecutive-failure trip wire with a
    half-open probe. While OPEN, callers skip the rung instead of
    burning retries against a known-bad path; after ``reset_after_s``
    one probe is allowed through (HALF_OPEN) and its outcome closes or
    re-opens the breaker.
  * :class:`FallbackLadder` — orders execution rungs (tuned plan →
    default plan → reference executor), each behind its own breaker,
    each attempt wrapped in the retry policy. The ladder returns the
    first rung that succeeds and the rung's name (so metrics can count
    fallback-served frames); it raises :class:`LadderExhausted` only
    when every rung is open or failing — which the engines convert into
    structured ``FailedFrame`` results, never an escaped exception.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch._device import caller_stream_context
from repro_torch.obs import trace


class AttemptTimeout(TimeoutError):
    """A single attempt exceeded the policy's per-attempt budget."""


class LadderExhausted(RuntimeError):
    """Every fallback rung was open or failed; carries per-rung errors."""

    def __init__(self, key, errors: list[tuple[str, BaseException | str]]):
        self.key = key
        self.errors = errors
        detail = "; ".join(f"{rung}: {err!r}" for rung, err in errors)
        super().__init__(f"all fallback rungs exhausted for {key}: {detail}")


def _run_with_timeout(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run ``fn`` on a fresh daemon thread, abandoning it on timeout.

    A fresh thread (not a pool) so a wedged attempt can never exhaust
    shared workers; the abandoned thread's eventual result is discarded.
    The thread inherits the caller's current card and stream: a fresh
    thread would start on card 0's default stream, so an attempt's
    launches and allocations are ordered with its caller's work. An
    abandoned attempt may still launch; it writes only the tensors it
    allocated itself, which nobody reads.
    """
    box: list = []
    err: list = []
    done = threading.Event()
    context = caller_stream_context()

    def runner():
        try:
            with context():
                box.append(fn())
        except BaseException as e:  # noqa: BLE001 - relayed to caller
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="resilience-attempt")
    t.start()
    if not done.wait(timeout_s):
        raise AttemptTimeout(f"attempt exceeded {timeout_s}s")
    if err:
        raise err[0]
    return box[0]


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with seeded jittered exponential backoff.

    Delay before retry k (k = 1..max_attempts-1) is
    ``min(max_delay_s, base_delay_s * multiplier**(k-1))`` scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]``. ``timeout_s`` bounds
    each attempt (None = unbounded). ``sleep`` is injectable so unit
    tests and the chaos harness never actually wait.
    """
    max_attempts: int = 3
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5
    timeout_s: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        self._rng = random.Random(self.seed)

    def backoff_s(self, attempt: int) -> float:
        """Jittered delay after failed attempt ``attempt`` (1-based)."""
        base = min(self.max_delay_s,
                   self.base_delay_s * self.multiplier ** (attempt - 1))
        lo = 1.0 - self.jitter
        return base * (lo + 2.0 * self.jitter * self._rng.random())

    def call(self, fn: Callable[[], Any],
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Callable[[int, float, BaseException], None] | None
             = None) -> Any:
        """Invoke ``fn`` under the policy; raises the last error when
        attempts are exhausted. ``on_retry(attempt, delay_s, exc)`` fires
        before each backoff sleep (metrics/trace hook)."""
        for attempt in range(1, self.max_attempts + 1):
            try:
                if self.timeout_s is None:
                    return fn()
                return _run_with_timeout(fn, self.timeout_s)
            except Exception as e:  # noqa: BLE001 - policy boundary
                if attempt == self.max_attempts:
                    raise
                delay = self.backoff_s(attempt)
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                with trace.span("resilience.retry", attempt=attempt,
                                delay_s=delay, error=type(e).__name__):
                    pass
                sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


class CircuitBreaker:
    """CLOSED -> OPEN after N consecutive failures; OPEN -> HALF_OPEN
    probe after ``reset_after_s``; the probe's outcome decides.

    The clock is injectable (defaults to ``time.monotonic``) so tests
    and the seeded chaos harness control reopening deterministically.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_after_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self.state = self.CLOSED
        self.failures = 0              # consecutive
        self.opened_at = 0.0
        self.trips = 0                 # lifetime CLOSED->OPEN transitions

    def allow(self) -> bool:
        """May a call proceed right now? OPEN breakers let exactly one
        probe through once the reset window has elapsed."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self._clock() - self.opened_at >= self.reset_after_s:
                self.state = self.HALF_OPEN
                return True
            return False
        return False                   # HALF_OPEN: probe already in flight

    def record_success(self) -> None:
        self.state = self.CLOSED
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN \
                or self.failures >= self.failure_threshold:
            if self.state != self.OPEN:
                self.trips += 1
            self.state = self.OPEN
            self.opened_at = self._clock()


class FallbackLadder:
    """Rung-ordered execution with per-(key, rung) breakers + retries.

    ``run(key, rungs)`` walks ``[(rung_name, thunk), ...]`` top-down:
    a rung whose breaker is open is skipped outright; otherwise the
    thunk runs under the retry policy. First success wins and closes
    that rung's breaker; a rung's final failure opens progress toward
    its breaker and the ladder descends. ``LadderExhausted`` only when
    nothing answered.
    """

    def __init__(self, retry: RetryPolicy | None = None,
                 failure_threshold: int = 3,
                 reset_after_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Callable[[int, float, BaseException], None] | None
                 = None,
                 on_fallback: Callable[[Any, str, BaseException | str], None]
                 | None = None):
        self.retry = retry if retry is not None else RetryPolicy()
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._sleep = sleep
        self._on_retry = on_retry
        self._on_fallback = on_fallback
        self._breakers: dict = {}

    def breaker(self, key, rung: str) -> CircuitBreaker:
        k = (key, rung)
        br = self._breakers.get(k)
        if br is None:
            br = self._breakers[k] = CircuitBreaker(
                self.failure_threshold, self.reset_after_s,
                clock=self._clock)
        return br

    def run(self, key, rungs: Sequence[tuple[str, Callable[[], Any]]]
            ) -> tuple[Any, str]:
        errors: list[tuple[str, BaseException | str]] = []
        for i, (rung, thunk) in enumerate(rungs):
            br = self.breaker(key, rung)
            if not br.allow():
                errors.append((rung, "breaker_open"))
                continue
            try:
                result = self.retry.call(thunk, sleep=self._sleep,
                                         on_retry=self._on_retry)
            except Exception as e:  # noqa: BLE001 - descend the ladder
                br.record_failure()
                errors.append((rung, e))
                if self._on_fallback is not None and i + 1 < len(rungs):
                    self._on_fallback(key, rung, e)
                with trace.span("resilience.fallback", key=str(key),
                                rung=rung, breaker=br.state,
                                error=type(e).__name__):
                    pass
                continue
            br.record_success()
            return result, rung
        raise LadderExhausted(key, errors)
