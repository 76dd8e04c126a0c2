"""Tracer core: nestable spans over the compile→serve path.

The runtime analogue of the paper's analytic visibility: where the MILP
makes the *theoretical* bottleneck (on-chip memory contention) explicit,
a trace makes the *wall-clock* bottleneck explicit — which of a frame's
milliseconds went to the ILP solve, the autotune search, executor
tracing/jit, device execution, or queueing. The design mirrors
sglang-jax's ``debug_tracer``/``trace_function`` idiom (SNIPPETS.md §1):
a process-global tracer, context-manager/decorator spans, and a hard
zero-cost guarantee when disabled.

  * **spans** — ``with trace.span("ilp.solve", pipeline=..., w=...):``
    or ``@trace.traced("compile.pipeline")``. Spans nest: a per-thread
    stack records depth and parent name, so the exported timeline is a
    flame graph, not a flat list. ``span(..., profile=True)`` additionally
    enters a ``torch.profiler.record_function`` so engine-level spans line
    up with the CUDA kernels on PyTorch's profiler timeline when both are
    captured.
  * **ring buffer** — completed spans land in a bounded deque under a
    lock (threads share one tracer; the serving control loops are
    single-threaded but span exit must still be safe from worker
    threads). Oldest events fall off; capacity is an ``enable()`` knob.
  * **zero-cost disabled** — ``span()`` checks one flag and returns a
    shared no-op singleton; no allocation, no clock read, no lock. The
    CI perf gate (< 2% disabled-mode overhead) leans on this.

Events are relative-timestamped (perf_counter_ns since tracer creation);
``obs.export`` turns them into Chrome/Perfetto ``trace_event`` JSON.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque

from torch.profiler import record_function as _record_function

DEFAULT_CAPACITY = 65536


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One completed span. Timestamps are ns since the tracer's epoch."""
    name: str
    ts_ns: int
    dur_ns: int
    tid: int
    depth: int                       # nesting depth at entry (0 = root)
    parent: str | None               # enclosing span's name, if any
    attrs: dict


class _NullSpan:
    """The disabled-mode singleton: every method is a no-op."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: context manager yielding itself so callers can attach
    late attributes (``sp.set(candidates=...)``) before exit records it."""
    __slots__ = ("_tracer", "name", "attrs", "_profile", "_t0", "_depth",
                 "_parent", "_ann")

    def __init__(self, tracer: "Tracer", name: str, profile: bool,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._profile = profile
        self._ann = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        if self._profile:
            self._ann = _record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        tracer._record(TraceEvent(
            name=self.name, ts_ns=self._t0 - tracer.epoch_ns, dur_ns=dur,
            tid=threading.get_ident(), depth=self._depth,
            parent=self._parent, attrs=self.attrs))
        return False


class Tracer:
    """Thread-safe span recorder with a bounded event ring."""

    def __init__(self, enabled: bool = False,
                 capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self.epoch_ns = time.perf_counter_ns()
        self.dropped = 0          # events pushed out of a full ring
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    def now(self) -> float:
        """Seconds on this tracer's clock — the span timebase. Deadline
        stamps taken here line up with span timestamps in the export."""
        return (time.perf_counter_ns() - self.epoch_ns) / 1e9

    # ------------------------------------------------------------ recording
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, event: TraceEvent) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1      # overflow accounting: oldest falls off
            self._events.append(event)

    def span(self, name: str, profile: bool = False, **attrs):
        """A nestable span; the no-op singleton when tracing is off."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, profile, attrs)

    def traced(self, name: str | None = None, profile: bool = False, **attrs):
        """Decorator form: spans every call of the wrapped function."""
        def deco(fn):
            label = name if name is not None else fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, profile=profile, **attrs):
                    return fn(*a, **kw)
            return wrapper
        return deco

    # ------------------------------------------------------------- control
    def enable(self, capacity: int | None = None) -> None:
        if capacity is not None and capacity != self.capacity:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            with self._lock:
                self.capacity = capacity
                self._events = deque(self._events, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def events(self) -> list[TraceEvent]:
        """Snapshot of the ring, oldest first (span *completion* order)."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# Process-global tracer: the instrumentation sweep (ilp/dse/codegen/cache/
# engines/executors) all spans through here so one enable() lights up the
# whole stack. Standalone Tracer instances remain available for tests.
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def span(name: str, profile: bool = False, **attrs):
    if not _GLOBAL.enabled:        # inlined fast path: one flag, no call
        return NULL_SPAN
    return _GLOBAL.span(name, profile=profile, **attrs)


def traced(name: str | None = None, profile: bool = False, **attrs):
    return _GLOBAL.traced(name, profile=profile, **attrs)


def enable(capacity: int | None = None) -> None:
    _GLOBAL.enable(capacity)


def disable() -> None:
    _GLOBAL.disable()


def clear() -> None:
    _GLOBAL.clear()


def events() -> list[TraceEvent]:
    return _GLOBAL.events()


def enabled() -> bool:
    return _GLOBAL.enabled


def now() -> float:
    """Module-level obs clock: seconds on the global tracer's timebase.
    The serving control plane stamps SLA deadlines through here so
    deadline misses align with span timestamps in the trace viewer."""
    return _GLOBAL.now()
