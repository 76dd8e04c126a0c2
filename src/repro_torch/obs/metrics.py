"""Metrics registry: counters, gauges, and bucketed histograms.

The serving telemetry plane's data model. Three metric kinds cover the
engines' needs:

  * :class:`Counter` — monotone totals (frames submitted, cache hits,
    seconds inside the executor). Floats allowed: compile/tune seconds
    accumulate here too.
  * :class:`Gauge` — instantaneous or high-water values (resident VMEM).
  * :class:`Histogram` — bucketed distributions with p50/p95/p99
    estimates, replacing the mean/max-only ``RunningStat`` view of
    latency. Percentiles interpolate linearly inside the bucket that
    crosses the rank, clamped to the observed min/max, so the estimate
    is always within one bucket width of the exact value.

A :class:`MetricsRegistry` names and owns metrics (get-or-create, type
checked) and renders two views: ``snapshot()`` (JSON-able dict, the
programmatic API the engines' existing ``snapshot()`` methods sit on)
and ``to_prometheus_text()`` (the text exposition format a scraper or a
file-based sidecar consumes). Engines and the plan cache each default to
a private registry; passing one shared registry to all of them is what
makes a process-wide telemetry plane — every subsystem's metrics under
one scrape, disambiguated by prefix.

Metric updates take the registry lock only at creation. Mutators with
multi-field invariants — ``Histogram.observe`` (bucket/count/sum must
agree for the Prometheus exposition), ``Counter.inc``, ``Gauge.set_max``
— take a per-metric lock so worker threads (retry timeouts, the chaos
harness, stress tests) can write concurrently; the engines' attribute
idiom (``metrics.frames_submitted += 1`` routed to ``counter.value``)
remains a single-threaded-control-loop contract as before.
"""
from __future__ import annotations

import bisect
import re
import threading

# exponential time buckets: 1 µs .. ~137 s, factor 2 (latency, compile,
# queue-wait); distributions tighter than this use explicit buckets
DEFAULT_TIME_BUCKETS = tuple(1e-6 * 2 ** k for k in range(28))
# linear unit-interval buckets (batch-fill ratios)
UNIT_BUCKETS = tuple(i / 20 for i in range(1, 21))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# the exposition-format grammar for metric family names; enforced at
# registration so a bad name fails at the call site, not in a scraper
_VALID_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def validate_metric_name(name: str) -> str:
    """Registration-time gate: metric names must already satisfy the
    Prometheus grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``. Returns the name;
    raises ValueError otherwise (silent mangling at render time hid
    collisions like ``a.b`` / ``a:b`` -> ``a_b``)."""
    if not isinstance(name, str) or not _VALID_NAME_RE.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: must match "
            f"[a-zA-Z_:][a-zA-Z0-9_:]*")
    return name


def escape_label_value(v: str) -> str:
    """Escape a label value for the text exposition format: backslash,
    double-quote, and newline, in that order (backslash first so the
    other escapes aren't double-escaped)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class Counter:
    __slots__ = ("name", "help", "value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        # locked: inc() is the concurrent-writer API (worker threads,
        # the chaos harness); direct ``value`` writes remain the
        # single-threaded engine-loop idiom
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "help", "value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        """High-water update — the VMEM-footprint idiom."""
        with self._lock:
            self.value = max(self.value, v)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max sidecars.

    ``buckets`` are upper bounds (ascending); values above the last
    bound land in an implicit +Inf bucket. The exact extrema make the
    percentile clamp tight and keep the old RunningStat snapshot keys
    (count/mean/max/min) exact, so migrated engine metrics lose nothing.
    """
    __slots__ = ("name", "help", "buckets", "counts", "count", "total",
                 "min", "max", "_lock")

    def __init__(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                 help: str = ""):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"buckets must be ascending and unique, "
                             f"got {buckets!r}")
        self.name = name
        self.help = help
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)     # +1: the +Inf bucket
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        # locked so concurrent writers can't tear the count/sum/bucket
        # triple: the exposition invariant (sum of buckets == count)
        # must hold under a mid-scrape snapshot from another thread
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, x)] += 1
            self.count += 1
            self.total += x
            self.min = min(self.min, x)
            self.max = max(self.max, x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by linear interpolation
        within the bucket whose cumulative count crosses the rank."""
        if not self.count:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo = self.buckets[i - 1] if i > 0 else self.min
            hi = self.buckets[i] if i < len(self.buckets) else self.max
            if cum + c >= rank:
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max  # pragma: no cover - rank <= count always crosses

    def snapshot(self) -> dict:
        # one lock hold for the whole stat dict so count/mean/percentiles
        # describe the same instant even while writers keep observing
        with self._lock:
            return {"count": self.count, "mean": self.mean,
                    "max": self.max if self.count else 0.0,
                    "min": self.min if self.count else 0.0,
                    "p50": self.percentile(50.0),
                    "p95": self.percentile(95.0),
                    "p99": self.percentile(99.0)}


class MetricsRegistry:
    """Named metric store: get-or-create, two export views."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, **kw):
        validate_metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, **kw)
            elif type(m) is not kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, buckets=DEFAULT_TIME_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram, buckets=buckets, help=help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> dict:
        """JSON-able view: scalars for counters/gauges, stat dicts for
        histograms."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: (m.snapshot() if isinstance(m, Histogram) else m.value)
                for name, m in items}

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (the scrape-endpoint payload)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in items:
            pname = _prom_name(name)
            # HELP/TYPE for *every* family (scrapers treat a bare sample
            # line as untyped); empty help renders as a bare HELP line
            lines.append(f"# HELP {pname} {m.help}".rstrip())
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                # read the (counts, count, total) triple under the
                # histogram's own lock: a scrape racing observe() must
                # still satisfy sum(buckets) == count
                with m._lock:
                    counts = list(m.counts)
                    count, total = m.count, m.total
                cum = 0
                for bound, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
                lines.append(f"{pname}_sum {total}")
                lines.append(f"{pname}_count {count}")
        return "\n".join(lines) + ("\n" if lines else "")
