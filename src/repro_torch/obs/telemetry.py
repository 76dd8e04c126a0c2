"""Live telemetry plane: background sampler, SLO burn-rate alerts, HTTP.

The post-hoc half of the observability stack (traces, memtraces, perf
reports) answers "what happened"; this module answers "what is happening
*now*" for a running engine:

  * :class:`SeriesRing` — fixed-size time-series ring; the collector
    keeps one per scalar metric (histograms contribute their p50/p95/
    p99/count/mean sub-fields as separate series), so memory is bounded
    no matter how long a soak runs.
  * :class:`AlertRule` — declarative SLO rules. ``burn_rate`` rules
    compare the windowed *error-budget burn* of a bad/total counter
    pair against a threshold (the multi-window burn-rate idiom:
    ``burn = (Δbad/Δtotal) / (1 - objective)``, so burn 1.0 means
    "spending budget exactly at the objective's rate"). ``threshold``
    rules bound any sampled series (gauge values, histogram p99s) over
    a sliding window.
  * :class:`TelemetryCollector` — samples a :class:`MetricsRegistry`
    every ``period_s`` on a daemon thread, evaluates the rules, and
    records firing -> resolved transitions with timestamps and values.
  * :class:`TelemetryServer` — stdlib ``http.server`` endpoint:
    ``/metrics`` (Prometheus text, including ``slo_alert_firing``
    gauges with escaped rule-name labels), ``/healthz``, ``/snapshot``
    (full JSON rings + alert state, schema ``telemetry/v1``).

Everything here is stdlib + the local metrics module — no torch, no core
imports — so a serving host can run the telemetry plane without pulling
in the compiler.
"""
from __future__ import annotations

import dataclasses
import http.server
import json
import threading
import time

from .metrics import Histogram, MetricsRegistry, escape_label_value

TELEMETRY_SCHEMA = "telemetry/v1"

# histogram sub-fields promoted to individual series
_HIST_FIELDS = ("count", "mean", "p50", "p95", "p99")


class SeriesRing:
    """Fixed-capacity (time, value) ring. Append-only, O(1) memory."""

    __slots__ = ("capacity", "_t", "_v", "_n", "_i")

    def __init__(self, capacity: int = 600):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._t = [0.0] * capacity
        self._v = [0.0] * capacity
        self._n = 0            # total appends ever
        self._i = 0            # next write slot

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def append(self, t: float, v: float) -> None:
        self._t[self._i] = t
        self._v[self._i] = v
        self._i = (self._i + 1) % self.capacity
        self._n += 1

    def items(self) -> list[tuple[float, float]]:
        """Samples oldest-first."""
        n = len(self)
        start = (self._i - n) % self.capacity
        return [(self._t[(start + k) % self.capacity],
                 self._v[(start + k) % self.capacity]) for k in range(n)]

    def last(self) -> tuple[float, float] | None:
        if not self._n:
            return None
        j = (self._i - 1) % self.capacity
        return self._t[j], self._v[j]

    def window(self, now: float, seconds: float) -> list[tuple[float, float]]:
        """Samples with t >= now - seconds, oldest-first."""
        lo = now - seconds
        return [(t, v) for t, v in self.items() if t >= lo]


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative SLO rule.

    ``kind="burn_rate"``: ``bad``/``total`` name two counter series;
    the rule fires when, over the last ``window_s``,
    ``(Δbad/Δtotal) / (1 - objective) > threshold`` and at least
    ``min_events`` of ``total`` accrued (so an idle engine never pages).

    ``kind="threshold"``: ``series`` names any sampled series (e.g.
    ``frame_engine_queue_wait_s.p99``); the rule fires when the
    window's worst value crosses ``threshold`` in direction ``op``.
    """
    name: str
    kind: str                       # "burn_rate" | "threshold"
    window_s: float = 30.0
    threshold: float = 1.0
    # burn_rate fields
    bad: str = ""
    total: str = ""
    objective: float = 0.99
    min_events: int = 10
    # threshold fields
    series: str = ""
    op: str = ">"

    def __post_init__(self):
        if self.kind not in ("burn_rate", "threshold"):
            raise ValueError(f"unknown alert kind {self.kind!r}")
        if self.kind == "burn_rate" and not (self.bad and self.total):
            raise ValueError(f"{self.name}: burn_rate needs bad+total")
        if self.kind == "threshold" and not self.series:
            raise ValueError(f"{self.name}: threshold needs series")
        if self.op not in (">", "<"):
            raise ValueError(f"{self.name}: op must be '>' or '<'")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"{self.name}: objective must be in (0, 1)")

    def evaluate(self, rings: dict[str, SeriesRing], now: float
                 ) -> tuple[bool, float]:
        """(condition holds, observed value) against the sampled rings."""
        if self.kind == "burn_rate":
            b = rings.get(self.bad)
            t = rings.get(self.total)
            if b is None or t is None:
                return False, 0.0
            wb, wt = b.window(now, self.window_s), t.window(now, self.window_s)
            if len(wb) < 2 or len(wt) < 2:
                return False, 0.0
            d_bad = wb[-1][1] - wb[0][1]
            d_total = wt[-1][1] - wt[0][1]
            if d_total < self.min_events:
                return False, 0.0
            burn = (d_bad / d_total) / (1.0 - self.objective)
            return burn > self.threshold, burn
        r = rings.get(self.series)
        if r is None:
            return False, 0.0
        w = r.window(now, self.window_s)
        if not w:
            return False, 0.0
        worst = (max if self.op == ">" else min)(v for _, v in w)
        hit = worst > self.threshold if self.op == ">" else \
            worst < self.threshold
        return hit, worst


@dataclasses.dataclass
class AlertState:
    rule: AlertRule
    firing: bool = False
    since: float | None = None      # when the current state began
    value: float = 0.0              # last observed burn / worst value
    fired_count: int = 0            # ok -> firing transitions ever
    transitions: list = dataclasses.field(default_factory=list)

    def update(self, hit: bool, value: float, now: float) -> None:
        self.value = value
        if hit and not self.firing:
            self.firing = True
            self.since = now
            self.fired_count += 1
            self.transitions.append(
                {"t": now, "state": "firing", "value": value})
        elif not hit and self.firing:
            self.firing = False
            self.since = now
            self.transitions.append(
                {"t": now, "state": "resolved", "value": value})

    def snapshot(self) -> dict:
        return {
            "rule": self.rule.name,
            "kind": self.rule.kind,
            "window_s": self.rule.window_s,
            "threshold": self.rule.threshold,
            "firing": self.firing,
            "since": self.since,
            "value": self.value,
            "fired_count": self.fired_count,
            "transitions": list(self.transitions),
        }


def default_slo_rules(prefix: str = "frame_engine",
                      deadline_objective: float = 0.95,
                      shed_objective: float = 0.90,
                      p99_queue_wait_s: float = 0.25,
                      window_s: float = 30.0) -> list[AlertRule]:
    """The serving SLOs the chaos harness gates on, as alert rules.

    Defaults mirror the soak's tolerances: completed frames may miss
    their deadline at most 1-in-20 (objective 0.95), at most 1-in-10
    offered frames may shed (0.90), and p99 queue wait stays under
    250 ms. Burn thresholds are 1.0 — fire as soon as the window burns
    budget faster than the objective allows.
    """
    return [
        AlertRule(name=f"{prefix}:deadline_miss_burn", kind="burn_rate",
                  bad=f"{prefix}_deadline_missed",
                  total=f"{prefix}_frames_completed",
                  objective=deadline_objective, window_s=window_s),
        AlertRule(name=f"{prefix}:shed_burn", kind="burn_rate",
                  bad=f"{prefix}_frames_shed",
                  total=f"{prefix}_frames_offered",
                  objective=shed_objective, window_s=window_s),
        AlertRule(name=f"{prefix}:queue_wait_p99", kind="threshold",
                  series=f"{prefix}_queue_wait_s.p99", op=">",
                  threshold=p99_queue_wait_s, window_s=window_s),
    ]


class TelemetryCollector:
    """Background sampler: registry snapshots -> rings -> alert rules.

    ``sample_once()`` is also public (and what the thread calls) so
    tests and single-threaded drivers can drive time explicitly via
    ``now=``. All ring/alert state is guarded by one lock; registry
    reads use the registry's own snapshot locking, so engines keep
    mutating metrics while the collector samples.
    """

    def __init__(self, registry: MetricsRegistry, period_s: float = 0.5,
                 capacity: int = 600,
                 rules: list[AlertRule] | None = None):
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.registry = registry
        self.period_s = period_s
        self.capacity = capacity
        self.rules = list(rules or [])
        self.alerts = {r.name: AlertState(rule=r) for r in self.rules}
        self.rings: dict[str, SeriesRing] = {}
        self.samples_taken = 0
        self.started_at: float | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ sampling
    def _flatten(self, snap: dict) -> dict[str, float]:
        flat: dict[str, float] = {}
        for name, v in snap.items():
            if isinstance(v, dict):        # histogram stat dict
                for f in _HIST_FIELDS:
                    if f in v:
                        flat[f"{name}.{f}"] = float(v[f])
            elif isinstance(v, (int, float)):
                flat[name] = float(v)
        return flat

    def sample_once(self, now: float | None = None) -> dict[str, float]:
        """Take one sample and evaluate alerts; returns the flat sample."""
        if now is None:
            now = time.monotonic()
        flat = self._flatten(self.registry.snapshot())
        with self._lock:
            for name, v in flat.items():
                ring = self.rings.get(name)
                if ring is None:
                    ring = self.rings[name] = SeriesRing(self.capacity)
                ring.append(now, v)
            for st in self.alerts.values():
                hit, value = st.rule.evaluate(self.rings, now)
                st.update(hit, value, now)
            self.samples_taken += 1
        return flat

    # ------------------------------------------------------------- control
    def start(self) -> None:
        if self._thread is not None:
            return
        self.started_at = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-collector", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_once()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # --------------------------------------------------------------- views
    def firing(self) -> list[str]:
        with self._lock:
            return sorted(n for n, st in self.alerts.items() if st.firing)

    def alert_snapshot(self) -> list[dict]:
        with self._lock:
            return [self.alerts[n].snapshot() for n in sorted(self.alerts)]

    def snapshot(self) -> dict:
        """Full JSON-able state, schema ``telemetry/v1``."""
        with self._lock:
            series = {}
            for name in sorted(self.rings):
                items = self.rings[name].items()
                series[name] = {"t": [t for t, _ in items],
                                "v": [v for _, v in items]}
            return {
                "schema": TELEMETRY_SCHEMA,
                "period_s": self.period_s,
                "capacity": self.capacity,
                "samples_taken": self.samples_taken,
                "series": series,
                "alerts": [self.alerts[n].snapshot()
                           for n in sorted(self.alerts)],
            }

    def alert_exposition(self) -> str:
        """``slo_alert_firing``/``slo_alert_fired_total`` gauge families
        with rule names as (escaped) label values — appended to the
        registry exposition by the HTTP endpoint."""
        lines = ["# HELP slo_alert_firing 1 while the SLO alert rule "
                 "is in the firing state",
                 "# TYPE slo_alert_firing gauge"]
        with self._lock:
            states = [self.alerts[n] for n in sorted(self.alerts)]
            rows = [(st.rule.name, st.firing, st.fired_count, st.value)
                    for st in states]
        for name, firing, _, _ in rows:
            lines.append(f'slo_alert_firing{{rule="'
                         f'{escape_label_value(name)}"}} '
                         f'{1 if firing else 0}')
        lines.append("# HELP slo_alert_fired_total firing transitions "
                     "since collector start")
        lines.append("# TYPE slo_alert_fired_total counter")
        for name, _, fired, _ in rows:
            lines.append(f'slo_alert_fired_total{{rule="'
                         f'{escape_label_value(name)}"}} {fired}')
        return "\n".join(lines) + "\n"


def alerts_text(alerts: list[dict]) -> str:
    """Terminal table of alert-state dicts (obs_report --alerts)."""
    rows = [f"{'rule':<34} {'state':<9} {'value':>8} {'thresh':>7} "
            f"{'window':>7} {'fired':>5}"]
    for a in alerts:
        rows.append(
            f"{a['rule']:<34} "
            f"{'FIRING' if a['firing'] else 'ok':<9} "
            f"{a['value']:>8.2f} {a['threshold']:>7.2f} "
            f"{a['window_s']:>6.0f}s {a['fired_count']:>5}")
        for tr in a.get("transitions", [])[-3:]:
            rows.append(f"    {tr['state']:>9} at t={tr['t']:.2f} "
                        f"(value {tr['value']:.2f})")
    if len(rows) == 1:
        rows.append("(no alert rules registered)")
    return "\n".join(rows)


# ------------------------------------------------------------------- http
class _Handler(http.server.BaseHTTPRequestHandler):
    # the collector is attached to the *server* object by TelemetryServer
    server_version = "repro-torch-telemetry/1"

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        collector = self.server.collector
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = (collector.registry.to_prometheus_text()
                    + collector.alert_exposition())
            self._send(200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            # 503 while any alert fires so a probe/load-balancer can act
            # on the SLO state without parsing the body
            firing = collector.firing()
            if firing:
                self._send(503, "degraded: " + ", ".join(firing) + "\n",
                           "text/plain")
            else:
                self._send(200, "ok\n", "text/plain")
        elif path == "/snapshot":
            self._send(200, json.dumps(collector.snapshot()),
                       "application/json")
        else:
            self._send(404, "not found\n", "text/plain")

    def log_message(self, *a):       # silence per-request stderr spam
        pass


class TelemetryServer:
    """Threaded HTTP endpoint over a :class:`TelemetryCollector`.

    ``port=0`` (the default) binds an ephemeral port; read ``.port``
    after ``start()``. The server thread is a daemon, so a crashed soak
    never hangs on it.
    """

    def __init__(self, collector: TelemetryCollector,
                 host: str = "127.0.0.1", port: int = 0):
        self.collector = collector
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.collector = collector
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-http",
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._httpd.shutdown()
        t.join(timeout=5.0)
        self._httpd.server_close()
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
