"""Port telemetry plane and trace export, against the JAX package.

The contracts of tests/test_telemetry.py (rings, SLO burn-rate alerts,
collector concurrency, the HTTP endpoint on localhost, exposition
hardening) and the export half of tests/test_obs.py, held by
``repro_torch.obs``; then the same sample series and the same event
list through both packages' ``default_slo_rules``, ``validate_trace``,
``flame_summary`` and ``slo_summary``, which must agree exactly.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import export as jax_export
from repro.obs import telemetry as jax_telemetry
from repro_torch.obs import Tracer, export, trace
from repro_torch.obs.metrics import (MetricsRegistry, escape_label_value,
                                     validate_metric_name)
from repro_torch.obs.telemetry import (TELEMETRY_SCHEMA, AlertRule,
                                       AlertState, SeriesRing,
                                       TelemetryCollector, TelemetryServer,
                                       alerts_text, default_slo_rules)


# ------------------------------------------------------------ SeriesRing
def test_series_ring_wraparound():
    r = SeriesRing(capacity=4)
    for i in range(10):
        r.append(float(i), float(i * 10))
    items = r.items()
    assert len(items) == 4
    assert [t for t, _ in items] == [6.0, 7.0, 8.0, 9.0]
    assert r.last() == (9.0, 90.0)
    assert r.window(9.0, 2.5) == [(7.0, 70.0), (8.0, 80.0), (9.0, 90.0)]
    assert SeriesRing().last() is None


# ------------------------------------------------------------- AlertRule
def _burn_rings(bad_pts, total_pts):
    rings = {"e_bad": SeriesRing(), "e_total": SeriesRing()}
    for t, v in bad_pts:
        rings["e_bad"].append(t, v)
    for t, v in total_pts:
        rings["e_total"].append(t, v)
    return rings


def test_burn_rate_math():
    # objective 0.99 -> error budget 1%; 5 bad / 100 total over the
    # window is a 5% error rate = 5x burn
    rule = AlertRule(name="r", kind="burn_rate", bad="e_bad",
                     total="e_total", objective=0.99, threshold=4.0,
                     window_s=30.0, min_events=10)
    rings = _burn_rings([(0.0, 0.0), (10.0, 5.0)],
                        [(0.0, 0.0), (10.0, 100.0)])
    hit, val = rule.evaluate(rings, now=10.0)
    assert hit and val == pytest.approx(5.0)
    # same data, higher threshold: no fire
    calm = AlertRule(name="r", kind="burn_rate", bad="e_bad",
                     total="e_total", objective=0.99, threshold=6.0,
                     window_s=30.0, min_events=10)
    assert calm.evaluate(rings, now=10.0)[0] is False


def test_burn_rate_needs_min_events():
    rule = AlertRule(name="r", kind="burn_rate", bad="e_bad",
                     total="e_total", objective=0.99, threshold=1.0,
                     window_s=30.0, min_events=10)
    # 100% error rate but only 4 events in the window: suppressed
    rings = _burn_rings([(0.0, 0.0), (5.0, 4.0)],
                        [(0.0, 0.0), (5.0, 4.0)])
    hit, _ = rule.evaluate(rings, now=5.0)
    assert hit is False


def test_burn_rate_window_slides():
    rule = AlertRule(name="r", kind="burn_rate", bad="e_bad",
                     total="e_total", objective=0.99, threshold=1.0,
                     window_s=10.0, min_events=10)
    # all the badness is old; inside the window the counters are flat
    rings = _burn_rings([(0.0, 0.0), (1.0, 50.0), (20.0, 50.0)],
                        [(0.0, 0.0), (1.0, 100.0), (20.0, 100.0)])
    assert rule.evaluate(rings, now=20.0)[0] is False


def test_threshold_rule_ops():
    rings = {"lat.p99": SeriesRing()}
    for t, v in [(0.0, 0.1), (1.0, 0.4), (2.0, 0.2)]:
        rings["lat.p99"].append(t, v)
    hi = AlertRule(name="hi", kind="threshold", series="lat.p99",
                   op=">", threshold=0.3, window_s=10.0)
    hit, val = hi.evaluate(rings, now=2.0)
    assert hit and val == pytest.approx(0.4)     # window max for ">"
    lo = AlertRule(name="lo", kind="threshold", series="lat.p99",
                   op="<", threshold=0.05, window_s=10.0)
    assert lo.evaluate(rings, now=2.0)[0] is False


def test_rule_validation():
    with pytest.raises(ValueError):
        AlertRule(name="x", kind="nope")
    with pytest.raises(ValueError):
        AlertRule(name="x", kind="burn_rate", bad="b")        # no total
    with pytest.raises(ValueError):
        AlertRule(name="x", kind="threshold")                 # no series
    with pytest.raises(ValueError):
        AlertRule(name="x", kind="threshold", series="s", op="~")
    with pytest.raises(ValueError):
        AlertRule(name="x", kind="burn_rate", bad="b", total="t",
                  objective=1.0)


def test_alert_state_transitions():
    rule = AlertRule(name="r", kind="threshold", series="s",
                     threshold=1.0, window_s=5.0)
    st = AlertState(rule)
    rings = {"s": SeriesRing()}

    def step(now):
        hit, value = rule.evaluate(rings, now)
        st.update(hit, value, now)

    rings["s"].append(0.0, 0.5)
    step(0.0)
    assert not st.firing and st.fired_count == 0
    rings["s"].append(1.0, 2.0)
    step(1.0)
    step(2.0)                            # stays firing: one transition
    assert st.firing and st.fired_count == 1
    rings["s"].append(7.0, 0.1)          # spike ages out of the window
    step(7.0)
    assert not st.firing
    snap = st.snapshot()
    assert [tr["state"] for tr in snap["transitions"]] \
        == ["firing", "resolved"]
    assert snap["rule"] == "r" and snap["fired_count"] == 1


def test_default_slo_rules_shape():
    rules = default_slo_rules(prefix="frame_engine")
    names = {r.name for r in rules}
    assert names == {"frame_engine:deadline_miss_burn",
                     "frame_engine:shed_burn",
                     "frame_engine:queue_wait_p99"}
    burn = [r for r in rules if r.kind == "burn_rate"]
    assert all(r.bad.startswith("frame_engine_") for r in burn)
    assert all(r.total.startswith("frame_engine_") for r in burn)


# ------------------------------------------------------------- collector
def test_collector_synthetic_burn_fires_and_resolves():
    reg = MetricsRegistry()
    bad = reg.counter("e_deadline_missed")
    total = reg.counter("e_frames_completed")
    rule = AlertRule(name="e:burn", kind="burn_rate",
                     bad="e_deadline_missed", total="e_frames_completed",
                     objective=0.95, threshold=2.0, window_s=10.0,
                     min_events=10)
    col = TelemetryCollector(reg, rules=[rule])
    now = 0.0
    for _ in range(5):                           # healthy traffic
        total.inc(20)
        col.sample_once(now=now)
        now += 1.0
    assert not col.firing()
    for _ in range(5):                           # inject the burn
        bad.inc(10)
        total.inc(20)
        col.sample_once(now=now)
        now += 1.0
    assert col.firing() == ["e:burn"]
    for _ in range(15):                          # recover
        total.inc(20)
        col.sample_once(now=now)
        now += 1.0
    assert not col.firing()
    (snap,) = col.alert_snapshot()
    assert snap["fired_count"] >= 1
    states = [tr["state"] for tr in snap["transitions"]]
    assert states[0] == "firing" and states[-1] == "resolved"
    assert "e:burn" in alerts_text(col.alert_snapshot())


def test_collector_snapshot_flattens_histograms():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    reg.counter("reqs").inc(3)
    col = TelemetryCollector(reg)
    col.sample_once(now=1.0)
    snap = col.snapshot()
    assert snap["schema"] == TELEMETRY_SCHEMA
    for key in ("reqs", "lat_s.count", "lat_s.mean", "lat_s.p50",
                "lat_s.p95", "lat_s.p99"):
        assert key in snap["series"], key
    assert snap["series"]["lat_s.count"]["v"][-1] == 3.0
    rt = json.loads(json.dumps(snap))            # artifact round-trip
    assert rt["schema"] == TELEMETRY_SCHEMA


def test_collector_concurrent_with_mutating_threads():
    """Writers hammer the registry while the collector samples; every
    snapshot must stay internally consistent (no torn reads, bad never
    ahead of total)."""
    reg = MetricsRegistry()
    bad = reg.counter("w_deadline_missed")
    total = reg.counter("w_frames_completed")
    rule = AlertRule(name="w:burn", kind="burn_rate",
                     bad="w_deadline_missed", total="w_frames_completed",
                     objective=0.5, threshold=1e9, window_s=60.0)
    col = TelemetryCollector(reg, period_s=0.001, rules=[rule])
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            total.inc()
            if total.value % 7 == 0:
                bad.inc()
            reg.gauge("w_pending").set(total.value % 13)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    try:
        with col:
            for th in threads:
                th.start()
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                s = col.snapshot()["series"]
                if "w_frames_completed" in s and "w_deadline_missed" in s:
                    for b, t in zip(s["w_deadline_missed"]["v"],
                                    s["w_frames_completed"]["v"]):
                        assert b <= t
                    if s["w_frames_completed"]["v"][-1] > 5000:
                        break
                time.sleep(0.01)
    finally:
        stop.set()
        for th in threads:
            th.join()
    assert col.snapshot()["series"]["w_frames_completed"]["v"][-1] > 0
    assert not col.firing()                      # threshold unreachable


def test_http_endpoints_live_while_mutating():
    reg = MetricsRegistry()
    total = reg.counter("h_frames_completed")
    col = TelemetryCollector(
        reg, period_s=0.005,
        rules=[AlertRule(name="h:burn", kind="burn_rate",
                         bad="h_frames_shed", total="h_frames_offered")])
    reg.counter("h_frames_shed")
    reg.counter("h_frames_offered")
    srv = TelemetryServer(col)
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            total.inc()

    th = threading.Thread(target=writer)
    try:
        with col:
            srv.start()
            th.start()
            time.sleep(0.05)
            body = urllib.request.urlopen(
                srv.url + "/metrics", timeout=5).read().decode()
            assert "# TYPE h_frames_completed counter" in body
            assert "# HELP h_frames_completed" in body
            assert 'slo_alert_firing{rule="h:burn"} 0' in body
            assert "slo_alert_fired_total" in body
            health = urllib.request.urlopen(
                srv.url + "/healthz", timeout=5).read().decode()
            assert health == "ok\n"
            snap = json.loads(urllib.request.urlopen(
                srv.url + "/snapshot", timeout=5).read().decode())
            assert snap["schema"] == TELEMETRY_SCHEMA
            assert "h_frames_completed" in snap["series"]
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(srv.url + "/nope", timeout=5)
    finally:
        stop.set()
        th.join()
        srv.stop()


def test_healthz_degraded_while_firing():
    reg = MetricsRegistry()
    reg.counter("d_bad").inc(100)
    reg.counter("d_total").inc(100)
    col = TelemetryCollector(
        reg, rules=[AlertRule(name="d:burn", kind="burn_rate",
                              bad="d_bad", total="d_total",
                              objective=0.99, threshold=1.0,
                              window_s=60.0, min_events=10)])
    col.sample_once(now=0.0)
    reg.counter("d_bad").inc(50)
    reg.counter("d_total").inc(50)
    col.sample_once(now=1.0)
    assert col.firing() == ["d:burn"]
    srv = TelemetryServer(col)
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=5)
        assert ei.value.code == 503
        assert "d:burn" in ei.value.read().decode()
    finally:
        srv.stop()


# ------------------------------------------------ exposition hardening
def test_metric_name_validation():
    validate_metric_name("frame_engine_frames_total")
    validate_metric_name("_leading:colon_ok")
    for bad in ("", "9starts_with_digit", "has-dash", "has space",
                "unicodé"):
        with pytest.raises(ValueError):
            validate_metric_name(bad)
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("bad-name")
    with pytest.raises(ValueError):
        reg.gauge("1bad")
    with pytest.raises(ValueError):
        reg.histogram("also bad")


def test_escape_label_value():
    assert escape_label_value('pla"in') == 'pla\\"in'
    assert escape_label_value("back\\slash") == "back\\\\slash"
    assert escape_label_value("new\nline") == "new\\nline"
    # backslash escaped first so escapes never double-escape
    assert escape_label_value('\\"\n') == '\\\\\\"\\n'


def test_exposition_has_help_and_type_for_every_family():
    reg = MetricsRegistry()
    reg.counter("exp_total", help="a counter")
    reg.gauge("exp_gauge")                       # no help text
    reg.histogram("exp_hist_s", help="a histogram")
    reg.counter("exp_total").inc(2)
    text = reg.to_prometheus_text()
    for fam in ("exp_total", "exp_gauge", "exp_hist_s"):
        assert f"# TYPE {fam}" in text, fam
        assert f"# HELP {fam}" in text, fam
    assert "# HELP exp_gauge\n" in text          # bare HELP, no trailing sp
    assert "exp_total 2" in text


def test_alert_exposition_escapes_rule_labels():
    reg = MetricsRegistry()
    reg.counter("q_bad")
    reg.counter("q_total")
    rule = AlertRule(name='we"ird\nrule\\x', kind="burn_rate",
                     bad="q_bad", total="q_total")
    col = TelemetryCollector(reg, rules=[rule])
    col.sample_once(now=0.0)
    text = col.alert_exposition()
    assert 'rule="we\\"ird\\nrule\\\\x"' in text
    assert "\nrule" not in text.replace("\\n", "")  # no raw newline leaks


# ------------------------------------------------------------ export
@pytest.fixture
def global_trace():
    """Enable the process-global tracer for a test; always restore."""
    trace.clear()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.clear()


def test_chrome_trace_round_trip(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("a", pipeline="p", w=32):
        with tr.span("b", n=np.int64(3), f=np.float32(0.5)):
            pass
    data = export.to_chrome_trace(tr.events(), process_name="test")
    assert export.validate_trace(data) == []
    path = tmp_path / "t.json"
    export.write_trace(str(path), data)
    loaded = export.load_trace(str(path))
    assert export.validate_trace(loaded) == []
    json.dumps(loaded)
    spans = {e["name"]: e for e in loaded["traceEvents"]
             if e["ph"] == "X"}
    assert set(spans) == {"a", "b"}
    assert spans["b"]["args"]["parent"] == "a"
    assert spans["b"]["args"]["depth"] == 1
    assert spans["b"]["args"]["n"] == 3
    assert spans["a"]["args"]["pipeline"] == "p"
    meta = [e for e in loaded["traceEvents"] if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "test"


def test_validate_trace_rejects_corruption():
    tr = Tracer(enabled=True)
    with tr.span("a"):
        pass
    good = export.to_chrome_trace(tr.events())
    assert export.validate_trace("not a dict")
    assert export.validate_trace({}) == ["missing or non-list 'traceEvents'"]
    bad = json.loads(json.dumps(good))
    bad["otherData"]["schema"] = "wrong/v9"
    assert any("schema" in e for e in export.validate_trace(bad))
    bad = json.loads(json.dumps(good))
    bad["traceEvents"][1]["dur"] = -5.0
    assert any("dur" in e for e in export.validate_trace(bad))
    bad = json.loads(json.dumps(good))
    bad["traceEvents"][1]["ph"] = "Q"
    assert any("ph" in e for e in export.validate_trace(bad))
    bad = json.loads(json.dumps(good))
    bad["traceEvents"] = [e for e in bad["traceEvents"] if e["ph"] != "X"]
    assert any("no complete" in e for e in export.validate_trace(bad))


def test_flame_summary_self_time():
    tr = Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    data = export.to_chrome_trace(tr.events())
    text = export.flame_summary(data)
    assert "outer" in text and "inner" in text and "self ms" in text
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    self_us = dict(zip([e["name"] for e in spans],
                       export._self_times_us(spans)))
    durs = {e["name"]: e["dur"] for e in spans}
    assert self_us["inner"] == pytest.approx(durs["inner"])
    assert self_us["outer"] == pytest.approx(durs["outer"] - durs["inner"])
    assert export.flame_summary({"traceEvents": []}) == "(no spans)"


def test_export_global_trace(tmp_path, global_trace):
    with trace.span("solo", k=1):
        pass
    path = tmp_path / "g.json"
    data = export.export_global_trace(str(path), process_name="gtest")
    assert path.exists()
    assert export.validate_trace(data) == []
    names = [e["name"] for e in data["traceEvents"] if e["ph"] == "X"]
    assert names == ["solo"]


# ------------------------------------------- the port against the package
def _event_list():
    """One trace with the control plane's spans: nested engine spans on
    two threads, rejects, sheds, retries and fallbacks."""
    tr = Tracer(enabled=True)

    def work(k):
        with tr.span("engine.step", engine="frame", delivered=2,
                     deadline_missed=k % 2, failed=0):
            with tr.span("engine.execute", pipeline="unsharp-m"):
                with tr.span("executor.call"):
                    time.sleep(0.001)
            with tr.span("resilience.retry", attempt=1,
                         delay_s=0.004 * (k + 1), error="InjectedFault"):
                pass
            with tr.span("resilience.fallback", rung="default"):
                pass
        for reason in ("nonfinite", "rate_limited")[:k % 2 + 1]:
            with tr.span("resilience.reject", reason=reason):
                pass
        with tr.span("resilience.shed", reason="deadline"):
            pass
    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return tr.events()


def test_validate_and_flame_summary_match_the_reference():
    data = export.to_chrome_trace(_event_list())
    assert jax_export.validate_trace(data) == export.validate_trace(data)
    assert export.validate_trace(data) == []
    assert jax_export.flame_summary(data) == export.flame_summary(data)
    assert jax_export.slo_summary(data) == export.slo_summary(data)
    assert jax_export.slo_text(data) == export.slo_text(data)
    s = export.slo_summary(data)
    assert s["delivered"] == 6 and s["deadline_missed"] == 1
    assert s["retries"]["count"] == 3 and s["fallbacks"]["total"] == 3
    for corrupt in ({"dur": -1.0}, {"ph": "Q"}, {"tid": "x"},
                    {"name": ""}, {"args": []}):
        bad = json.loads(json.dumps(data))
        bad["traceEvents"][2].update(corrupt)
        assert export.validate_trace(bad) == jax_export.validate_trace(bad)
        assert export.validate_trace(bad)


def _sample_series(mod, prefix):
    """One registry history, fed to a collector sample by sample."""
    rng = np.random.RandomState(17)
    reg = mod.MetricsRegistry()
    offered = reg.counter(f"{prefix}_frames_offered")
    shed = reg.counter(f"{prefix}_frames_shed")
    done = reg.counter(f"{prefix}_frames_completed")
    missed = reg.counter(f"{prefix}_deadline_missed")
    wait = reg.histogram(f"{prefix}_queue_wait_s")
    col = mod.TelemetryCollector(reg, rules=mod.default_slo_rules(
        prefix, window_s=5.0))
    log = []
    for t in range(60):
        burst = 10 <= t < 20 or 40 <= t < 45
        n = int(rng.randint(5, 30))
        offered.inc(n)
        shed.inc(int(n * (0.3 if burst else 0.02)))
        done.inc(n)
        missed.inc(int(n * (0.2 if burst else 0.0)))
        for _ in range(4):
            wait.observe(float(rng.rand()) * (0.6 if burst else 0.05))
        col.sample_once(now=float(t))
        log.append((col.firing(), [(a["rule"], a["firing"], a["value"])
                                   for a in col.alert_snapshot()]))
    return log, col.alert_snapshot()


class _JaxMods:
    from repro.obs.metrics import MetricsRegistry
    TelemetryCollector = jax_telemetry.TelemetryCollector
    default_slo_rules = staticmethod(jax_telemetry.default_slo_rules)


class _PortMods:
    MetricsRegistry = MetricsRegistry
    TelemetryCollector = TelemetryCollector
    default_slo_rules = staticmethod(default_slo_rules)


@pytest.mark.parametrize("prefix", ["frame_engine", "video_engine"])
def test_slo_rule_evaluations_match_the_reference(prefix):
    got, snap = _sample_series(_PortMods, prefix)
    want, want_snap = _sample_series(_JaxMods, prefix)
    assert got == want and snap == want_snap
    fired = {a["rule"] for a in snap if a["fired_count"]}
    assert fired == {f"{prefix}:deadline_miss_burn", f"{prefix}:shed_burn",
                     f"{prefix}:queue_wait_p99"}
    # the burn rules resolve once the window holds no burst; the queue
    # wait histogram is cumulative, so its p99 stays over the threshold
    assert all(a["transitions"][-1]["state"] == "resolved"
               for a in snap if a["kind"] == "burn_rate")
