"""Port observability: tracer spans, metrics registry, engine spans, and
the same under stress.

The tracer, metrics and engine-span half of tests/test_obs.py and all of
tests/test_obs_stress.py, held by ``repro_torch.obs.trace``,
``repro_torch.obs.metrics`` and ``repro_torch.imaging.EngineMetrics``;
the export half is mirrored in tests/test_torch_telemetry.py. Where both
packages can take the same inputs (histograms, registries, Prometheus
text, reconciliation), the port's answer is held equal to the JAX
package's. The JAX engines cannot run here (their Pallas executors need
``pl.load``), so the engine tests hold the port's engines, on the CPU,
to the span names, nesting and attributes tests/test_obs.py asserts.
"""
import re
import threading

import numpy as np
import pytest

from repro.imaging.metrics import EngineMetrics as JaxEngineMetrics
from repro.obs import metrics as jax_metrics
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
from repro_torch.imaging.metrics import EngineMetrics
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             Tracer, export, trace)
from repro_torch.obs.metrics import UNIT_BUCKETS
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.video import VideoEngine, VideoFrame

RNG = np.random.RandomState(7)


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


def _hammer(n_threads, fn):
    """Run fn(thread_index) on n_threads threads, re-raising any error."""
    errs = []

    def runner(k):
        try:
            fn(k)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=runner, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs


# ------------------------------------------------------------------ tracer
def test_span_nesting_depth_parent_attrs():
    tr = Tracer(enabled=True)
    with tr.span("outer", pipeline="unsharp-m"):
        with tr.span("middle", w=64) as sp:
            sp.set(late=True, n=3)
            with tr.span("inner"):
                pass
    evs = {e.name: e for e in tr.events()}
    assert set(evs) == {"outer", "middle", "inner"}
    assert (evs["outer"].depth, evs["outer"].parent) == (0, None)
    assert (evs["middle"].depth, evs["middle"].parent) == (1, "outer")
    assert (evs["inner"].depth, evs["inner"].parent) == (2, "middle")
    assert evs["outer"].attrs == {"pipeline": "unsharp-m"}
    assert evs["middle"].attrs == {"w": 64, "late": True, "n": 3}
    # completion order: inner exits first, outer last
    assert [e.name for e in tr.events()] == ["inner", "middle", "outer"]
    # children are contained in the parent's interval
    for child, parent in (("inner", "middle"), ("middle", "outer")):
        c, p = evs[child], evs[parent]
        assert p.ts_ns <= c.ts_ns
        assert c.ts_ns + c.dur_ns <= p.ts_ns + p.dur_ns


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    sp = tr.span("never", pipeline="x")
    assert sp is NULL_SPAN            # shared singleton: no allocation
    with sp as s:
        s.set(anything=1)             # attribute set is swallowed
    assert tr.events() == []
    assert len(tr) == 0
    # module-level fast path returns the same singleton when disabled
    assert not trace.enabled()
    assert trace.span("never") is NULL_SPAN


def test_profile_span_records_like_any_other():
    """Under a ``torch.profiler`` every span (the port's counterpart of
    the reference's ``xla=True``, for all spans) is also a
    ``record_function`` annotation of its name; the span it records is
    the one recorded without the profiler."""
    import torch

    def spans(tr):
        with tr.span("engine.step", engine="frame"):
            with tr.span("engine.execute", pipeline="p"):
                with tr.span("executor.call"):
                    pass
        return [(e.name, e.attrs, e.depth, e.parent) for e in tr.events()]

    plain = spans(Tracer(enabled=True))
    tr = Tracer(enabled=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiled = spans(tr)
    assert profiled == plain == [
        ("executor.call", {}, 2, "engine.execute"),
        ("engine.execute", {"pipeline": "p"}, 1, "engine.step"),
        ("engine.step", {"engine": "frame"}, 0, None)]
    marks = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert sorted(marks) == sorted(name for name, *_ in plain)


def test_traced_decorator():
    tr = Tracer(enabled=True)

    @tr.traced("work.unit", kind="test")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    evs = tr.events()
    assert [e.name for e in evs] == ["work.unit"] * 2
    assert all(e.attrs == {"kind": "test"} for e in evs)

    @tr.traced()
    def unnamed():
        return 42

    assert unnamed() == 42
    assert tr.events()[-1].name.endswith("unnamed")


def test_ring_buffer_capacity_drops_oldest():
    tr = Tracer(enabled=True, capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [e.name for e in tr.events()] == ["s6", "s7", "s8", "s9"]
    tr.clear()
    assert tr.events() == []
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_span_exit_threadsafe():
    tr = Tracer(enabled=True)

    def worker(k):
        for i in range(50):
            with tr.span(f"t{k}", i=i):
                pass

    _hammer(4, worker)
    evs = tr.events()
    assert len(evs) == 200              # no event lost to a race
    for k in range(4):
        assert sum(e.name == f"t{k}" for e in evs) == 50
    assert all(e.depth == 0 for e in evs)   # stacks are thread-local


# ----------------------------------------------------------------- metrics
def test_histogram_percentiles_vs_numpy():
    rng = np.random.RandomState(0)
    # lognormal latencies spanning several exponential buckets
    xs = rng.lognormal(mean=-7.0, sigma=1.5, size=2000)
    h = Histogram("lat")
    for x in xs:
        h.observe(float(x))
    for q in (50.0, 95.0, 99.0):
        exact = float(np.percentile(xs, q))
        est = h.percentile(q)
        # the estimate lands within the bucket that contains the exact
        # answer — bucket bounds are factor-2, so 2x each way
        assert exact / 2 <= est <= exact * 2, (q, exact, est)
    snap = h.snapshot()
    assert snap["count"] == 2000
    assert snap["mean"] == pytest.approx(xs.mean())
    assert snap["max"] == pytest.approx(xs.max())
    assert snap["min"] == pytest.approx(xs.min())
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_the_reference(seed):
    """The same observations give the same counts, percentiles and
    snapshot in both packages."""
    xs = np.random.RandomState(seed).lognormal(-6.0, 2.0, size=500)
    h, jh = Histogram("lat"), jax_metrics.Histogram("lat")
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    assert h.counts == jh.counts
    assert h.snapshot() == jh.snapshot()
    for q in (1.0, 50.0, 95.0, 99.0, 100.0):
        assert h.percentile(q) == jh.percentile(q)


def test_histogram_edge_cases():
    h = Histogram("h", buckets=UNIT_BUCKETS)
    assert h.snapshot() == {"count": 0, "mean": 0.0, "max": 0.0, "min": 0.0,
                            "p50": 0.0, "p95": 0.0, "p99": 0.0}
    h.observe(0.5)
    # single sample: every percentile is that sample (clamped to min/max)
    assert h.percentile(1.0) == h.percentile(99.0) == 0.5
    h2 = Histogram("h2")
    h2.observe(1e9)                   # beyond the last bound: +Inf bucket
    assert h2.percentile(50.0) == 1e9
    with pytest.raises(ValueError, match="ascending"):
        Histogram("bad", buckets=(2.0, 1.0))


def test_registry_get_or_create_and_type_check():
    reg = MetricsRegistry()
    c = reg.counter("frames", help="h")
    assert reg.counter("frames") is c
    assert isinstance(c, Counter)
    c.inc()
    c.inc(4)
    g = reg.gauge("smem")
    g.set_max(10)
    g.set_max(3)
    assert isinstance(g, Gauge) and g.value == 10
    reg.histogram("lat").observe(0.01)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("frames")
    assert "frames" in reg and "nope" not in reg
    snap = reg.snapshot()
    assert snap["frames"] == 5 and snap["smem"] == 10
    assert snap["lat"]["count"] == 1


def _fill(reg):
    reg.counter("eng_frames", help="frames served").inc(3)
    reg.gauge("eng_smem").set(1024)
    h = reg.histogram("eng_lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)


def test_prometheus_text_exposition():
    reg = MetricsRegistry()
    _fill(reg)
    text = reg.to_prometheus_text()
    assert "# HELP eng_frames frames served" in text
    assert "# TYPE eng_frames counter" in text
    assert "eng_frames 3" in text
    assert "# TYPE eng_smem gauge" in text
    assert 'eng_lat_bucket{le="0.1"} 1' in text      # cumulative counts
    assert 'eng_lat_bucket{le="1"} 2' in text
    assert 'eng_lat_bucket{le="+Inf"} 3' in text
    assert "eng_lat_count 3" in text
    # the reference renders the same registry operations identically
    jreg = jax_metrics.MetricsRegistry()
    _fill(jreg)
    assert text == jreg.to_prometheus_text()
    assert reg.snapshot() == jreg.snapshot()


def test_engine_metrics_reconciliation():
    m = EngineMetrics(prefix="t")
    m.frames_submitted += 5
    m.observe_batch("unsharp-m", n_frames=3, slots=4, execute_s=0.01,
                    smem_bytes=100, rows_per_step=4)
    m.frames_rejected += 2
    assert m.in_flight == 2           # submitted == completed + in_flight
    snap = m.snapshot()
    assert snap["frames_submitted"] == 5
    assert snap["frames_completed"] == 3
    assert snap["frames_in_flight"] == 2
    assert snap["frames_rejected"] == 2   # outside the identity
    assert snap["smem_high_water_bytes"] == 100
    # the set-backed rows_per_step view stays sorted and deduplicated
    m.observe_batch("unsharp-m", 1, 4, 0.01, 100, rows_per_step=1)
    m.observe_batch("unsharp-m", 1, 4, 0.01, 100, rows_per_step=4)
    assert m.snapshot()["rows_per_step_seen"] == [1, 4]
    assert isinstance(m.rows_per_step_seen, set)
    # counters live in the registry under the prefix
    assert m.registry.snapshot()["t_frames_submitted"] == 5


def test_shared_registry_telemetry_plane():
    """One registry across engine metrics + cache = one scrape."""
    reg = MetricsRegistry()
    eng_m = EngineMetrics(registry=reg, prefix="frame_engine")
    cache = PlanCache(registry=reg, device="cpu")
    eng_m.frames_submitted += 1
    cache.stats.plan_misses += 1
    snap = reg.snapshot()
    assert snap["frame_engine_frames_submitted"] == 1
    assert snap["plan_cache_plan_misses"] == 1
    text = reg.to_prometheus_text()
    assert "frame_engine_frames_submitted 1" in text
    assert "plan_cache_plan_misses 1" in text


def test_plan_cache_snapshot_merges_everything():
    cache = PlanCache(device="cpu")
    cache.plan_for("unsharp-m", 32)
    snap = cache.snapshot()
    for key in ("plan_hits", "plan_misses", "plans_resident",
                "execs_resident", "tunings_resident", "max_plans",
                "max_execs", "smem_bytes"):
        assert key in snap, key
    assert snap["plan_misses"] == 1 and snap["plans_resident"] == 1
    cache.plan_for("unsharp-m", 32)
    assert cache.snapshot()["plan_hits"] == 1


# ----------------------------------------------------- engine integration
def _frame_req(rid, name="unsharp-m", shape=(24, 32)):
    return FrameRequest(rid=rid, pipeline=name,
                        frames={"in": RNG.rand(*shape).astype(np.float32)})


def test_frame_engine_emits_spans(global_trace):
    eng = FrameEngine(max_batch=2, max_pending=8, device="cpu")
    done = eng.run([_frame_req(i) for i in range(3)])
    assert len(done) == 3
    names = {e.name for e in trace.events()}
    # all four instrumented layers show up from one cold engine drain
    assert {"engine.step", "engine.assemble", "engine.execute",
            "executor.call", "cache.plan", "cache.exec",
            "compile.pipeline", "ilp.build_problem",
            "ilp.solve"} <= names
    steps = [e for e in trace.events() if e.name == "engine.step"]
    assert steps and all(e.attrs["engine"] == "frame" for e in steps)
    assert all(e.attrs["pipeline"] == "unsharp-m" for e in steps)
    assert all(e.attrs["queue_wait_s"] >= 0 for e in steps)
    assert all("execute_s" in e.attrs for e in steps)
    # nesting: execute is a child of step, executor.call a child of execute
    execs = [e for e in trace.events() if e.name == "engine.execute"]
    assert all(e.parent == "engine.step" and e.depth == 1 for e in execs)
    calls = [e for e in trace.events() if e.name == "executor.call"]
    assert all(e.parent == "engine.execute" for e in calls)
    # engine snapshot merges metrics + cache views
    snap = eng.snapshot()
    assert snap["frames_completed"] == 3
    assert snap["cache"]["plans_resident"] >= 1
    # and the whole run exports as a valid Perfetto trace
    data = export.to_chrome_trace(trace.events())
    assert export.validate_trace(data) == []


def test_video_engine_emits_spans(global_trace):
    eng = VideoEngine(chunk=2, device="cpu")
    sid = eng.open_stream("tmotion-t", 24, 32)
    fed, outs = 0, []
    while fed < 6 or eng.pending:
        while fed < 6 and eng.submit(
                VideoFrame(sid, {"in": RNG.rand(24, 32).astype(np.float32)})):
            fed += 1
        outs.extend(eng.step())
    assert len(outs) == 6
    names = {e.name for e in trace.events()}
    assert {"engine.step", "engine.execute", "executor.call",
            "cache.plan", "compile.pipeline"} <= names
    steps = [e for e in trace.events() if e.name == "engine.step"]
    assert all(e.attrs["engine"] == "video" for e in steps)
    assert all(e.attrs["pipeline"] == "tmotion-t" for e in steps)
    eng.close_stream(sid)
    snap = eng.snapshot()
    assert snap["frames_completed"] == 6
    assert "cache" in snap and "pending" in snap


def test_engines_silent_when_tracing_disabled():
    assert not trace.enabled()
    trace.clear()
    eng = FrameEngine(max_batch=2, max_pending=8, device="cpu")
    assert len(eng.run([_frame_req(0)])) == 1
    assert trace.events() == []       # zero spans recorded


# ------------------------------------------------------ stress: histograms
def test_histogram_exact_under_concurrent_writers():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s", buckets=(0.01, 0.1, 1.0))
    per_thread, n_threads = 2000, 8
    rng = np.random.default_rng(0)
    values = rng.random((n_threads, per_thread)) * 2.0

    _hammer(n_threads,
            lambda k: [h.observe(float(v)) for v in values[k]])

    assert h.count == n_threads * per_thread       # no lost increment
    assert sum(h.counts) == h.count                # no torn bucket triple
    assert h.total == pytest.approx(float(values.sum()), rel=1e-9)
    assert h.min == pytest.approx(float(values.min()))
    assert h.max == pytest.approx(float(values.max()))
    snap = h.snapshot()
    assert snap["count"] == h.count
    assert snap["min"] <= snap["p50"] <= snap["p95"] <= snap["p99"] \
        <= snap["max"]


def test_prometheus_scrape_consistent_while_writers_run():
    """Mid-storm scrapes still satisfy the exposition invariants:
    cumulative buckets monotone and the +Inf bucket equal to _count."""
    reg = MetricsRegistry()
    h = reg.histogram("busy_s", buckets=(0.25, 0.5, 0.75))
    c = reg.counter("hits")
    stop = threading.Event()

    def writer(k):
        rng = np.random.default_rng(k)
        while not stop.is_set():
            h.observe(float(rng.random()))
            c.inc()

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(50):
            text = reg.to_prometheus_text()
            cum = [int(m) for m in
                   re.findall(r'busy_s_bucket{le="[^+]*?"} (\d+)', text)]
            inf = int(re.search(r'busy_s_bucket{le="\+Inf"} (\d+)',
                                text).group(1))
            count = int(re.search(r"busy_s_count (\d+)", text).group(1))
            assert cum == sorted(cum)              # cumulative, monotone
            assert cum[-1] <= inf == count         # books close mid-scrape
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    final = reg.to_prometheus_text()
    assert int(re.search(r"busy_s_count (\d+)", final).group(1)) == h.count
    assert int(re.search(r"^hits (\d+)", final, re.M).group(1)) == c.value


def test_counter_increments_exact_across_threads():
    reg = MetricsRegistry()
    c = reg.counter("n")
    _hammer(8, lambda k: [c.inc() for _ in range(5000)])
    assert c.value == 40000


# ------------------------------------------------------ stress: event ring
def test_event_ring_overflow_counts_drops():
    tr = Tracer(enabled=True, capacity=16)
    for i in range(100):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 16                  # ring stayed bounded
    assert tr.dropped == 84                        # every loss accounted
    assert [e.name for e in tr.events()] == [f"s{i}" for i in range(84, 100)]
    tr.clear()
    assert tr.dropped == 0 and len(tr) == 0


def test_event_ring_overflow_under_concurrent_spans():
    tr = Tracer(enabled=True, capacity=32)
    per_thread, n_threads = 500, 6

    def spam(k):
        for _ in range(per_thread):
            with tr.span(f"t{k}"):
                pass

    _hammer(n_threads, spam)
    total = n_threads * per_thread
    assert len(tr.events()) == 32
    assert tr.dropped == total - 32                # retained + dropped = all


# --------------------------------------------------- stress: reconciliation
def _control_plane_books(m):
    m.frames_offered += 10
    m.frames_submitted += 7                        # 3 rejected at the door
    m.frames_rejected += 3
    m.observe_batch("p", 3, 4, 0.01, 0)            # 3 completed
    m.frames_shed += 1
    m.frames_cancelled += 1
    m.frames_failed += 1


def test_reconciliation_balances_with_control_plane_counters():
    m = EngineMetrics(prefix="t")
    _control_plane_books(m)
    rec = m.reconcile()
    assert rec["in_flight"] == 1                   # 7 - 3 - 1 - 1 - 1
    assert rec["accounted"] == 10 and rec["balanced"]
    # the reference keeps the same books on the same counts
    jm = JaxEngineMetrics(prefix="t")
    _control_plane_books(jm)
    assert rec == jm.reconcile()
    # a vanished frame — offered but never admitted, rejected, or
    # otherwise dispositioned — breaks the identity loudly
    m.frames_offered += 1
    assert not m.reconcile()["balanced"]


def test_retry_and_deadline_observations_feed_histograms():
    m = EngineMetrics(prefix="t")
    for d in (0.001, 0.002, 0.004):
        m.observe_retry(d)
    m.observe_deadline_miss(0.5)
    m.observe_deadline_miss(-0.1)                  # clamped at zero
    assert m.executor_retries == 3
    assert m.deadline_missed == 2
    snap = m.snapshot()
    assert snap["retry_backoff"]["count"] == 3
    assert snap["retry_backoff"]["max"] == pytest.approx(0.004)
    assert snap["deadline_miss"]["count"] == 2
    assert snap["deadline_miss"]["min"] == 0.0
    # and they ride the shared registry like every other counter
    assert m.registry.snapshot()["t_executor_retries"] == 3


def test_concurrent_engine_counter_attributes_do_not_lose_updates():
    """The engines mutate counters via `metrics.x += 1` property sugar;
    that read-modify-write is NOT atomic across threads — but inc() is.
    This pins the contract: cross-thread writers must use inc()."""
    m = EngineMetrics(prefix="t")
    _hammer(4, lambda k: [m._c["frames_completed"].inc()
                          for _ in range(2500)])
    assert m.frames_completed == 10000
