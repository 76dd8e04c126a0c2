"""Port fault injection: the chaos harness, then miniature soaks.

The contracts of tests/test_chaos.py, held by
``repro_torch.resilience.chaos`` and the port's engines at
``device="cpu"``, plus the same seeds through both packages' monkeys
(identical rolls and corruptions), the executor proxy over the port's
executors, and a video soak with the telemetry plane running. Completed
outputs are held against the JAX package's pure-jnp oracles within
8 ULP at the array's scale, as tests/test_chaos.py holds its own.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core.algorithms import \
    execute_reference_video as jax_execute_reference_video
from repro.kernels import ref as jax_ref
from repro.resilience import chaos as jax_chaos
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
from repro_torch.obs import trace
from repro_torch.obs.export import to_chrome_trace, validate_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.telemetry import TelemetryCollector, default_slo_rules
from repro_torch.resilience import (CancelledFrame, RejectedFrame,
                                    ResilienceConfig, RetryPolicy,
                                    screen_frames)
from repro_torch.resilience.chaos import (FAULT_KINDS, ChaosExecutor,
                                          ChaosMonkey, InjectedFault,
                                          install_chaos)
from repro_torch.video import CompletedVideoFrame, VideoEngine, VideoFrame

RNG = np.random.RandomState(21)


def _frame(shape=(16, 24)):
    return RNG.rand(*shape).astype(np.float32)


def assert_within_ulp(got, exp, ulp=8):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    tol = ulp * np.spacing(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def test_monkey_rejects_unknown_fault_kinds():
    with pytest.raises(ValueError, match="unknown fault kinds"):
        ChaosMonkey(seed=0, meteor_strike=1.0)
    m = ChaosMonkey(seed=0)
    assert set(m.rates) == set(FAULT_KINDS)
    assert all(v == 0.0 for v in m.rates.values())
    assert FAULT_KINDS == jax_chaos.FAULT_KINDS


def test_monkey_is_deterministic_per_seed():
    def drive(seed, cls=ChaosMonkey):
        m = cls(seed=seed, compile=0.3, executor=0.2, nan_frame=0.1)
        hits = [m.roll(k) for _ in range(200)
                for k in ("compile", "executor", "nan_frame")]
        return hits, dict(m.injected)

    h1, c1 = drive(5)
    h2, c2 = drive(5)
    h3, _ = drive(6)
    assert h1 == h2 and c1 == c2
    assert h1 != h3
    assert sum(c1.values()) == sum(h1)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_monkey_rolls_match_the_reference(seed):
    rates = dict(compile=0.25, executor=0.1, nan_frame=0.1,
                 shape_frame=0.05, dtype_frame=0.05, evict_storm=0.05,
                 churn=0.02)
    mj = jax_chaos.ChaosMonkey(seed=seed, **rates)
    mp = ChaosMonkey(seed=seed, **rates)
    kinds = list(FAULT_KINDS) * 100
    assert [mj.roll(k) for k in kinds] == [mp.roll(k) for k in kinds]
    assert mj.injected == mp.injected


def test_corrupt_produces_screenable_defects():
    m = ChaosMonkey(seed=3, nan_frame=1.0)
    clean = {"in": _frame()}
    bad, kind = m.corrupt(clean)
    assert kind == "nan_frame"
    assert screen_frames(bad, {"in"})[0] == "nonfinite"
    assert np.isfinite(clean["in"]).all()

    m = ChaosMonkey(seed=3, shape_frame=1.0)
    bad, kind = m.corrupt(clean)
    assert kind == "shape_frame"
    assert screen_frames(bad, {"in"})[0] == "bad_shape"

    m = ChaosMonkey(seed=3, dtype_frame=1.0)
    bad, kind = m.corrupt(clean)
    assert kind == "dtype_frame"
    assert screen_frames(bad, {"in"})[0] == "bad_dtype"

    m = ChaosMonkey(seed=3, nan_frame=1.0, shape_frame=1.0,
                    dtype_frame=1.0)
    bad, kind = m.corrupt(clean)
    assert kind == "nan_frame"
    assert m.injected["shape_frame"] == 0
    assert m.injected["dtype_frame"] == 0

    m = ChaosMonkey(seed=3)
    same, kind = m.corrupt(clean)
    assert kind is None
    np.testing.assert_array_equal(same["in"], clean["in"])


def test_chaos_executor_is_a_transparent_proxy():
    cache = PlanCache(device="cpu")
    real = cache.executor_for("unsharp-m", 16, 24, batch=2)
    quiet = ChaosExecutor(real, ChaosMonkey(seed=0))
    for attr in ("smem_bytes", "dag", "plan", "batch", "device",
                 "rows_per_step", "prefetch_depth", "program"):
        assert getattr(quiet, attr) is getattr(real, attr), attr
    x = {"in": np.stack([_frame(), _frame()])}
    assert torch.equal(quiet(x), real(x))
    loud = ChaosExecutor(real, ChaosMonkey(seed=0, executor=1.0))
    with pytest.raises(InjectedFault, match="executor"):
        loud(x)


def test_chaos_video_executor_forwards_stream_attributes():
    cache = PlanCache(device="cpu")
    real = cache.video_executor_for("tmotion-t", 8, 8, chunk=2)
    proxy = ChaosExecutor(real, ChaosMonkey(seed=0))
    for attr in ("smem_bytes", "dag", "plan", "chunk", "device",
                 "frame_state_bytes", "depths", "warmup_frames"):
        assert getattr(proxy, attr) == getattr(real, attr), attr
    state = proxy.init_state()
    vid = {"in": np.stack([_frame((8, 8)), _frame((8, 8))])}
    out, new = proxy(vid, state)
    want, want_new = real(vid, state)
    assert torch.equal(out, want)
    assert all(torch.equal(new[p], want_new[p]) for p in want_new)


def test_cache_wraps_every_executor_handed_out():
    cache = PlanCache(device="cpu")
    install_chaos(cache, ChaosMonkey(seed=0))
    miss = cache.executor_for("unsharp-m", 8, 8, batch=1)
    hit = cache.executor_for("unsharp-m", 8, 8, batch=1)
    vid = cache.video_executor_for("tmotion-t", 8, 8)
    assert all(isinstance(e, ChaosExecutor) for e in (miss, hit, vid))
    assert miss._ex is hit._ex                   # one cached object
    assert cache.stats.exec_hits == 1 and cache.stats.exec_misses == 2


def test_compile_hook_fires_inside_cache_retry_boundary():
    monkey = ChaosMonkey(seed=0, compile=1.0)
    cache = PlanCache(device="cpu",
                      retry=RetryPolicy(max_attempts=3, base_delay_s=1e-4,
                                        seed=0))
    install_chaos(cache, monkey)
    with pytest.raises(InjectedFault):
        cache.executor_for("unsharp-m", 8, 8, batch=1)
    assert monkey.injected["compile"] == 3
    assert cache.stats.compile_retries == 2


def test_compile_hook_labels_name_the_compile():
    labels = []
    cache = PlanCache(device="cpu")
    cache.compile_hook = labels.append
    cache.executor_for("unsharp-m", 8, 16, batch=1)
    cache.video_executor_for("tmotion-t", 8, 16)
    cache.executor_for("unsharp-m", 8, 16, batch=1, rows_per_step=2)
    assert labels == ["plan:unsharp-m:16", "exec:unsharp-m:8x16",
                      "plan:tmotion-t:16", "video_exec:tmotion-t:8x16",
                      "exec:unsharp-m:8x16"]   # derived plan: no compile


def test_evict_storm_forces_recompiles():
    cache = PlanCache(device="cpu")
    cache.executor_for("unsharp-m", 8, 8, batch=1)
    monkey = ChaosMonkey(seed=0, evict_storm=1.0)
    assert monkey.maybe_storm(cache) >= 1
    assert monkey.injected["evict_storm"] == 1
    assert ChaosMonkey(seed=0).maybe_storm(cache) == 0
    cache.executor_for("unsharp-m", 8, 8, batch=1)
    assert cache.stats.exec_misses == 2


def test_mini_soak_books_balance_and_outputs_verify():
    """A 60-frame seeded storm through the resilient FrameEngine: every
    offered frame accounted, every completed output matching the oracle,
    no exception escaping."""
    monkey = ChaosMonkey(seed=11, compile=0.25, executor=0.1,
                         nan_frame=0.1, shape_frame=0.05,
                         dtype_frame=0.05, evict_storm=0.05)
    eng = FrameEngine(
        device="cpu", max_batch=2, max_pending=8,
        resilience=ResilienceConfig(
            retry=RetryPolicy(max_attempts=2, base_delay_s=1e-4, seed=11),
            breaker_failures=2, breaker_reset_s=0.05))
    install_chaos(eng.cache, monkey)
    dag = jax_algorithms.ALGORITHMS["unsharp-m"]()

    offered, outcomes, sent = 0, [], {}
    for rid in range(60):
        frames, _ = monkey.corrupt({"in": _frame()})
        monkey.maybe_storm(eng.cache)
        r = eng.submit(FrameRequest(rid=rid, pipeline="unsharp-m",
                                    frames=frames))
        offered += 1
        if isinstance(r, RejectedFrame):
            outcomes.append(r)
        else:
            assert r is True
            sent[rid] = frames
        if rid % 3 == 2:
            outcomes += eng.step()
    while eng.pending:
        outcomes += eng.step()
    outcomes += eng.step()

    rec = eng.metrics.reconcile()
    assert rec["offered"] == offered
    assert rec["balanced"] and rec["in_flight"] == 0
    assert len(outcomes) == offered
    assert sorted(o.rid for o in outcomes) == list(range(60))
    completed = [o for o in outcomes if hasattr(o, "output")]
    assert completed
    for c in completed:
        want = np.asarray(jax_ref.stencil_pipeline_ref(dag, sent[c.rid]))
        assert_within_ulp(c.output, want)
    assert sum(monkey.injected.values()) > 0


def test_video_mini_soak_with_telemetry_and_churn():
    """A seeded storm through the resilient VideoEngine — every fault
    kind, stream churn included — with the telemetry plane sampling a
    shared registry: the books balance with one outcome per offered
    frame, every completed frame matches the oracle over the effective
    stream it belongs to, and the exported trace validates."""
    monkey = ChaosMonkey(seed=4, compile=0.2, executor=0.1,
                         nan_frame=0.08, shape_frame=0.04,
                         dtype_frame=0.04, evict_storm=0.05, churn=0.05)
    reg = MetricsRegistry()
    eng = VideoEngine(
        device="cpu", chunk=2, max_pending=6, registry=reg,
        resilience=ResilienceConfig(
            retry=RetryPolicy(max_attempts=2, base_delay_s=1e-4, seed=4),
            breaker_failures=2, breaker_reset_s=0.02))
    install_chaos(eng.cache, monkey)
    col = TelemetryCollector(reg, rules=default_slo_rules("video_engine"))
    trace.enable()
    trace.clear()
    try:
        sids = [eng.open_stream(n, 8, 8) for n in ("tmotion-t",
                                                  "tunsharp-t")]
        fed = {sid: [] for sid in sids}       # served-eligible frames
        offered, outcomes = 0, []
        for rid in range(80):
            sid = sids[rid % 2]
            if monkey.roll("churn"):
                outcomes += eng.close_stream(sid, cancel=True)
                name = "tmotion-t" if rid % 2 == 0 else "tunsharp-t"
                sid = sids[rid % 2] = eng.open_stream(name, 8, 8)
                fed[sid] = []
            frames, _ = monkey.corrupt({"in": _frame((8, 8))})
            monkey.maybe_storm(eng.cache)
            r = eng.submit(VideoFrame(sid, frames, rid=rid))
            offered += 1
            if isinstance(r, RejectedFrame):
                outcomes.append(r)
            else:
                fed[sid].append((rid, frames["in"]))
            if rid % 3 == 2:
                outcomes += eng.step()
                col.sample_once(now=float(rid))
        while eng.pending:
            outcomes += eng.step()
        outcomes += eng.step()
        col.sample_once(now=100.0)
        events = trace.events()
    finally:
        trace.disable()
        trace.clear()
    rec = eng.metrics.reconcile()
    assert rec["balanced"] and rec["offered"] == offered
    assert rec["in_flight"] == 0
    assert len(outcomes) == offered
    assert sorted(o.rid for o in outcomes) == list(range(80))
    assert any(isinstance(o, CancelledFrame) for o in outcomes)
    served = {o.rid: o for o in outcomes
              if isinstance(o, CompletedVideoFrame)}
    assert served
    # oracle over each stream's effective frames (the ones it served)
    for sid, frames in fed.items():
        eff = [(rid, f) for rid, f in frames if rid in served]
        if not eff:
            continue
        dag = jax_algorithms.VIDEO_ALGORITHMS[
            served[eff[0][0]].pipeline]()
        want = np.asarray(jax_execute_reference_video(
            dag, {"in": np.stack([f for _, f in eff])}))
        got = torch.stack([served[rid].output for rid, _ in eff])
        assert_within_ulp(got, want)
    for kind in FAULT_KINDS:
        assert monkey.injected[kind] > 0, kind
    snap = col.snapshot()
    assert snap["samples_taken"] > 0
    assert "video_engine_frames_offered" in snap["series"]
    assert validate_trace(to_chrome_trace(events)) == []
    names = {e.name for e in events}
    assert {"resilience.reject", "engine.step"} <= names
