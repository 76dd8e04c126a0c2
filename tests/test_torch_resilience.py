"""Port serving control plane: admission, deadlines, policies, outcomes.

The contracts of tests/test_resilience.py, held by
``repro_torch.resilience`` and the port's engines at ``device="cpu"``
(the kernel's plain version), then the jax-free units of both packages
driven with the same seeded inputs and required to decide identically.

Engine outputs are held against the JAX package's pure-jnp oracles
(``repro.kernels.ref.stencil_pipeline_ref``,
``repro.core.algorithms.execute_reference_video``): bitwise first, else
<= 32 ULP at the array's scale (tests/test_video.py), for XLA's
multiply-add contraction. Outputs of the port's own paths (strict
engine, compiled rung, reference rung) are compared bit for bit.
"""
import dataclasses
import random
import threading

import numpy as np
import pytest
import torch

from repro import resilience as jax_res
from repro.core import algorithms as jax_algorithms
from repro.core import dsl as jax_dsl
from repro.core.algorithms import \
    execute_reference_video as jax_execute_reference_video
from repro.kernels import ref as jax_ref
from repro.resilience import chaos as jax_chaos
from repro_torch import resilience as port_res
from repro_torch.core import algorithms as port_algorithms
from repro_torch.core import dsl as port_dsl
from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.resilience import (AdmissionController, AttemptTimeout,
                                    CancelledFrame, CircuitBreaker,
                                    FailedFrame, FallbackLadder,
                                    LadderExhausted, Priority, RejectedFrame,
                                    ResilienceConfig, RetryPolicy, ShedFrame,
                                    TokenBucket, pick_shed_victim,
                                    screen_frames, split_expired)
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos
from repro_torch.video import CompletedVideoFrame, VideoEngine, VideoFrame

RNG = np.random.RandomState(7)


def _frame(shape=(16, 24)):
    return RNG.rand(*shape).astype(np.float32)


def _req(rid, name="unsharp-m", shape=(16, 24), **kw):
    return FrameRequest(rid=rid, pipeline=name,
                        frames={"in": _frame(shape)}, **kw)


def _cfg(**kw):
    kw.setdefault("retry",
                  RetryPolicy(max_attempts=2, base_delay_s=1e-4, seed=0))
    return ResilienceConfig(**kw)


def _fe(**kw):
    return FrameEngine(device="cpu", **kw)


def _ve(**kw):
    return VideoEngine(device="cpu", **kw)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def assert_ulp_equal(got, exp, ulp=32):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = ulp * np.spacing(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def frame_oracle(name, frames):
    dag = jax_algorithms.ALGORITHMS[name]()
    return np.asarray(jax_ref.stencil_pipeline_ref(dag, frames))


def video_oracle(dag, vid):
    jdag = jax_algorithms.VIDEO_ALGORITHMS.get(dag.name)
    jdag = jdag() if jdag is not None else _tinternal(jax_dsl,
                                                      jax_algorithms)
    return np.asarray(jax_execute_reference_video(jdag, {"in": vid}))


def _tinternal(dsl, alg):
    """A temporal tap on a computed stage (an internal temporal
    producer): its frames come back as state, not from the inputs."""
    p = dsl.Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], alg.conv_fn(alg.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], alg.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


def _port_tinternal():
    return _tinternal(port_dsl, port_algorithms)


# -------------------------------------------------------------- screening
def test_screen_frames_catalogue_of_defects():
    clean = {"in": _frame()}
    assert screen_frames(clean, {"in"}) is None
    assert screen_frames({}, {"in"})[0] == "missing_inputs"
    assert screen_frames({"in": _frame().astype(np.complex64)},
                         {"in"})[0] == "bad_dtype"
    assert screen_frames({"in": _frame().ravel()}, {"in"})[0] == "bad_shape"
    bad = _frame()
    bad[3, 4] = np.nan
    assert screen_frames({"in": bad}, {"in"})[0] == "nonfinite"
    bad = _frame()
    bad[0, 0] = np.inf
    assert screen_frames({"in": bad}, {"in"})[0] == "nonfinite"
    assert screen_frames({"a": _frame((8, 8)), "b": _frame((4, 4))},
                         {"a", "b"})[0] == "bad_shape"
    assert screen_frames(clean, {"in"}, expect_shape=(8, 8))[0] \
        == "bad_shape"
    assert screen_frames(clean, {"in"}, expect_shape=(16, 24)) is None
    assert screen_frames({"in": np.zeros((4, 4), np.int32)}, {"in"}) is None


def test_token_bucket_burst_then_refill():
    clk = FakeClock()
    b = TokenBucket(rate=10.0, burst=3.0, clock=clk)
    assert [b.try_take() for _ in range(4)] == [True, True, True, False]
    clk.t += 0.1
    assert b.try_take()
    assert not b.try_take()
    clk.t += 10.0
    assert b.tokens == pytest.approx(3.0)
    with pytest.raises(ValueError, match="rate/burst"):
        TokenBucket(rate=0.0, burst=1.0)


def test_admission_controller_per_key_isolation():
    clk = FakeClock()
    ac = AdmissionController(rate=1.0, burst=1.0, clock=clk)
    assert ac.allow("a") and not ac.allow("a")
    assert ac.allow("b")
    ac.forget("a")
    assert ac.allow("a")
    unlimited = AdmissionController(rate=None)
    assert all(unlimited.allow("x") for _ in range(100))
    assert len(unlimited) == 0


# ---------------------------------------------------------------- shedding
def test_pick_shed_victim_priority_then_deadline():
    items = [("lo", Priority.LOW, None, 1.0),
             ("hi", Priority.HIGH, None, 2.0)]

    def pick(new_priority, now=10.0, its=items):
        return pick_shed_victim(its, int(new_priority), now,
                                priority_of=lambda it: int(it[1]),
                                deadline_of=lambda it: it[2],
                                age_of=lambda it: it[3])

    assert pick(Priority.NORMAL)[0] == "lo"
    assert pick(Priority.LOW) is None
    expired = [("late", Priority.NORMAL, 5.0, 1.0),
               ("ok", Priority.NORMAL, 50.0, 2.0)]
    assert pick(Priority.LOW, its=expired)[0] == "late"
    assert pick_shed_victim([], 0, 0.0, priority_of=int,
                            deadline_of=lambda _: None,
                            age_of=float) is None


def test_split_expired():
    items = [("a", 5.0), ("b", None), ("c", 20.0)]
    live, expired = split_expired(items, now=10.0,
                                  deadline_of=lambda it: it[1])
    assert [x[0] for x in live] == ["b", "c"]
    assert [x[0] for x in expired] == ["a"]


# ---------------------------------------------------------------- policies
def test_retry_policy_recovers_and_exhausts():
    calls, retried = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    p = RetryPolicy(max_attempts=3, base_delay_s=0.001, seed=1)
    out = p.call(flaky, sleep=lambda _: None,
                 on_retry=lambda a, d, e: retried.append((a, d)))
    assert out == "ok" and len(calls) == 3 and len(retried) == 2
    assert all(d > 0 for _, d in retried)

    def always():
        raise ValueError("permanent")

    with pytest.raises(ValueError, match="permanent"):
        p.call(always, sleep=lambda _: None)


def test_retry_backoff_is_seeded_and_bounded():
    kw = dict(max_attempts=5, base_delay_s=0.01, max_delay_s=0.02,
              multiplier=2.0, jitter=0.5, seed=42)
    a, b = RetryPolicy(**kw), RetryPolicy(**kw)
    da = [a.backoff_s(k) for k in range(1, 5)]
    assert da == [b.backoff_s(k) for k in range(1, 5)]
    assert all(0.005 <= d <= 0.03 for d in da)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=2.0)


def test_retry_attempt_timeout_regains_control():
    wedged = threading.Event()
    p = RetryPolicy(max_attempts=1, timeout_s=0.05)
    with pytest.raises(AttemptTimeout):
        p.call(lambda: wedged.wait(5.0))
    wedged.set()


def test_timed_out_attempt_result_is_discarded():
    """An abandoned attempt runs on to its end, but the ladder returns
    the next rung's result, and the late one never reaches the caller."""
    release, finished = threading.Event(), threading.Event()
    late = torch.zeros(4)

    def wedged():
        release.wait(5.0)
        late.fill_(7.0)            # writes only its own tensor
        finished.set()
        return late

    lad = FallbackLadder(retry=RetryPolicy(max_attempts=1, timeout_s=0.05),
                         sleep=lambda _: None)
    out, rung = lad.run("p", [("default", wedged),
                              ("reference", lambda: torch.ones(4))])
    assert rung == "reference"
    release.set()
    assert finished.wait(5.0)
    assert torch.equal(out, torch.ones(4)) and out is not late


def test_circuit_breaker_lifecycle():
    clk = FakeClock()
    br = CircuitBreaker(failure_threshold=2, reset_after_s=1.0, clock=clk)
    assert br.allow()
    br.record_failure()
    assert br.state == br.CLOSED and br.allow()
    br.record_failure()
    assert br.state == br.OPEN and br.trips == 1
    assert not br.allow()
    clk.t += 1.0
    assert br.allow() and br.state == br.HALF_OPEN
    assert not br.allow()
    br.record_failure()
    assert br.state == br.OPEN and br.trips == 2
    clk.t += 1.0
    assert br.allow()
    br.record_success()
    assert br.state == br.CLOSED and br.failures == 0
    assert br.allow()


def test_fallback_ladder_descends_and_reports():
    clk = FakeClock()
    fell = []
    lad = FallbackLadder(retry=RetryPolicy(max_attempts=1),
                         failure_threshold=1, reset_after_s=10.0,
                         clock=clk, sleep=lambda _: None,
                         on_fallback=lambda k, r, e: fell.append(r))

    def boom():
        raise RuntimeError("tuned broken")

    out, rung = lad.run("p", [("tuned", boom), ("default", lambda: 42)])
    assert (out, rung) == (42, "default") and fell == ["tuned"]
    out, rung = lad.run("p", [("tuned", boom), ("default", lambda: 7)])
    assert rung == "default"
    with pytest.raises(LadderExhausted) as ei:
        lad.run("q", [("default", boom)])
    assert ei.value.key == "q"
    assert [r for r, _ in ei.value.errors] == ["default"]
    assert lad.breaker("p", "default").state == CircuitBreaker.CLOSED


# ------------------------------------------- the port against the package
def test_config_and_exports_match_the_reference():
    ref_fields = {f.name: f for f in dataclasses.fields(
        jax_res.ResilienceConfig)}
    port_fields = {f.name: f for f in dataclasses.fields(ResilienceConfig)}
    assert list(port_fields) == list(ref_fields)
    a, b = jax_res.ResilienceConfig(), ResilienceConfig()
    for name in ref_fields:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "retry":
            va, vb = ({k: getattr(v, k) for k in ("max_attempts",
                       "base_delay_s", "max_delay_s", "multiplier",
                       "jitter", "timeout_s", "seed")} for v in (va, vb))
        assert va == vb, name
    assert sorted(port_res.__all__) == sorted(jax_res.__all__)


def test_admission_decisions_match_the_reference():
    rng = random.Random(3)
    steps = [(rng.random() * 0.1, rng.choice("abc")) for _ in range(300)]
    verdicts = []
    for mod in (jax_res, port_res):
        clk = FakeClock()
        ac = mod.AdmissionController(rate=4.0, burst=2.0, clock=clk)
        bucket = mod.TokenBucket(rate=2.0, burst=2.0, clock=clk)
        out = []
        for i, (dt, key) in enumerate(steps):
            clk.t += dt
            if i % 50 == 49:
                ac.forget(key)
            out.append((ac.allow(key), bucket.try_take(0.5),
                        round(bucket.tokens, 12)))
        verdicts.append(out)
    assert verdicts[0] == verdicts[1]
    assert 0 < sum(v[0] for v in verdicts[0]) < len(steps)


@pytest.mark.parametrize("seed", [0, 11])
def test_backoff_sequences_match_the_reference(seed):
    kw = dict(max_attempts=6, base_delay_s=0.003, max_delay_s=0.05,
              multiplier=3.0, jitter=0.7, seed=seed)
    a, b = jax_res.RetryPolicy(**kw), RetryPolicy(**kw)
    assert [a.backoff_s(k) for k in range(1, 40)] == \
        [b.backoff_s(k) for k in range(1, 40)]
    # the delays the policy sleeps before each retry, too
    slept = []
    for p in (jax_res.RetryPolicy(**kw), RetryPolicy(**kw)):
        s = []
        with pytest.raises(RuntimeError):
            p.call(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                   sleep=s.append)
        slept.append(s)
    assert slept[0] == slept[1] and len(slept[0]) == 5


def test_breaker_and_ladder_traces_match_the_reference():
    rng = random.Random(5)
    outcomes = [rng.random() < 0.4 for _ in range(200)]
    logs = []
    for mod in (jax_res, port_res):
        clk = FakeClock()
        lad = mod.FallbackLadder(retry=mod.RetryPolicy(max_attempts=2,
                                                       seed=4),
                                 failure_threshold=2, reset_after_s=0.5,
                                 clock=clk, sleep=lambda _: None)
        it = iter(outcomes)
        log = []

        def rung(name):
            def thunk():
                if next(it, False):
                    raise RuntimeError(name)
                return name
            return thunk
        for k in range(60):
            clk.t += 0.2
            try:
                log.append(lad.run(k % 2, [("tuned", rung("tuned")),
                                           ("default", rung("default"))])[1])
            except mod.LadderExhausted as e:
                log.append([str(r) for r, _ in e.errors])
            log.append(lad.breaker(k % 2, "tuned").state)
        logs.append(log)
    assert logs[0] == logs[1]


def test_shed_picks_match_the_reference():
    rng = random.Random(9)
    for _ in range(200):
        now = rng.uniform(0, 10)
        items = [(i, rng.randrange(3),
                  None if rng.random() < 0.3 else rng.uniform(0, 20),
                  rng.uniform(0, 10)) for i in range(rng.randrange(0, 8))]
        new_priority = rng.randrange(3)
        acc = dict(priority_of=lambda it: it[1],
                   deadline_of=lambda it: it[2], age_of=lambda it: it[3])
        assert pick_shed_victim(items, new_priority, now, **acc) == \
            jax_res.pick_shed_victim(items, new_priority, now, **acc)
        assert split_expired(items, now, lambda it: it[2]) == \
            jax_res.split_expired(items, now, lambda it: it[2])


def test_screen_verdicts_on_corrupted_frames_match_the_reference():
    rates = dict(nan_frame=0.3, shape_frame=0.2, dtype_frame=0.2)
    mj, mp = jax_chaos.ChaosMonkey(seed=2, **rates), \
        ChaosMonkey(seed=2, **rates)
    kinds = set()
    for i in range(120):
        frames = {"a": _frame((6, 9)), "b": _frame((6, 9))}
        bj, kj = mj.corrupt(frames)
        bp, kp = mp.corrupt(frames)
        assert kj == kp
        kinds.add(kp)
        for k in frames:
            np.testing.assert_array_equal(bj[k], bp[k])
        for expect in (None, (6, 9), (5, 9)):
            assert screen_frames(bp, {"a", "b"}, expect) == \
                jax_res.screen_frames(bj, {"a", "b"}, expect)
    assert kinds == {None, "nan_frame", "shape_frame", "dtype_frame"}
    assert mj.injected == mp.injected


# --------------------------------------------------- resilient FrameEngine
def test_resilient_submit_quarantines_instead_of_raising():
    eng = _fe(max_batch=2, max_pending=8, resilience=_cfg())
    bad = [
        FrameRequest(rid=0, pipeline="no-such", frames={"in": _frame()}),
        FrameRequest(rid=1, pipeline="tmotion-t", frames={"in": _frame()}),
        FrameRequest(rid=2, pipeline="unsharp-m", frames={}),
        FrameRequest(rid=3, pipeline="unsharp-m",
                     frames={"in": _frame().ravel()}),
    ]
    reasons = [eng.submit(r) for r in bad]
    assert all(isinstance(r, RejectedFrame) and not r for r in reasons)
    assert [r.reason for r in reasons] == [
        "unknown_pipeline", "temporal_pipeline", "missing_inputs",
        "bad_shape"]
    assert not any(r.retryable for r in reasons)
    nan = _frame()
    nan[1, 1] = np.nan
    rej = eng.submit(FrameRequest(rid=4, pipeline="unsharp-m",
                                  frames={"in": nan}))
    assert rej.reason == "nonfinite"
    assert eng.submit(_req(5)) is True
    out = eng.step()
    assert len(out) == 1 and out[0].rid == 5
    rec = eng.metrics.reconcile()
    assert rec["balanced"] and rec["offered"] == 6 and rec["rejected"] == 5


def test_resilient_rate_limit_is_retryable():
    eng = _fe(max_pending=64, resilience=_cfg(rate=1000.0, burst=2.0))
    verdicts = [eng.submit(_req(i)) for i in range(4)]
    assert verdicts[:2] == [True, True]
    rejected = [v for v in verdicts if isinstance(v, RejectedFrame)]
    assert rejected and all(v.reason == "rate_limited" and v.retryable
                            for v in rejected)


def test_overload_sheds_lowest_priority_first():
    eng = _fe(max_batch=2, max_pending=2, resilience=_cfg())
    assert eng.submit(_req(0, priority=Priority.LOW)) is True
    assert eng.submit(_req(1, priority=Priority.HIGH)) is True
    assert eng.submit(_req(2, priority=Priority.NORMAL)) is True
    outcomes = []
    while eng.pending or not outcomes:
        outcomes += eng.step()
    shed = [o for o in outcomes if isinstance(o, ShedFrame)]
    assert [s.rid for s in shed] == [0]
    assert shed[0].reason == "overload"
    assert {o.rid for o in outcomes if not isinstance(o, ShedFrame)} \
        == {1, 2}
    assert eng.metrics.reconcile()["balanced"]


def test_expired_deadlines_swept_before_execution():
    eng = _fe(resilience=_cfg())
    assert eng.submit(_req(0, deadline_s=-1.0)) is True
    assert eng.submit(_req(1)) is True
    outcomes = []
    while eng.pending or not outcomes:
        outcomes += eng.step()
    shed = [o for o in outcomes if isinstance(o, ShedFrame)]
    assert len(shed) == 1 and shed[0].rid == 0
    assert shed[0].reason == "deadline" and shed[0].overdue_s > 0
    assert {o.rid for o in outcomes} - {0} == {1}
    assert eng.metrics.frames_shed == 1


def test_deadline_missed_marks_late_completions():
    eng = _fe(resilience=_cfg(shed_expired=False))
    assert eng.submit(_req(0, deadline_s=-1.0)) is True
    assert eng.submit(_req(1, deadline_s=60.0)) is True
    done = {c.rid: c for c in eng.step()}
    assert done[0].deadline_missed and not done[1].deadline_missed
    assert eng.metrics.deadline_missed == 1


@pytest.mark.parametrize("tile_shape", [(128, 128), (8, 16)])
def test_fallback_ladder_serves_via_reference_when_compiles_fail(
        tile_shape):
    """Every compile fails: the reference rung serves, on the engine's
    device, the pixels the kernel's plain version gives (untiled and
    tiled), and the JAX oracle's."""
    eng = _fe(max_batch=2, tile_shape=tile_shape,
              resilience=_cfg(breaker_failures=1))
    monkey = ChaosMonkey(seed=0, compile=1.0)
    install_chaos(eng.cache, monkey)
    reqs = [_req(i) for i in range(2)]
    for r in reqs:
        assert eng.submit(r) is True
    outcomes = eng.step()
    assert len(outcomes) == 2
    strict = _fe(max_batch=2, tile_shape=tile_shape).run(
        [FrameRequest(rid=r.rid, pipeline=r.pipeline, frames=r.frames)
         for r in reqs])
    for r, c in zip(reqs, outcomes):
        assert c.rung == "reference" and c.output.device.type == "cpu"
        assert torch.equal(c.output, strict[r.rid])
        assert_ulp_equal(c.output, frame_oracle("unsharp-m", r.frames))
    assert eng.metrics.fallback_frames == 2
    assert eng.metrics.executor_retries >= 1
    assert eng.cache.stats.compile_retries >= 1
    assert eng.metrics.reconcile()["balanced"]


def test_executor_exception_becomes_failed_frames_strict_mode():
    eng = _fe(max_batch=2)
    monkey = ChaosMonkey(seed=0, executor=1.0)
    install_chaos(eng.cache, monkey)
    for i in range(2):
        assert eng.submit(_req(i))
    outcomes = eng.step()
    assert len(outcomes) == 2
    assert all(isinstance(o, FailedFrame) for o in outcomes)
    assert {o.rid for o in outcomes} == {0, 1}
    assert all("InjectedFault" in o.error for o in outcomes)
    assert eng.metrics.frames_failed == 2
    assert eng.pending == 0
    monkey.rates["executor"] = 0.0
    assert eng.submit(_req(9))
    ok = eng.step()
    assert len(ok) == 1 and ok[0].rid == 9
    assert eng.metrics.reconcile()["balanced"]


def test_strict_mode_still_raises_at_submit():
    eng = _fe()
    with pytest.raises(KeyError):
        eng.submit(FrameRequest(rid=0, pipeline="no-such",
                                frames={"in": _frame()}))
    nan = _frame()
    nan[0, 0] = np.nan            # strict mode screens shapes, not pixels
    assert eng.submit(FrameRequest(rid=1, pipeline="unsharp-m",
                                   frames={"in": nan})) is True


def test_run_returns_structured_outcomes_for_lost_rids():
    eng = _fe(resilience=_cfg())
    nan = _frame()
    nan[0, 0] = np.nan
    reqs = [_req(0),
            FrameRequest(rid=1, pipeline="unsharp-m", frames={"in": nan}),
            _req(2)]
    results = eng.run(reqs)
    assert set(results) == {0, 1, 2}
    assert isinstance(results[1], RejectedFrame)
    assert results[1].reason == "nonfinite"
    for rid in (0, 2):
        assert_ulp_equal(results[rid],
                         frame_oracle("unsharp-m", reqs[rid].frames))


@pytest.mark.parametrize("autotune,depth", [(False, 1), (False, 2),
                                            (True, 1)])
def test_fault_free_resilient_run_equals_strict_engine(autotune, depth):
    """No fault: every frame on the primary rung, no retry, and the
    pixels of the strict engine bit for bit."""
    reqs = [_req(i, name) for i, name in enumerate(
        ["unsharp-m", "canny-m", "unsharp-m", "harris-m", "canny-m"])]
    kw = dict(max_batch=2, prefetch_depth=depth, autotune=autotune)
    strict = _fe(**kw).run(reqs)
    eng = _fe(resilience=ResilienceConfig(), **kw)
    done = {}
    for r in reqs:
        assert eng.submit(FrameRequest(rid=r.rid, pipeline=r.pipeline,
                                       frames=r.frames)) is True
    while eng.pending:
        done.update({c.rid: c for c in eng.step()})
    primary = "tuned" if autotune else "default"
    assert {c.rung for c in done.values()} == {primary}
    assert eng.metrics.executor_retries == 0
    assert eng.metrics.fallback_frames == 0
    for r in reqs:
        assert torch.equal(done[r.rid].output, strict[r.rid])


def test_tuned_rung_falls_back_to_default():
    eng = _fe(max_batch=2, autotune=True,
              resilience=_cfg(breaker_failures=1))

    def broken(*a, **k):
        raise RuntimeError("tuned broken")
    eng.cache.tuning_for = broken
    req = _req(0)
    assert eng.submit(req) is True
    (c,) = eng.step()
    assert c.rung == "default" and eng.metrics.fallback_frames == 1
    assert_ulp_equal(c.output, frame_oracle("unsharp-m", req.frames))


def test_resilience_config_defaults_are_strictly_additive():
    cfg = ResilienceConfig()
    assert cfg.rate is None and cfg.default_deadline_s is None
    assert cfg.shed_on_overload and cfg.shed_expired
    assert cfg.reference_fallback
    eng = _fe(resilience=cfg)
    for i in range(4):
        assert eng.submit(_req(i)) is True
    outcomes = []
    while eng.pending:
        outcomes += eng.step()
    assert sorted(o.rid for o in outcomes) == [0, 1, 2, 3]
    assert all(not o.deadline_missed for o in outcomes)


# --------------------------------------------------- resilient VideoEngine
def test_close_stream_refuses_then_cancels_in_flight_frames():
    eng = _ve(chunk=2, resilience=_cfg())
    sid = eng.open_stream("tmotion-t", 8, 8)
    for i in range(3):
        assert eng.submit(VideoFrame(sid, {"in": _frame((8, 8))}, rid=i))
    with pytest.raises(ValueError, match="undelivered"):
        eng.close_stream(sid)
    assert sid in eng._sessions
    cancelled = eng.close_stream(sid, cancel=True)
    assert [c.rid for c in cancelled] == [0, 1, 2]
    assert all(isinstance(c, CancelledFrame)
               and c.reason == "stream_closed" for c in cancelled)
    assert eng.metrics.frames_cancelled == 3
    assert eng.pending == 0 and len(eng._admission) == 0
    rec = eng.metrics.reconcile()
    assert rec["balanced"] and rec["in_flight"] == 0


def test_video_resilient_rejects_unknown_stream_and_bad_shape():
    eng = _ve(resilience=_cfg())
    rej = eng.submit(VideoFrame(999, {"in": _frame((8, 8))}))
    assert isinstance(rej, RejectedFrame) and rej.reason == "unknown_stream"
    sid = eng.open_stream("tmotion-t", 8, 8)
    rej = eng.submit(VideoFrame(sid, {"in": _frame((4, 4))}))
    assert rej.reason == "bad_shape"
    nan = _frame((8, 8))
    nan[2, 2] = np.nan
    assert eng.submit(VideoFrame(sid, {"in": nan})).reason == "nonfinite"
    assert eng.submit(VideoFrame(sid, {"in": _frame((8, 8))})) is True
    assert eng.metrics.reconcile()["balanced"]


def test_video_executor_exception_structured_in_strict_mode():
    eng = _ve(chunk=2)
    monkey = ChaosMonkey(seed=0, executor=1.0)
    install_chaos(eng.cache, monkey)
    sid = eng.open_stream("tmotion-t", 8, 8)
    for i in range(2):
        assert eng.submit(VideoFrame(sid, {"in": _frame((8, 8))}, rid=i))
    outcomes = eng.step()
    failed = [o for o in outcomes if isinstance(o, FailedFrame)]
    assert [f.rid for f in failed] == [0, 1]
    assert eng.pending == 0
    monkey.rates["executor"] = 0.0
    assert eng.submit(VideoFrame(sid, {"in": _frame((8, 8))}, rid=2))
    served = eng.step()
    assert len(served) == 1 and served[0].rid == 2
    assert served[0].index == 0
    assert eng.metrics.reconcile()["balanced"]


@pytest.mark.parametrize("pipeline,chunk", [
    ("tmotion-t", 1), ("tmotion-t", 2), ("tbackground-t", 2),
    ("tinternal", 1)])
def test_video_reference_fallback_resumes_compiled_stream(pipeline, chunk):
    """Frames served off the reference rung mid-stream match the
    full-stream oracle, and the compiled path resumes from the rebuilt
    rings: for input producers and for an internal temporal producer."""
    from repro_torch.imaging import PlanCache
    pipes = {pipeline: _port_tinternal} if pipeline == "tinternal" \
        else None
    eng = _ve(chunk=chunk,
              cache=PlanCache(pipelines=pipes, device="cpu",
                              retry=_cfg().retry),
              resilience=_cfg(breaker_failures=1, breaker_reset_s=0.0))
    monkey = ChaosMonkey(seed=0)
    install_chaos(eng.cache, monkey)
    sid = eng.open_stream(pipeline, 8, 8)
    frames = [_frame((8, 8)) for _ in range(6 * chunk)]
    outs, rungs = [], []
    for t in range(0, len(frames), chunk):
        if t == 2 * chunk:          # blackout: compiled rungs broken
            monkey.rates["compile"] = 1.0
            eng.cache.evict_executors()
        elif t == 4 * chunk:        # recovery
            monkey.rates["compile"] = 0.0
        for k in range(chunk):
            assert eng.submit(VideoFrame(sid, {"in": frames[t + k]},
                                         rid=t + k)) is True
        comp = [c for c in eng.step()
                if isinstance(c, CompletedVideoFrame)]
        assert [c.rid for c in comp] == list(range(t, t + chunk))
        outs += [c.output for c in comp]
        rungs += [c.rung for c in comp]
    c2 = 2 * chunk
    assert rungs == ["default"] * c2 + ["reference"] * c2 \
        + ["default"] * c2
    dag = eng.cache.dag_for(pipeline)
    want = video_oracle(dag, np.stack(frames))
    assert_ulp_equal(torch.stack(outs), want)
    # and bit for bit the stream the strict engine serves
    strict = _ve(chunk=chunk, cache=PlanCache(pipelines=pipes,
                                              device="cpu"))
    sid2 = strict.open_stream(pipeline, 8, 8)
    got = strict.run({sid2: [{"in": f} for f in frames]})[sid2]
    assert torch.equal(torch.stack(outs), torch.stack(got))
    assert eng.metrics.fallback_frames == c2
    assert eng.metrics.reconcile()["balanced"]


def test_state_from_history_layout():
    """Rings rebuilt from a reference history: newest first, (d-1, h, w)
    float32 on the engine's device, zero-padded for a young stream."""
    hist = {"a": [torch.full((2, 3), 3.0), torch.full((2, 3), 2.0)],
            "b": [torch.full((2, 3), 5.0)]}
    st = VideoEngine._state_from_history({"a": 3, "b": 4, "c": 1}, hist,
                                         2, 3, torch.device("cpu"))
    assert st["a"].shape == (2, 2, 3) and st["a"].dtype == torch.float32
    assert st["a"][:, 0, 0].tolist() == [3.0, 2.0]
    assert st["b"][:, 0, 0].tolist() == [5.0, 0.0, 0.0]
    assert st["c"].shape == (0, 2, 3)


def test_video_history_tracks_served_frames_only():
    eng = _ve(chunk=1, resilience=_cfg())
    sid = eng.open_stream("tbackground-t", 8, 8)
    s = eng._sessions[sid]
    assert s.history["in"].maxlen == s.warmup_frames
    frames = [_frame((8, 8)) for _ in range(s.warmup_frames + 3)]
    assert eng.submit(VideoFrame(sid, {"in": frames[0]},
                                 deadline_s=-1.0)) is True
    (shed,) = eng.step()                      # expired: never served
    assert isinstance(shed, ShedFrame) and not s.history["in"]
    for f in frames[1:]:
        assert eng.submit(VideoFrame(sid, {"in": f})) is True
        eng.step()
    assert len(s.history["in"]) == s.warmup_frames
    np.testing.assert_array_equal(s.history["in"][-1], frames[-1])
    spatial = _ve(resilience=_cfg())
    assert spatial._sessions[spatial.open_stream(
        "unsharp-m", 8, 8)].history is None


def test_video_fault_free_resilient_streams_equal_strict():
    names = ["tmotion-t", "tunsharp-t"]
    vids = {n: [_frame((8, 8)) for _ in range(8)] for n in names}
    strict, eng = _ve(chunk=4), _ve(chunk=4, resilience=ResilienceConfig())
    for n in names:
        a, b = strict.open_stream(n, 8, 8), eng.open_stream(n, 8, 8)
        want = strict.run({a: [{"in": f} for f in vids[n]]})[a]
        for f in vids[n]:
            assert eng.submit(VideoFrame(b, {"in": f})) is True
        done = []
        while eng.pending:
            done += eng.step()
        assert {c.rung for c in done} == {"default"}
        assert torch.equal(torch.stack([c.output for c in done]),
                           torch.stack(want))
    assert eng.metrics.executor_retries == 0
    assert eng.metrics.fallback_frames == 0
