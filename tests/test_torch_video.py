"""Temporal pipelines in the port against the JAX package's video oracle.

The oracle is ``repro.core.algorithms.execute_reference_video`` (pure
jnp); the JAX package's Pallas executors are not used. Inputs come from
``numpy.random.RandomState`` and reach both packages as numpy arrays;
frame-ring states cross the same way, in the same (d-1, h, w)
newest-first layout.

Tolerance: bitwise equality first, else <= 32 ULP at the array's scale
(``tests/test_video.py``): XLA may contract a multiply and an add into
one FMA where the eager port rounds twice. A structural fault (wrong tap
order, stale frame ring, cross-stream leakage) is off by ~1e6 ULP.

On the CPU the kernel's wrapper runs its plain PyTorch version
(``video_pipeline_plain``), so these tests hold the plain version, the
tap and state plumbing and the engine against the oracle;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernel
against the plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core import codegen as jax_codegen
from repro.core.dsl import Pipeline as JaxPipeline
from repro_torch.core import algorithms, compile_pipeline
from repro_torch.core.codegen import plan_from_dict
from repro_torch.core.dsl import Pipeline
from repro_torch.core.ilp import build_problem, solve_schedule
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
from repro_torch.kernels import ref
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.resilience import CancelledFrame
from repro_torch.video import VideoEngine, VideoFrame

VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)
# streams >= 3x the deepest temporal extent (tbackground-t: depth 8)
T, H, W = 24, 13, 24


def assert_video_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())   # a few ULP at array scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def _video(seed, t=T, h=H, w=W):
    return np.random.RandomState(seed).rand(t, h, w).astype(np.float32)


def _tinternal(alg, pipeline):
    """Temporal taps on a *computed* stage (``tests/test_video.py``)."""
    p = pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], alg.conv_fn(alg.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], alg.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


def _dags(name):
    """(jax dag, port dag) for a video pipeline or ``tinternal``."""
    if name == "tinternal":
        return (_tinternal(jax_algorithms, JaxPipeline),
                _tinternal(algorithms, Pipeline))
    return (jax_algorithms.VIDEO_ALGORITHMS[name](),
            algorithms.VIDEO_ALGORITHMS[name]())


def _oracle(name, vid, return_history=False):
    jdag, _ = _dags(name)
    res = jax_algorithms.execute_reference_video(
        jdag, {"in": vid}, return_history=return_history)
    if not return_history:
        return np.asarray(res)
    out, hist = res
    return np.asarray(out), {p: [np.asarray(f) for f in fr]
                             for p, fr in hist.items()}


def run_stream(ex, vid, state=None):
    """Drive a (T, H, W) stream through an executor, frame by frame or
    chunk by chunk; returns (outputs, final state)."""
    state = ex.init_state() if state is None else state
    outs = []
    step = ex.chunk or 1
    for t in range(0, vid.shape[0], step):
        x = vid[t] if ex.chunk is None else vid[t:t + step]
        o, state = ex({"in": x}, state)
        outs.append(o.reshape(-1, *o.shape[-2:]).numpy())
    return np.concatenate(outs), state


def _state_matches(state, hist, depths):
    for p, d in depths.items():
        exp = np.stack(hist[p][:d - 1])
        assert state[p].shape == (d - 1, H, W)
        assert_video_equal(state[p].numpy(), exp)


@pytest.fixture(scope="module")
def cache():
    return PlanCache(device="cpu")


# ---------------------------------------------------------------- oracle
@pytest.mark.parametrize("name", VIDEO + ["tinternal"])
def test_reference_video_matches_jax(name):
    vid = _video(1)
    _, dag = _dags(name)
    out, hist = algorithms.execute_reference_video(dag, {"in": vid},
                                                   return_history=True)
    exp, jhist = _oracle(name, vid, return_history=True)
    assert_video_equal(out.numpy(), exp)
    assert set(hist) == set(jhist) == set(dag.temporal_depths())
    for p in hist:
        assert len(hist[p]) == len(jhist[p]) == dag.temporal_depths()[p] - 1
        assert_video_equal(np.stack([f.numpy() for f in hist[p]]),
                           np.stack(jhist[p]))
    assert_video_equal(ref.video_pipeline_ref(dag, {"in": vid}).numpy(), exp)


def test_short_stream_history_is_short():
    """A stream younger than its depth returns a shorter history, as the
    reference does."""
    dag = algorithms.tbackground_t()
    _, hist = algorithms.execute_reference_video(
        dag, {"in": _video(2, t=3)}, return_history=True)
    assert len(hist["in"]) == 3


def test_synthetic_pipeline_matches_jax():
    for n, seed in [(8, 0), (12, 3), (20, 7)]:
        got = algorithms.synthetic_pipeline(n, seed=seed)
        exp = jax_algorithms.synthetic_pipeline(n, seed=seed)
        assert got.name == exp.name and got.topo_order == exp.topo_order
        assert [(e.producer, e.consumer, e.st, e.sh, e.sw)
                for e in got.edges] == \
            [(e.producer, e.consumer, e.st, e.sh, e.sw) for e in exp.edges]
        # a planner workload (the Sec. 8.2 sweep): the plans agree
        assert compile_pipeline(got, 48).fingerprint() == \
            jax_codegen.compile_pipeline(exp, 48).fingerprint()


# ------------------------------------------------------------- executors
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("name", VIDEO + ["tinternal"])
def test_stream_matches_reference(name, rows):
    """Sequential frame-ring execution vs. the multi-frame oracle, at
    R in {1, 8} (h % 8 != 0 so the last row group is partial); the
    final state equals the oracle's history, newest first."""
    vid = _video(3)
    _, dag = _dags(name)
    exp, hist = _oracle(name, vid, return_history=True)
    ex = sp.make_video_executor(dag, H, W, rows_per_step=rows,
                                device="cpu")
    got, state = run_stream(ex, vid)
    assert_video_equal(got, exp)
    _state_matches(state, hist, dag.temporal_depths())


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("name", VIDEO)
def test_chunked_stream_matches_reference(name, rows):
    """Time-chunk execution: 4 consecutive frames per launch, history
    taps read from the chunk itself and from the state."""
    vid = _video(4)
    _, dag = _dags(name)
    exp, hist = _oracle(name, vid, return_history=True)
    ex = sp.make_video_executor(dag, H, W, chunk=4, rows_per_step=rows,
                                device="cpu")
    got, state = run_stream(ex, vid)
    assert_video_equal(got, exp)
    _state_matches(state, hist, dag.temporal_depths())


def test_stream_at_320p_matches_reference():
    """One pipeline at the paper's 320p (480x320), chunked."""
    w, h = algorithms.RESOLUTIONS["320p"]
    vid = _video(5, t=8, h=h, w=w)
    dag = algorithms.tunsharp_t()
    ex = sp.make_video_executor(dag, h, w, chunk=4, rows_per_step=8,
                                device="cpu")
    got, _ = run_stream(ex, vid)
    assert_video_equal(got, _oracle("tunsharp-t", vid))


def test_state_crosses_from_the_reference():
    """A stream resumed mid-way from the JAX oracle's history, carried
    across as numpy arrays in the (d-1, h, w) newest-first layout, goes
    on exactly like the unbroken stream."""
    vid = _video(6)
    dag = algorithms.tbackground_t()
    exp = _oracle("tbackground-t", vid)
    _, hist = _oracle("tbackground-t", vid[:10], return_history=True)
    state = {p: np.stack(fr) for p, fr in hist.items()}
    ex = sp.make_video_executor(dag, H, W, chunk=2, rows_per_step=8,
                                device="cpu")
    got, _ = run_stream(ex, vid[10:], state=state)
    assert_video_equal(got, exp[10:])


def test_executor_does_not_mutate_the_given_state():
    dag = algorithms.tdenoise_t()
    ex = sp.make_video_executor(dag, H, W, chunk=4, device="cpu")
    state = {"in": torch.from_numpy(_video(7, t=3))}
    before = state["in"].clone()
    _, new = ex({"in": _video(8, t=4)}, state)
    assert torch.equal(state["in"], before)
    assert new["in"] is not state["in"]


def test_warmup_equals_zero_history():
    """The first frames compute against zero frame rings — the same as a
    reference stream zero-padded before t=0, and NOT the same as a
    stream that actually had earlier frames."""
    name = "tbackground-t"
    vid = _video(9)
    ex = sp.make_video_executor(algorithms.tbackground_t(), H, W,
                                rows_per_step=8, device="cpu")
    got, _ = run_stream(ex, vid)
    assert_video_equal(got, _oracle(name, vid))
    assert ex.warmup_frames == 7
    longer = np.concatenate([_video(10, t=8), vid])
    exp_tail = _oracle(name, longer)[8:]
    assert np.abs(exp_tail[0] - got[0]).max() > 1e-3


def test_internal_temporal_producer_sequential():
    """Temporal taps on a *computed* stage: its frames round-trip
    through the kernel's frame outputs into the frame ring; chunking
    such a pipeline is a loud, early error."""
    _, dag = _dags("tinternal")
    vid = _video(11, t=9)
    exp = _oracle("tinternal", vid)
    for rows in (1, 8):
        ex = sp.make_video_executor(dag, H, W, rows_per_step=rows,
                                    device="cpu")
        assert ex.program.frame_outs == ("blur",)
        assert_video_equal(run_stream(ex, vid)[0], exp)
    with pytest.raises(ValueError, match="input-only temporal taps"):
        sp.make_video_executor(dag, H, W, chunk=4, device="cpu")
    prog = sp.build_program(dag, H, W, 8, frames=2)
    x = torch.zeros(2, H, W)
    with pytest.raises(ValueError, match="input-only temporal taps"):
        sp.stencil_pipeline(prog, [x], [torch.zeros(1, H, W)])


def test_spatial_dag_degenerates(cache):
    """A video executor over a spatial pipeline: empty state, output
    identical to the plain executor."""
    ex = cache.video_executor_for("unsharp-m", H, W, rows_per_step=8)
    assert ex.init_state() == {}
    img = _video(12, t=1)[0]
    out, state = ex({"in": img}, {})
    exp = cache.executor_for("unsharp-m", H, W, rows_per_step=8)({"in": img})
    assert torch.equal(out, exp)
    assert state == {}


@pytest.mark.parametrize("name", VIDEO)
def test_frame_ring_accounting_matches_jax(name):
    """Frame depths, the ILP's frame-ring term and the per-height frame
    bytes equal the reference planner's; the executor reports the same
    state bytes."""
    jdag, dag = _dags(name)
    plan = compile_pipeline(dag, W, frame_h=32)
    jplan = jax_codegen.compile_pipeline(jdag, W, frame_h=32)
    assert plan.frame_depths == jplan.frame_depths
    assert plan.schedule.frame_pixels == jplan.schedule.frame_pixels
    assert plan.schedule.total_pixels == jplan.schedule.total_pixels
    assert plan.vmem_frame_bytes(32) == jplan.vmem_frame_bytes(32)
    assert plan.fingerprint() == jplan.fingerprint()
    ex = sp.make_video_executor(dag, 32, W, plan=plan, device="cpu")
    assert ex.frame_state_bytes == jplan.vmem_frame_bytes(32)
    assert ex.state_roll_bytes == 2 * ex.frame_state_bytes


def test_tbackground_frame_ring_term():
    dag = algorithms.tbackground_t()           # depth 8 on the input
    plan0 = compile_pipeline(dag, 24)
    plan = compile_pipeline(dag, 24, frame_h=32)
    assert plan.schedule.frame_depths == {"in": 8}
    assert plan.schedule.frame_pixels == 7 * 32 * 24
    assert plan.schedule.total_pixels == \
        plan0.schedule.total_pixels + 7 * 32 * 24
    assert plan.vmem_frame_bytes(32) == 7 * 32 * 24 * 4
    prob = build_problem(algorithms.unsharp_m(), 24, frame_h=32)
    assert solve_schedule(prob).frame_pixels == 0


@pytest.mark.parametrize("name", VIDEO)
def test_executor_runs_the_reference_temporal_plan(name):
    """The JAX planner's temporal plan, carried across as its dict,
    rebuilds the port's plan (same fingerprint) and serves the stream."""
    jdag, dag = _dags(name)
    jplan = jax_codegen.compile_pipeline(jdag, W, rows_per_step=8)
    plan = plan_from_dict(jplan.to_dict(), dag)
    assert plan.fingerprint() == jplan.fingerprint()
    vid = _video(13, t=8)
    ex = sp.make_video_executor(dag, H, W, plan=plan, chunk=4, device="cpu")
    assert_video_equal(run_stream(ex, vid)[0], _oracle(name, vid))


def test_stage_table_lays_out_tap_rings():
    """tbackground-t: seven tap stages first, the input's rings oldest
    tap first and its live ring last, and the bg operand spanning all
    eight."""
    prog = sp.build_program(algorithms.tbackground_t(), H, W, 8)
    rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
    n = int(prog.table[sp.H_NSTAGES])
    ops = [sp.OPS[r[sp.S_OP]] for r in rows[:n]]
    assert ops == ["tap"] * 7 + ["input", "stmean", "bg_subtract"]
    assert [int(r[sp.S_TAPJ]) for r in rows[:7]] == list(range(1, 8))
    live = int(rows[7][sp.S_RING])
    assert [int(r[sp.S_RING]) for r in rows[:7]] == \
        [live - j for j in range(1, 8)]
    bg = rows[8]
    assert (int(bg[sp.S_SRC]), int(bg[sp.S_ST])) == (live - 7, 8)
    assert prog.states == ("in",) and prog.frame_outs == ()
    # temporal programs launch the kernel's temporal instantiation
    assert prog.table[sp.H_TEMPORAL] == 1
    assert sp.build_program(algorithms.unsharp_m(), H, W, 8).table[
        sp.H_TEMPORAL] == 0


def test_temporal_pipeline_refused_by_spatial_paths(cache):
    dag = cache.dag_for("tmotion-t")
    with pytest.raises(ValueError, match="make_video_executor"):
        sp.make_executor(dag, H, W, device="cpu")
    with pytest.raises(ValueError, match="execute_reference_video"):
        algorithms.execute_reference(dag, {"in": _video(0, t=1)[0]})
    eng = FrameEngine(cache=cache)
    with pytest.raises(ValueError, match="VideoEngine"):
        eng.submit(FrameRequest(rid=0, pipeline="tmotion-t",
                                frames={"in": _video(0, t=1)[0]}))


def test_video_executor_cache_level(cache):
    c = PlanCache(device="cpu")
    e1 = c.video_executor_for("tmotion-t", H, W, chunk=4)
    assert c.video_executor_for("tmotion-t", H, W, chunk=4) is e1
    assert c.video_executor_for("tmotion-t", H, W) is not e1
    assert c.stats.exec_hits == 1 and c.stats.plan_misses == 1
    assert e1.device.type == "cpu" and e1.chunk == 4
    # a frame executor of the same shape is another artifact
    c.executor_for("unsharp-m", H, W)
    c.video_executor_for("unsharp-m", H, W)
    assert c.snapshot()["execs_resident"] == 4


# ---------------------------------------------------------------- engine
def test_engine_interleaved_streams_no_leakage(cache):
    """Two concurrent streams of one pipeline share every executor but
    never each other's frame rings: each must match its own full-stream
    reference, with ordered delivery."""
    eng = VideoEngine(cache=cache, chunk=4)
    dag = cache.dag_for("tdenoise-t")
    vids = [_video(20 + i) for i in range(2)]
    sids = [eng.open_stream("tdenoise-t", H, W) for _ in range(2)]
    outs = {sid: [] for sid in sids}
    fed = {sid: 0 for sid in sids}
    while any(fed[s] < T for s in sids) or eng.pending:
        for sid, vid in zip(sids, vids):
            if fed[sid] < T and eng.submit(
                    VideoFrame(sid, {"in": vid[fed[sid]]})):
                fed[sid] += 1
        for c in eng.step():
            outs[c.stream].append(c)
    for sid, vid in zip(sids, vids):
        assert [c.index for c in outs[sid]] == list(range(T))
        assert_video_equal(np.stack([c.output.numpy()
                                     for c in outs[sid]]),
                           _oracle("tdenoise-t", vid))
        warm_from = dag.cumulative_extent(temporal=True)[0]
        assert [c.warm for c in outs[sid]] == \
            [i >= warm_from for i in range(T)]
        assert all(c.rung == "default" for c in outs[sid])
    for sid in sids:
        eng.close_stream(sid)
    snap = eng.snapshot()
    assert snap["open_streams"] == 0
    assert snap["warmup_latency"]["count"] == 2


def test_engine_backpressure_and_admission(cache):
    eng = VideoEngine(cache=cache, chunk=2, max_pending=2)
    sid = eng.open_stream("tmotion-t", H, W)
    rng = np.random.RandomState(30)
    f = lambda: VideoFrame(sid, {"in": rng.rand(H, W).astype(np.float32)})
    assert eng.submit(f()) and eng.submit(f())
    assert not eng.submit(f())                     # full queue refuses
    assert eng.metrics.frames_rejected == 1
    with pytest.raises(KeyError):
        eng.submit(VideoFrame(sid + 99, {"in": np.zeros((H, W))}))
    with pytest.raises(ValueError, match="needs inputs"):
        eng.submit(VideoFrame(sid, {"wrong": np.zeros((H, W))}))
    with pytest.raises(ValueError, match="frame shape"):
        eng.submit(VideoFrame(sid, {"in": np.zeros((H + 1, W))}))
    done = eng.step()
    assert len(done) == 2 and [c.index for c in done] == [0, 1]
    assert eng.submit(f())
    with pytest.raises(ValueError, match="undelivered"):
        eng.close_stream(sid)                      # refuses, keeps session
    assert len(eng.step()) == 1
    eng.close_stream(sid)                          # drained: closes clean


def test_engine_run_convenience(cache):
    eng = VideoEngine(cache=cache, chunk=4)
    vid = _video(31, t=12)
    sid = eng.open_stream("tunsharp-t", H, W)
    res = eng.run({sid: [{"in": f} for f in vid]})
    assert_video_equal(np.stack([o.numpy() for o in res[sid]]),
                       _oracle("tunsharp-t", vid))


def test_engine_run_with_foreign_stream_pending(cache):
    """run() must not crash on — or swallow — frames of a stream it was
    not asked to drain: foreign completions come back under their own
    stream id."""
    eng = VideoEngine(cache=cache, chunk=2)
    other = eng.open_stream("tmotion-t", H, W)
    mine = eng.open_stream("tmotion-t", H, W)
    eng.submit(VideoFrame(other, {"in": _video(32, t=1)[0]}))
    res = eng.run({mine: [{"in": f} for f in _video(33, t=4)]})
    assert len(res[mine]) == 4
    assert len(res.get(other, [])) == 1
    eng.close_stream(other)                      # drained by the run


def test_engine_cancel_and_failure(cache, monkeypatch):
    """close_stream(cancel=True) drains as CancelledFrame results; an
    executor exception comes back as FailedFrame results and leaves the
    session state where it was."""
    eng = VideoEngine(cache=cache, chunk=2)
    sid = eng.open_stream("tmotion-t", H, W)
    eng.submit(VideoFrame(sid, {"in": _video(34, t=1)[0]}, rid=7))
    cancelled = eng.close_stream(sid, cancel=True)
    assert [(type(c), c.rid) for c in cancelled] == [(CancelledFrame, 7)]
    sid = eng.open_stream("tmotion-t", H, W)
    state = eng._sessions[sid].state

    def boom(*a, **k):
        raise RuntimeError("executor down")
    monkeypatch.setattr(eng, "_run_chunk", boom)
    for f in _video(35, t=2):
        eng.submit(VideoFrame(sid, {"in": f}))
    res = eng.step()
    assert [type(r).__name__ for r in res] == ["FailedFrame"] * 2
    assert eng._sessions[sid].state is state
    assert eng.metrics.frames_failed == 2


def test_engine_refuses_resilient_mode_and_needs_a_card():
    with pytest.raises(NotImplementedError, match="resilient"):
        VideoEngine(resilience=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VideoEngine()
