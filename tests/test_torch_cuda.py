"""The CUDA kernels, the serving paths and the LM stack on the card.

These tests need an NVIDIA GPU: on a machine without one they skip (the
kernel has no CPU mode; the CPU tests hold its plain version against the
JAX oracle). They import nothing of JAX, so they run where the port does:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bitwise for the stencil kernels (any prefetch depth) and
conv2d. They round every product and sum on their own (``_rn``
intrinsics, built with ``-fmad=false``) in the plain version's order, and
the square root is correctly rounded like the plain one's. swa_decode
sums its dot products in another order: rtol 2e-4, atol 2e-5.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache, \
    execute_tiled
from repro_torch.kernels import conv2d_stencil, ops
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.kernels import swa_decode as swa
from repro_torch.resilience import ResilienceConfig, RetryPolicy
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos
from repro_torch.video import VideoEngine, VideoFrame

NAMES = sorted(algorithms.ALGORITHMS)
VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)


def _tinternal():
    p = Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], algorithms.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


def _tstmean():
    """A temporal pipeline whose final stage (a 4-frame mean of the
    input's history taps) sits at DAG level 1: no barrier follows the
    output store."""
    p = Pipeline("tstmean")
    x = p.input("in")
    m = p.stage("m", [(x, 4, 1, 1)], algorithms.stmean_fn(4, 1, 1))
    p.output("out", [(m, 1, 1)])
    return p.build()


def _generic(temporal: bool = False):
    """Windows no registered pipeline uses (the kernel's generic body): a
    7x2 conv, a 5x4 nms and, temporal, a (2, 3, 1) stmean."""
    taps = np.random.RandomState(9).randn(7, 2).astype(np.float32)
    p = Pipeline("tgeneric" if temporal else "generic")
    x = p.input("in")
    a = p.stage("a", [(x, 7, 2)], algorithms.conv_fn(taps))
    n = p.stage("n", [(a, 5, 4)], algorithms.nms_fn)
    if temporal:
        m = p.stage("m", [(x, 2, 3, 1)], algorithms.stmean_fn(2, 3, 1))
        n = p.stage("j", [(n, 1, 1), (m, 1, 1)], algorithms.prod_fn)
    p.output("out", [(n, 1, 1)])
    return p.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frames(seed, n, h, w):
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_bitwise(cuda_device, name, r):
    dag = algorithms.ALGORITHMS[name]()
    frames = torch.from_numpy(_frames(9, 3, 37, 53)).to(cuda_device)
    frames[1] = 0.0                              # idle slot
    ex = sp.make_executor(dag, 37, 53, batch=3, rows_per_step=r,
                          device=cuda_device)
    before = sp.stencil_pipeline.launches
    got = ex({"in": frames})
    torch.cuda.synchronize()
    assert sp.stencil_pipeline.launches == before + 1
    assert torch.equal(got, sp.stencil_pipeline_plain(dag, {"in": frames}))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name", ["generic", "tgeneric", "canny-m",
                                  "through"])
def test_generic_body_and_vector_io_match_plain_bitwise(cuda_device, name,
                                                        r):
    """The generic body (a DSL pipeline with unusual windows, spatial and
    temporal over random frame-ring states), canny-m and an output wired
    straight to the input, at a scalar width (53) and a float4 one
    (1920), equal the plain version."""
    if name == "through":
        p = Pipeline("through")
        p.output("out", [(p.input("in"), 1, 1)])
        dag = p.build()
    elif name in algorithms.ALGORITHMS:
        dag = algorithms.ALGORITHMS[name]()
    else:
        dag = _generic(name == "tgeneric")
    depths = dag.temporal_depths()
    rng = np.random.RandomState(21)
    for h, w in [(37, 53), (45, 1920)]:
        x = torch.from_numpy(_frames(5, 4, h, w)).to(cuda_device)
        prog = sp.build_program(dag, h, w, r, frames=4)
        assert int(prog.table[sp.H_VEC]) == (w % 4 == 0)
        states = [torch.from_numpy(rng.rand(depths[p] - 1, h, w).astype(
            np.float32)).to(cuda_device) for p in prog.states]
        got = sp.stencil_pipeline(prog, [x], states)
        torch.cuda.synchronize()
        inputs = {"in": x}
        exp, _ = sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs,
                                     dict(zip(prog.states, states)), 4)})
        assert torch.equal(got, exp), (name, (h, w), r)


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(cuda_device):
    eng = FrameEngine(max_batch=3, max_pending=16, tile_shape=(40, 48),
                      device=cuda_device)
    reqs = [FrameRequest(rid=i, pipeline=["canny-m", "xcorr-m"][i % 2],
                         frames={"in": _frames(i, 1, *((50, 70) if i % 3
                                                       else (24, 32)))[0]})
            for i in range(8)]
    before = sp.stencil_pipeline.launches
    res = eng.run(reqs)
    assert sp.stencil_pipeline.launches > before
    for r in reqs:
        exp = sp.stencil_pipeline_plain(
            eng.cache.dag_for(r.pipeline),
            {"in": torch.as_tensor(r.frames["in"], device=cuda_device)})
        assert res[r.rid].device.type == "cuda"
        assert torch.equal(res[r.rid], exp)


@pytest.mark.cuda
def test_tiled_matches_plain_on_card(cuda_device):
    cache = PlanCache(device=cuda_device)
    img = torch.from_numpy(_frames(1, 1, 90, 130)[0]).to(cuda_device)
    got = execute_tiled(cache, "canny-m", {"in": img}, 40, 48, batch=4)
    exp = sp.stencil_pipeline_plain(cache.dag_for("canny-m"), {"in": img})
    assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name,chunk", [(n, c) for n in VIDEO
                                        for c in (None, 4)]
                         + [("tinternal", None)])
def test_temporal_kernel_matches_plain_bitwise(cuda_device, name, chunk, r):
    """K1c: a 12-frame stream from a zero state, output and every
    returned state equal to the plain version's on the same state
    (internal temporal producers run one frame a launch)."""
    dag = _tinternal() if name == "tinternal" \
        else algorithms.VIDEO_ALGORITHMS[name]()
    h, w = 37, 53
    vid = torch.from_numpy(_frames(4, 12, h, w)).to(cuda_device)
    ex = sp.make_video_executor(dag, h, w, rows_per_step=r, chunk=chunk,
                                device=cuda_device)
    state = ex.init_state()
    step = chunk or 1
    for t in range(0, 12, step):
        x = vid[t:t + step] if chunk else vid[t]
        before = sp.stencil_pipeline.launches
        got, new = ex({"in": x}, state)
        torch.cuda.synchronize()
        assert sp.stencil_pipeline.launches == before + 1
        inputs = {"in": x.reshape(-1, h, w)}
        exp, frames = sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs, state, step)})
        assert torch.equal(got.reshape(-1, h, w), exp)
        for p in ex.program.frame_outs:
            assert torch.equal(new[p][0], frames[p][0])
        state = new
    assert all(v.device.type == "cuda" for v in state.values())


@pytest.mark.cuda
def test_video_engine_serves_through_the_kernel(cuda_device):
    eng = VideoEngine(chunk=4, device=cuda_device)
    h, w = 40, 56
    vid = _frames(6, 10, h, w)
    sid = eng.open_stream("tbackground-t", h, w)
    before = sp.stencil_pipeline.launches
    res = eng.run({sid: [{"in": f} for f in vid]})
    assert sp.stencil_pipeline.launches > before
    exp = algorithms.execute_reference_video(
        eng.cache.dag_for("tbackground-t"),
        {"in": torch.from_numpy(vid).to(cuda_device)})
    got = torch.stack(res[sid])
    assert got.device.type == "cuda" and torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_prefetch_kernel_matches_depth1_bitwise(cuda_device, name, depth):
    """K1d: feeds copied ahead into their grown rings (the grown slots
    poisoned with NaN before the first copy) give the depth-1 kernel's
    and the plain version's pixels, bands with fewer row groups than the
    depth included, scalar and float4 copies, rings that wrap mid-group."""
    dag = algorithms.ALGORITHMS[name]()
    for h, w, r in [(37, 53, 8), (5, 48, 8), (90, 130, 1), (45, 1920, 3)]:
        frames = torch.from_numpy(_frames(9, 3, h, w)).to(cuda_device)
        frames[1] = 0.0
        prog = sp.build_program(dag, h, w, r, frames=3,
                                prefetch_depth=depth, poison_prefetch=True)
        base = sp.build_program(dag, h, w, r, frames=3)
        got = sp.stencil_pipeline(prog, [frames])
        torch.cuda.synchronize()
        assert torch.equal(got, sp.stencil_pipeline(base, [frames]))
        assert torch.equal(got, sp.stencil_pipeline_plain(dag,
                                                          {"in": frames}))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("name,chunk", [(n, 4) for n in VIDEO]
                         + [("tinternal", None), ("tstmean", 4)])
def test_prefetch_temporal_kernel_matches_plain_bitwise(cuda_device, name,
                                                        chunk, depth):
    """K1d on the temporal table: a 12-frame stream at depth d equals the
    depth-1 executor's output and state and the plain version at every
    step, and so does the same program with the grown slots of its input
    and tap rings poisoned with NaN, at a scalar and a float4 width."""
    dag = {"tinternal": _tinternal, "tstmean": _tstmean}.get(
        name, algorithms.VIDEO_ALGORITHMS.get(name))()
    step = chunk or 1
    for h, w in [(37, 53), (45, 1920)]:
        vid = torch.from_numpy(_frames(4, 12, h, w)).to(cuda_device)
        ex = sp.make_video_executor(dag, h, w, rows_per_step=8, chunk=chunk,
                                    prefetch_depth=depth, device=cuda_device)
        ex1 = sp.make_video_executor(dag, h, w, rows_per_step=8,
                                     chunk=chunk, device=cuda_device)
        poisoned = sp.build_program(dag, h, w, 8, frames=step,
                                    prefetch_depth=depth,
                                    poison_prefetch=True)
        state = state1 = ex.init_state()
        for t in range(0, 12, step):
            x = vid[t:t + step] if chunk else vid[t]
            res = sp.stencil_pipeline(poisoned, [x.reshape(-1, h, w)],
                                      [state[p] for p in poisoned.states])
            inputs = {"in": x.reshape(-1, h, w)}
            plain, _ = sp.video_pipeline_plain(dag, {
                **inputs, **sp.tap_feeds(dag, inputs, state, step)})
            got, state = ex({"in": x}, state)
            exp, state1 = ex1({"in": x}, state1)
            torch.cuda.synchronize()
            where = (name, (h, w), t)
            assert torch.equal(got, exp), where
            assert torch.equal(got.reshape(-1, h, w), plain), where
            assert torch.equal((res[0] if poisoned.frame_outs else res)
                               .reshape(got.shape), got), where
            assert all(torch.equal(state[p], state1[p]) for p in state)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("name", ["generic", "tgeneric", "through"])
def test_prefetch_generic_body_and_through_match_plain_bitwise(cuda_device,
                                                               name, depth):
    """K1d on the generic body (spatial and temporal) and on an output
    wired straight to the input (the feed moves its rows from its ring to
    the output block), poisoned, at a scalar and a float4 width."""
    if name == "through":
        p = Pipeline("through")
        p.output("out", [(p.input("in"), 1, 1)])
        dag = p.build()
    else:
        dag = _generic(name == "tgeneric")
    depths = dag.temporal_depths()
    rng = np.random.RandomState(22)
    for h, w in [(37, 53), (45, 1920)]:
        for r in (3, 8):
            x = torch.from_numpy(_frames(6, 4, h, w)).to(cuda_device)
            states = [torch.from_numpy(rng.rand(depths[q] - 1, h, w).astype(
                np.float32)).to(cuda_device) for q in
                sorted(depths, key=dag.topo_order.index)]
            prog = sp.build_program(dag, h, w, r, frames=4,
                                    prefetch_depth=depth,
                                    poison_prefetch=True)
            got = sp.stencil_pipeline(prog, [x], states)
            base = sp.stencil_pipeline(sp.build_program(dag, h, w, r,
                                                        frames=4),
                                       [x], states)
            torch.cuda.synchronize()
            assert torch.equal(got, base), ((h, w), r)
            inputs = {"in": x}
            exp, _ = sp.video_pipeline_plain(dag, {**inputs, **sp.tap_feeds(
                dag, inputs, dict(zip(prog.states, states)), 4)})
            assert torch.equal(got, exp), ((h, w), r)


@pytest.mark.cuda
def test_engines_serve_through_the_prefetch_kernel(cuda_device):
    """FrameEngine (untiled, tiled) and VideoEngine at depth 2 launch the
    kernel and serve the plain version's pixels."""
    eng = FrameEngine(max_batch=3, max_pending=16, tile_shape=(40, 48),
                      prefetch_depth=2, device=cuda_device)
    reqs = [FrameRequest(rid=i, pipeline=["canny-m", "xcorr-m"][i % 2],
                         frames={"in": _frames(i, 1, *((50, 70) if i % 3
                                                       else (24, 32)))[0]})
            for i in range(8)]
    before = sp.stencil_pipeline.launches
    res = eng.run(reqs)
    assert sp.stencil_pipeline.launches > before
    for r in reqs:
        exp = sp.stencil_pipeline_plain(
            eng.cache.dag_for(r.pipeline),
            {"in": torch.as_tensor(r.frames["in"], device=cuda_device)})
        assert torch.equal(res[r.rid], exp)
    veng = VideoEngine(chunk=4, prefetch_depth=2, device=cuda_device)
    vid = _frames(6, 10, 40, 56)
    sid = veng.open_stream("tbackground-t", 40, 56)
    before = sp.stencil_pipeline.launches
    out = veng.run({sid: [{"in": f} for f in vid]})
    assert sp.stencil_pipeline.launches > before
    exp = algorithms.execute_reference_video(
        veng.cache.dag_for("tbackground-t"),
        {"in": torch.from_numpy(vid).to(cuda_device)})
    assert torch.equal(torch.stack(out[sid]), exp)


def _ulp(got, exp):
    """|got - exp| at its max, in ULP at the array's scale."""
    err = (got - exp).abs().max().item()
    return err / float(np.spacing(np.float32(exp.abs().max().item())))


def _broken_compiles(cache):
    def hook(label):
        raise RuntimeError(f"compile broken: {label}")
    cache.compile_hook = hook


@pytest.mark.cuda
@pytest.mark.parametrize("tile_shape", [(128, 128), (24, 40)])
def test_reference_rung_equals_kernel_bitwise(cuda_device, tile_shape):
    """Every compile broken: the reference rung serves each frame on the
    card, bit for bit what the strict engine's kernel serves."""
    reqs = [FrameRequest(rid=i, pipeline=NAMES[i % len(NAMES)],
                         frames={"in": _frames(70 + i, 1, 40, 72)[0]})
            for i in range(2 * len(NAMES))]
    strict = FrameEngine(max_batch=2, tile_shape=tile_shape,
                         device=cuda_device).run(reqs)
    eng = FrameEngine(max_batch=2, tile_shape=tile_shape,
                      device=cuda_device,
                      resilience=ResilienceConfig(
                          retry=RetryPolicy(max_attempts=1),
                          breaker_failures=1, breaker_reset_s=60.0))
    _broken_compiles(eng.cache)
    for r in reqs:
        assert eng.submit(FrameRequest(rid=r.rid, pipeline=r.pipeline,
                                       frames=r.frames)) is True
    done = {}
    while eng.pending:
        done.update({c.rid: c for c in eng.step()})
    for r in reqs:
        c = done[r.rid]
        assert c.rung == "reference" and c.output.device.type == "cuda"
        assert torch.equal(c.output, strict[r.rid]), r.pipeline
    assert eng.metrics.fallback_frames == len(reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("name,chunk", [("tmotion-t", 4),
                                        ("tbackground-t", 4),
                                        ("tinternal", 1)])
def test_state_from_history_resumes_compiled_stream(cuda_device, name,
                                                    chunk):
    """A blackout mid-stream: the reference rung rebuilds the frame
    rings from the host history, and the kernel resumes from them. Input
    producers' rings equal the strict stream's bit for bit; internal
    temporal producers' within 32 ULP; the whole stream within 32 ULP of
    the plain version's."""
    pipes = {name: _tinternal} if name == "tinternal" else None
    h, w = 37, 53
    vid = _frames(80, 6 * chunk, h, w)
    strict = VideoEngine(chunk=chunk, device=cuda_device,
                         cache=PlanCache(pipelines=pipes,
                                         device=cuda_device))
    eng = VideoEngine(chunk=chunk, device=cuda_device,
                      cache=PlanCache(pipelines=pipes, device=cuda_device),
                      resilience=ResilienceConfig(
                          retry=RetryPolicy(max_attempts=1),
                          breaker_failures=1, breaker_reset_s=0.0))
    a, b = strict.open_stream(name, h, w), eng.open_stream(name, h, w)
    dag = eng.cache.dag_for(name)
    inputs = set(dag.input_stages())
    outs, rungs = [], []
    for t in range(0, len(vid), chunk):
        if t == 2 * chunk:
            _broken_compiles(eng.cache)
            eng.cache.evict_executors()
        elif t == 4 * chunk:
            eng.cache.compile_hook = None
        for f in vid[t:t + chunk]:
            assert strict.submit(VideoFrame(a, {"in": f}))
            assert eng.submit(VideoFrame(b, {"in": f})) is True
        strict.step()
        got = eng.step()
        outs += [c.output for c in got]
        rungs += [c.rung for c in got]
        for p, ring in eng._sessions[b].state.items():
            want = strict._sessions[a].state[p]
            assert ring.device.type == "cuda" and ring.shape == want.shape
            if p in inputs:
                assert torch.equal(ring, want), (t, p)
            else:
                assert _ulp(ring, want) <= 32, (t, p)
    assert rungs == ["default"] * 2 * chunk + ["reference"] * 2 * chunk \
        + ["default"] * 2 * chunk
    exp = algorithms.execute_reference_video(
        dag, {"in": torch.from_numpy(vid).to(cuda_device)})
    assert _ulp(torch.stack(outs), exp) <= 32


@pytest.mark.cuda
@pytest.mark.parametrize("wedge", ["after_launch", "before_launch"])
def test_timed_out_k1_launch_leaves_next_rung_intact(cuda_device, wedge):
    """An attempt that launches K1 and wedges (or wedges, then launches
    after the ladder moved on) times out; the reference rung's output
    is returned, and the abandoned launch, run to its end, changes none
    of it. The attempt ran on its caller's card and stream."""
    sp._lib()                       # build the library outside the timer
    release, finished = threading.Event(), threading.Event()
    seen = {}

    class Wedged:
        def __init__(self, ex):
            self.ex = ex

        def __call__(self, inputs):
            seen["stream"] = torch.cuda.current_stream()
            if wedge == "before_launch":
                release.wait(10.0)
            out = self.ex(inputs)           # one K1 launch
            if wedge == "after_launch":
                release.wait(10.0)
            finished.set()
            return out

        def __getattr__(self, attr):
            return getattr(self.ex, attr)

    eng = FrameEngine(max_batch=2, tile_shape=(256, 256),
                      device=cuda_device,
                      resilience=ResilienceConfig(retry=RetryPolicy(
                          max_attempts=1, timeout_s=0.5)))
    eng.cache.executor_wrapper = Wedged
    frames = _frames(90, 2, 128, 160)
    for i in range(2):
        assert eng.submit(FrameRequest(rid=i, pipeline="harris-m",
                                       frames={"in": frames[i]})) is True
    side = torch.cuda.Stream()
    before = sp.stencil_pipeline.launches
    with torch.cuda.stream(side):
        done = eng.step()
    assert [c.rung for c in done] == ["reference"] * 2
    kept = [c.output.clone() for c in done]
    release.set()
    assert finished.wait(60.0)
    torch.cuda.synchronize()
    assert sp.stencil_pipeline.launches == before + 1
    assert seen["stream"] == side
    dag = eng.cache.dag_for("harris-m")
    for i, c in enumerate(done):
        assert torch.equal(c.output, kept[i])
        exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(
            frames[i]).to(cuda_device)})
        assert torch.equal(c.output, exp)


@pytest.mark.cuda
def test_chaos_executor_forwards_on_the_card(cuda_device):
    cache = PlanCache(device=cuda_device)
    install_chaos(cache, ChaosMonkey(seed=0))
    ex = cache.video_executor_for("tmotion-t", 37, 53, chunk=4)
    real = ex._ex
    for attr in ("smem_bytes", "plan", "chunk", "device", "dag",
                 "frame_state_bytes"):
        assert getattr(ex, attr) == getattr(real, attr), attr
    assert ex.device.type == "cuda" and ex.smem_bytes > 0
    x = torch.from_numpy(_frames(91, 4, 37, 53)).to(cuda_device)
    state = real.init_state()
    before = sp.stencil_pipeline.launches
    out, new = ex({"in": x}, state)
    want, want_new = real({"in": x}, state)
    torch.cuda.synchronize()
    assert sp.stencil_pipeline.launches == before + 2
    assert torch.equal(out, want)
    assert all(torch.equal(new[p], want_new[p]) for p in want_new)
    fx = cache.executor_for("unsharp-m", 37, 53, batch=2)
    assert fx.smem_bytes == fx._ex.smem_bytes and fx.plan is fx._ex.plan


@pytest.mark.cuda
@pytest.mark.parametrize("k", [(1, 1), (3, 3), (1, 5), (5, 1), (2, 4), (5, 5),
                               (7, 7), (4, 6), (9, 9)])
def test_conv2d_kernel_matches_plain_bitwise(cuda_device, k):
    """K2 over the JAX package's sweep shapes and 1080p: 0 ULP against
    conv2d_plain, one launch per call, and the kernel the filter and the
    row width call for (vector rows where w % 4 == 0)."""
    rng = np.random.RandomState(1)
    for h, w in [(8, 16), (20, 24), (13, 130), (9, 257), (1080, 1920)]:
        img = torch.from_numpy(rng.rand(h, w).astype(np.float32)).to(
            cuda_device)
        wts = torch.from_numpy(rng.randn(*k).astype(np.float32)).to(
            cuda_device)
        before = conv2d_stencil.conv2d.launches
        got = ops.conv2d(img, wts)
        torch.cuda.synchronize()
        assert conv2d_stencil.conv2d.launches == before + 1
        assert torch.equal(got, conv2d_stencil.conv2d_plain(img, wts))
        assert conv2d_stencil.conv2d.variant == (
            "tile" if not conv2d_stencil.uses_rows(*k)
            else "rows_vector" if w % 4 == 0 else "rows_scalar")


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 4])
@pytest.mark.parametrize("k", [(3, 3), (5, 5)])
def test_conv2d_launch_geometries_match_plain_bitwise(cuda_device, k, cols):
    """The 1080p filters at every band height and column count the
    launch-geometry sweep times, on a frame and on an unaligned view."""
    rng = np.random.RandomState(5)
    wts = torch.from_numpy(rng.randn(*k).astype(np.float32)).to(cuda_device)
    img = torch.from_numpy(rng.rand(135, 1924).astype(np.float32)).to(
        cuda_device)
    for x in (img[:, :1920].contiguous(), img.view(-1)[1:1 + 135 * 1920]
              .view(135, 1920)):
        exp = conv2d_stencil.conv2d_plain(x, wts)
        for band in (4, 8, 16, 32, 64):
            got = conv2d_stencil.conv2d.launch(x, wts, band, cols)
            assert torch.equal(got, exp), (band, cols)
            aligned = x.data_ptr() % 16 == 0
            assert conv2d_stencil.conv2d.variant == (
                "rows_vector" if cols > 1 and aligned else "rows_scalar")


def _swa_rings(b, s, chunk, rng):
    """(length, ring_start) with an empty ring and, where the batch has
    the rows, a one-slot ring, one shorter than a split, and a wrap that
    falls inside a split."""
    length = rng.randint(1, s + 1, size=b).astype(np.int32)
    start = rng.randint(0, s, size=b).astype(np.int32)
    length[0] = 0
    special = [(1, 0), (max(chunk // 2, 1), s - 1), (s, s - chunk // 3)]
    for row, (ln, st) in enumerate(special[:b - 1], start=1):
        length[row], start[row] = ln, st
    return length, start


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 4, 32, 16), (2, 8, 2, 64, 32),
                                   (3, 8, 1, 16, 64), (8, 4, 1, 256, 512),
                                   (8, 48, 8, 128, 4096)])
def test_swa_decode_kernel_matches_plain(cuda_device, shape):
    """K3 within swa_decode.RTOL / ATOL of its plain version, with an
    empty ring (zeros), a one-slot ring, one shorter than a split, a wrap
    inside a split and wrapped ones among the rows; the gemma3-1b and
    Mixtral-8x22b shapes run several splits."""
    b, hq, hkv, d, s = shape
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
               .to(cuda_device)
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits, chunk = swa.split_plan(b, hkv, hq // hkv, s, d, sms)
    ln, st = _swa_rings(b, s, chunk, rng)
    length = torch.from_numpy(ln).to(cuda_device)
    start = torch.from_numpy(st).to(cuda_device)
    before = swa.swa_decode.launches
    got = ops.swa_decode(q, k, v, length, start)
    torch.cuda.synchronize()
    assert swa.swa_decode.launches == before + 1
    assert swa.swa_decode.splits == splits
    assert s < 512 or splits > 1
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    exp = swa.swa_decode_plain(q, k, v, length, start)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, exp, rtol=swa.RTOL, atol=swa.ATOL)
    half = ops.swa_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                          length, start)
    torch.testing.assert_close(
        half, swa.swa_decode_plain(q.bfloat16().float(), k.bfloat16().float(),
                                   v.bfloat16().float(), length, start),
        rtol=swa.RTOL, atol=swa.ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 2, 64, 96), (4, 6, 1, 128, 512),
                                   (3, 16, 1, 256, 64), (2, 4, 1, 512, 64),
                                   (3, 4, 2, 30, 40)])
def test_swa_decode_split_counts_match_plain(cuda_device, shape):
    """Every split count from one to one position per split, query
    groups over one pass (G=16) and head dims of every lane share (64,
    128, 256, 512, and 30: the scalar path), with empty splits and
    wraps inside and on split boundaries."""
    b, hq, hkv, d, s = shape
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
               .to(cuda_device)
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    for want in (1, 2, 3, 8, s):
        chunk = -(-s // want)
        ln, st = _swa_rings(b, s, chunk, rng)
        length = torch.from_numpy(ln).to(cuda_device)
        start = torch.from_numpy(st).to(cuda_device)
        got = swa.swa_decode.launch(q, k, v, length, start, -(-s // chunk),
                                    chunk)
        exp = swa.swa_decode_plain(q, k, v, length, start)
        assert torch.isfinite(got).all() and torch.equal(
            got[0], torch.zeros_like(got[0]))
        torch.testing.assert_close(got, exp, rtol=swa.RTOL, atol=swa.ATOL)


@pytest.mark.cuda
def test_device_clock_graph_replay_agrees_with_the_profiler(cuda_device):
    """perf.timing.device_ms's fallback clock (a CUDA graph's replay,
    taken when the profiler keeps dropping the trace) agrees with the
    profiler's device time for conv2d at 1080p within 2x: the replay
    adds the gaps between launches, nothing else."""
    from repro_torch.perf.timing import device_ms
    rng = np.random.RandomState(6)
    img = torch.from_numpy(rng.rand(1080, 1920).astype(np.float32)).to(
        cuda_device)
    wts = torch.from_numpy(rng.randn(5, 5).astype(np.float32)).to(
        cuda_device)

    def fn():
        return conv2d_stencil.conv2d(img, wts)
    prof, by_name = device_ms(fn, 20)
    graph, by_graph = device_ms(fn, 20, attempts=0)
    assert list(by_graph) == ["cuda graph replay"]
    assert any("conv2d_rows" in name for name in by_name)
    assert prof / 2 < graph < prof * 2


@pytest.mark.cuda
def test_calibrated_peaks_are_below_the_data_sheet(cuda_device):
    """perf.measure.calibrate on the card: a 1 GiB device copy and an
    8192^3 float32 product with TF32 off give finite, positive peaks
    below the data sheet's (x1.05 for clock and rounding), and the TF32
    switch comes back as it was."""
    from repro_torch.perf import measure
    tf32 = torch.backends.cuda.matmul.allow_tf32
    peaks = measure.calibrate(cuda_device, reps=3)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    sheet = measure.datasheet_peaks(torch.cuda.get_device_name(0))
    for got, top in ((peaks.flops_per_s, sheet.flops_per_s),
                     (peaks.hbm_bytes_per_s, sheet.hbm_bytes_per_s)):
        assert np.isfinite(got) and 0 < got < 1.05 * top
    info = measure.card_info()
    assert info["device"] in info["nvidia_smi"]


@pytest.mark.cuda
def test_measure_executor_and_cost_at_1080p(cuda_device):
    """perf.measure on a 1080p program the cache builds: the timed
    stream launches the kernel once per call, its last output equals the
    plain version bit for bit, and the counted launch bytes exceed
    launch_work's minimum by the strips' and bands' halos."""
    from repro_torch.perf import measure
    cache = PlanCache(device=cuda_device)
    for depth in (1, 2):
        ex = cache.executor_for("canny-m", 1080, 1920, batch=4,
                                rows_per_step=8, prefetch_depth=depth)
        before = sp.stencil_pipeline.launches
        meas = measure.measure_executor(ex, 8, np.random.RandomState(0))
        assert sp.stencil_pipeline.launches - before == 2 + 2  # settle 2
        assert meas.frames == 8 and meas.fps > 0
        inputs, _, out = meas.last
        exp = sp.stencil_pipeline_plain(
            ex.dag, {"in": torch.from_numpy(inputs["in"]).to(cuda_device)})
        assert torch.equal(out, exp)
        cost = measure.executor_cost(ex)
        nbytes, ops = sp.launch_work(ex.program, 4)
        assert cost["flops"] == ops
        assert nbytes < cost["bytes_accessed"] < 1.5 * nbytes
    vex = cache.video_executor_for("tmotion-t", 1080, 1920, chunk=4,
                                   rows_per_step=8)
    meas = measure.measure_executor(vex, 8, np.random.RandomState(1))
    inputs, state, out = meas.last
    ins = {"in": torch.from_numpy(inputs["in"]).to(cuda_device)}
    exp, _ = sp.video_pipeline_plain(
        vex.dag, {**ins, **sp.tap_feeds(vex.dag, ins, state, 4)})
    assert torch.equal(out, exp)


@pytest.mark.cuda
def test_memtrace_rings_reconcile_with_the_launched_program(cuda_device):
    """A memtrace's shared-memory ring bytes are the launched program's
    bill less its output block and row tables:
    smem_bytes - (R * ncols + 2 * MAX_RINGS) * 4."""
    cache = PlanCache(device=cuda_device)
    for name, depth in (("harris-m", 1), ("harris-m", 2),
                        ("tdenoise-t", 1)):
        if name in VIDEO:
            ex = cache.video_executor_for(name, 1080, 1920, chunk=4,
                                          rows_per_step=8)
            x = torch.rand((4, 1080, 1920), device=cuda_device)
            ex({"in": x}, ex.init_state())
        else:
            ex = cache.executor_for(name, 1080, 1920, batch=4,
                                    rows_per_step=8, prefetch_depth=depth)
            ex({"in": torch.rand((4, 1080, 1920), device=cuda_device)})
        torch.cuda.synchronize()
        mt = cache.memtrace_for(name, 1920, 1080, rows_per_step=8,
                                prefetch_depth=depth)
        prog = ex.program
        ncols = int(prog.table[sp.H_NCOLS])
        assert mt["summary"]["smem_ring_bytes"] == prog.smem_bytes \
            - (8 * ncols + 2 * sp.MAX_RINGS) * 4
        assert mt["summary"]["prefetch_ring_bytes"] == prog.prefetch_bytes


@pytest.mark.cuda
def test_lm_decode_matches_forward_on_the_card(cuda_device):
    """gemma3-1b at full width (d 1152, vocab 262144) and 2 layers (one
    local, one global), float32 with TF32 off: decode_step over 40 tokens
    against forward, the JAX package's bound for it (rtol 2e-4, atol
    2e-4, tests/test_models.py:95-97)."""
    import dataclasses

    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=2,
                              layer_pattern="LG", dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    m = build_model(cfg, device=cuda_device, generator=gen)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                         device=cuda_device)
    full, _ = m.forward({"tokens": toks})
    caches = m.decode_init(2, 40)
    outs = [m.decode_step(caches, toks[:, t],
                          torch.full((2,), t, device=cuda_device))[0]
            for t in range(40)]
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "recurrentgemma-2b"])
def test_lm_engine_on_the_card_equals_the_cpu(cuda_device, name):
    """One Engine run on the card (its steps replayed as CUDA graphs) and
    the same run on the CPU (eager), float32, the same weights: equal
    greedy tokens."""
    import dataclasses

    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.serve import Engine, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_config(name)),
                              dtype="float32")
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, 5 + 9 * i),
                    max_new=12) for i in range(4)]
    got = Engine(card, n_slots=2, max_len=96).run(reqs)
    assert got == Engine(cpu, n_slots=2, max_len=96).run(reqs)


def _card_copy_of_state(state, model):
    """The training state ``state`` (on the CPU) moved to ``model``'s
    card: its parameters loaded, the optimizer's tensors copied."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])

    def move(x):
        return ({k: move(v) for k, v in x.items()} if isinstance(x, dict)
                else x.to(model.device, copy=True))
    return {"params": params, "opt": move(state["opt"])}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-1b-a400m"])
def test_lm_train_steps_on_the_card_equal_the_cpu(cuda_device, name):
    """Two float32 train steps (remat on, TF32 off) of a reduced model
    from one state on the card and on the CPU, the same TokenStream
    batches: loss and grad norm within rtol 1e-4, master copies and
    moments within rtol 1e-4 / atol 1e-6 but for at most 0.05% of the
    elements, those within Adam's step bound (4 x the summed learning
    rate): where a gradient is at rounding level its sign is the
    rounding's."""
    import dataclasses

    from repro_torch.data import TokenStream
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.train import OptConfig, make_train_state, \
        make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_config(name)),
                              dtype="float32", remat=True)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    cpu = build_model(cfg, device="cpu")
    cs = make_train_state(cpu, torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    ks = _card_copy_of_state(cs, card)
    data = TokenStream(cfg.vocab, batch=4, seq=64, seed=0)
    lr_sum = 0.0
    for _ in range(2):
        batch = data.next()
        _, mc = make_train_step(cpu, opt)(cs, batch)
        _, mk = make_train_step(card, opt)(ks, batch)
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(mk[k].cpu(), mc[k], rtol=1e-4,
                                       atol=0)
        lr_sum += float(mc["lr"])
    for key in ("master", "m", "v"):
        outliers, total = 0, 0
        for n, exp in cs["opt"][key].items():
            got = ks["opt"][key][n].cpu()
            err = (got - exp).abs()
            bad = err > 1e-6 + 1e-4 * exp.abs()
            total += exp.numel()
            if bad.any():
                assert key == "master" and float(err.max()) <= 4 * lr_sum, \
                    (key, n, float(err.max()))
                outliers += int(bad.sum())
        assert outliers <= 5e-4 * total, (key, outliers, total)


@pytest.mark.cuda
def test_lm_checkpoint_round_trips_on_the_card(cuda_device, tmp_path):
    """A bf16 training state on the card: an async save, the state
    changed in place at once, the writer joined, a restore into the live
    tensors: every leaf bit for bit as it was at the save."""
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.train import make_train_state
    model = build_model(reduced_config(get_config("gemma3-1b")),
                        device=cuda_device)
    state = make_train_state(model, torch.Generator(
        device=cuda_device).manual_seed(0))
    leaves = ckpt._flatten_with_paths(state)
    assert any(t.dtype == torch.bfloat16 for _, t in leaves)
    before = [t.detach().clone() for _, t in leaves]
    t = ckpt.save(str(tmp_path), 1, state, asynchronous=True)
    with torch.no_grad():
        for _, x in leaves:
            x.add_(1)
    t.join(timeout=120)
    assert not t.is_alive()
    ckpt.restore(str(tmp_path), state)
    for (p, x), b in zip(leaves, before):
        assert x.device.type == "cuda" and torch.equal(x, b), p


@pytest.mark.cuda
def test_decode_allocation_matches_the_dry_run_on_the_card(cuda_device):
    """gemma3-1b x decode_32k at full width and batch, one super-block
    deep: the card's allocation for the parameters, caches, tokens and
    pos is the dry run's ``arg_bytes`` within 1%, and a step's logits
    are finite."""
    import dataclasses
    import gc
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import build_model, get_config
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=6)
    cell = dryrun.lower_cell("gemma3-1b", "decode_32k",
                             make_card_mesh(cuda_device), "card", False,
                             cfg=cfg)
    b, s = SHAPES["decode_32k"]["batch"], SHAPES["decode_32k"]["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        model = build_model(cfg, device=cuda_device, generator=torch.Generator(
            device=cuda_device).manual_seed(0))
        caches = model.decode_init(b, s)
        tokens = torch.zeros((b,), dtype=torch.int32, device=cuda_device)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=cuda_device)
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - before
        assert abs(alloc - cell.arg_bytes) <= 0.01 * cell.arg_bytes
        logits, _ = model.decode_step(caches, tokens, pos)
        assert logits.shape == (b, cfg.vocab)
        assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_pipeline_forward_on_the_card_equals_the_cpu(cuda_device):
    """Three float32 super-blocks of a reduced gemma3-1b as stages, 5
    microbatches: on each device within 1e-5 of its own sequential
    forward (the JAX package's bound), and the card within 1e-5 of the
    output's scale (max |x|) of the CPU: the two devices sum their
    float32 products in other orders through 18 layers (1.4e-5 and
    1.8e-5 on outputs of scale ~6 at the first two card runs)."""
    import dataclasses
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_config("gemma3-1b")),
                              n_layers=18, dtype="float32")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(5, 2, 24)))
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    with torch.no_grad():
        for n, p in card.named_parameters():
            p.copy_(cpu.get_parameter(n))
    outs = {}
    for dev, model in (("cpu", cpu), (cuda_device, card)):
        seg = model.segments[0]
        w = len(seg.kinds)
        stages = [list(model.layers[i * w:(i + 1) * w])
                  for i in range(seg.n)]
        with torch.no_grad():
            emb = [model._embed_inputs({"tokens": t.to(dev)}) for t in toks]
            x = torch.stack([e[0] for e in emb])
            positions = emb[0][1]

            def apply(blocks, h):
                return model._superblock(blocks, h, positions, None)[0]
            mesh = compat_make_mesh((seg.n,), ("stage",), device=dev)
            got = pipeline_forward(stages, x, apply, mesh)
            seq = []
            for m in range(x.shape[0]):
                h = x[m]
                for blocks in stages:
                    h = apply(blocks, h)
                seq.append(h)
        assert seg.n == 3
        assert float((got - torch.stack(seq)).abs().max()) < 1e-5
        outs[str(dev)] = got.cpu()
    scale = float(outs["cpu"].abs().max())
    diff = float((outs[str(cuda_device)] - outs["cpu"]).abs().max())
    assert diff <= 1e-5 * scale, (diff, scale)


@pytest.mark.cuda
def test_distributed_cli_on_nccl_equals_the_plain_run(cuda_device, tmp_path,
                                                      capsys):
    """The training CLI on the card in a one-rank NCCL group: every loss
    and the final state bit for bit the run without the flag."""
    import json
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.train import make_train_state
    outs, states = [], []
    cfg = reduced_config(get_config("gemma3-1b"))
    for tag, extra in (("a", ["--distributed"]), ("b", [])):
        d = str(tmp_path / tag)
        assert train_cli.main(["--arch", "gemma3-1b", "--reduced",
                               "--steps", "3", "--batch", "2", "--seq",
                               "64", "--ckpt-every", "3", "--ckpt-dir", d,
                               *extra]) == 0
        outs.append(capsys.readouterr().out)
        model = build_model(cfg, device=cuda_device)
        template = make_train_state(model, torch.Generator(
            device=cuda_device).manual_seed(5))
        state, _, step = ckpt.restore(d, template)
        assert step == 3
        states.append({k: v.cpu() for k, v in
                       ckpt._flatten_with_paths(state)})
    assert "in a process group (nccl, world size 1)" in outs[0]
    losses = [json.loads([ln for ln in o.splitlines()
                          if ln.startswith("losses: ")][0][8:])
              for o in outs]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
