"""The CUDA kernels and the serving paths on the card.

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
from repro_torch.video import VideoEngine

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
