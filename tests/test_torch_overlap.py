"""Prefetch depth in the port: a change of I/O discipline, never of pixels.

The port's twin of ``tests/test_overlap.py``. At ``prefetch_depth``
d >= 2 the fused kernel copies every feed (input or history tap)
asynchronously d - 1 row groups ahead straight into its line ring, grown
by (d - 1) * R rows; the stage table and the math are the depth-1 ones.
So every executor and both engines must give the depth-1 result at any
depth, and match the JAX package's jnp oracles (``execute_reference`` /
``execute_reference_video``): bitwise first, else <= 32 ULP at the
array's scale (``tests/test_video.py``), the tolerance for XLA's FMA
contraction.

On the CPU the wrapper runs the plain version, so these tests hold the
plumbing — depth reaching every executor, cache keys, plan siblings, the
shared-memory bill and its limit. The grown rings themselves are held
bitwise as host C++ (``tests/test_torch_kernel_host.py``) and on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro_torch.core import algorithms
from repro_torch.core.codegen import compile_pipeline, prefetch_ring_bytes
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
from repro_torch.imaging.tiling import execute_tiled
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.video import VideoEngine, VideoFrame

RNG = np.random.RandomState(11)
IMAGE = sorted(algorithms.ALGORITHMS)
VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)
DEPTHS = [1, 2, 4]


@pytest.fixture(scope="module")
def cache():
    return PlanCache(device="cpu")


def assert_overlap_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def _oracle(name, img):
    dag = jax_algorithms.ALGORITHMS[name]()
    vals = jax_algorithms.execute_reference(dag, {"in": img})
    return np.asarray(vals[dag.output_stages()[0]])


def _video_oracle(name, vid):
    return np.asarray(jax_algorithms.execute_reference_video(
        jax_algorithms.VIDEO_ALGORITHMS[name](), {"in": vid}))


# ------------------------------------------------------------ equivalence
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", IMAGE)
def test_single_frame_overlap_matches_depth1(cache, name, depth, r):
    """Every spatial pipeline, h % R != 0 at R=8."""
    h, w = 21, 24
    img = RNG.rand(h, w).astype(np.float32)
    ex = cache.executor_for(name, h, w, rows_per_step=r,
                            prefetch_depth=depth)
    assert ex.prefetch_depth == ex.program.prefetch_depth == depth
    got = ex({"in": img})
    exp = cache.executor_for(name, h, w, rows_per_step=r)({"in": img})
    assert got.shape == (h, w) and torch.equal(got, exp)
    assert_overlap_equal(got, _oracle(name, img))


@pytest.mark.parametrize("name", ["canny-m", "unsharp-m"])
def test_r1_overlap_matches_depth1(cache, name):
    """R=1 at h=3: the depth beats the row groups of every band."""
    h, w = 3, 24
    img = RNG.rand(h, w).astype(np.float32)
    ex = cache.executor_for(name, h, w, rows_per_step=1, prefetch_depth=4)
    assert ex.program.grid_y == 1
    got = ex({"in": img})
    assert torch.equal(got, cache.executor_for(name, h, w,
                                               rows_per_step=1)({"in": img}))
    assert_overlap_equal(got, _oracle(name, img))


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("depth", DEPTHS)
def test_batched_overlap_matches_depth1(cache, depth, r):
    b, h, w = 3, 21, 24
    frames = RNG.rand(b, h, w).astype(np.float32)
    got = cache.executor_for("harris-s", h, w, batch=b, rows_per_step=r,
                             prefetch_depth=depth)({"in": frames})
    exp = cache.executor_for("harris-s", h, w, batch=b,
                             rows_per_step=r)({"in": frames})
    assert torch.equal(got, exp)
    for i in range(b):
        assert_overlap_equal(got[i], _oracle("harris-s", frames[i]))


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("depth", DEPTHS)
def test_tiled_overlap_matches_depth1(cache, depth, r):
    h, w = 50, 100
    img = RNG.rand(h, w).astype(np.float32)
    got = execute_tiled(cache, "canny-m", {"in": img}, 40, 48, batch=4,
                        rows_per_step=r, prefetch_depth=depth)
    exp = execute_tiled(cache, "canny-m", {"in": img}, 40, 48, batch=4,
                        rows_per_step=r)
    assert torch.equal(got, exp)
    assert_overlap_equal(got, _oracle("canny-m", img))


def _run_stream(ex, vid, chunk=None):
    state, outs = ex.init_state(), []
    step = chunk or 1
    for t in range(0, vid.shape[0], step):
        o, state = ex({"in": vid[t:t + step] if chunk else vid[t]}, state)
        outs.append(o.reshape(-1, *vid.shape[1:]))
    return torch.cat(outs), state


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", VIDEO)
def test_video_overlap_matches_depth1(cache, name, depth, r):
    """Single-frame and chunk-4 streams: output and frame-ring state
    equal the depth-1 executor's, and the output the video oracle."""
    t_frames, h, w = 12, 21, 24
    vid = RNG.rand(t_frames, h, w).astype(np.float32)
    exp = _video_oracle(name, vid)
    base, base_state = _run_stream(
        cache.video_executor_for(name, h, w, rows_per_step=r), vid)
    for chunk in (None, 4):
        ex = cache.video_executor_for(name, h, w, chunk=chunk,
                                      rows_per_step=r, prefetch_depth=depth)
        assert ex.prefetch_depth == depth
        got, state = _run_stream(ex, vid, chunk)
        assert torch.equal(got, base)
        assert state.keys() == base_state.keys()
        assert all(torch.equal(state[p], base_state[p]) for p in state)
        assert_overlap_equal(got, exp)


def _tinternal():
    p = Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], algorithms.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


@pytest.mark.parametrize("depth", [2, 4])
def test_internal_temporal_producer_overlap_matches_depth1(depth):
    """A frame output (internal temporal producer) at depth d: output and
    the rolled-in frame equal depth 1's at every step."""
    dag = _tinternal()
    h, w = 13, 24
    vid = RNG.rand(6, h, w).astype(np.float32)
    ex1 = sp.make_video_executor(dag, h, w, rows_per_step=8, device="cpu")
    exd = sp.make_video_executor(dag, h, w, rows_per_step=8,
                                 prefetch_depth=depth, device="cpu")
    assert exd.program.frame_outs == ("blur",)
    got, state = _run_stream(exd, vid)
    exp, exp_state = _run_stream(ex1, vid)
    assert torch.equal(got, exp)
    assert torch.equal(state["blur"], exp_state["blur"])


@pytest.mark.parametrize("depth", [2, 4])
def test_engines_serve_at_depth(depth):
    """FrameEngine (untiled and tiled) and VideoEngine at depth d serve
    what they serve at depth 1."""
    reqs = [FrameRequest(rid=i, pipeline=["canny-m", "xcorr-m"][i % 2],
                         frames={"in": RNG.rand(*((30, 40) if i % 3
                                                  else (16, 24)))
                                 .astype(np.float32)})
            for i in range(6)]
    for tile in ((64, 64), (24, 32)):
        runs = [FrameEngine(device="cpu", max_batch=2, rows_per_step=8,
                            tile_shape=tile, prefetch_depth=d).run(reqs)
                for d in (1, depth)]
        for r in reqs:
            assert torch.equal(runs[0][r.rid], runs[1][r.rid])
            assert_overlap_equal(runs[1][r.rid],
                                 _oracle(r.pipeline, r.frames["in"]))
    vid = RNG.rand(8, 13, 24).astype(np.float32)
    outs = []
    for d in (1, depth):
        eng = VideoEngine(device="cpu", chunk=4, rows_per_step=8,
                          prefetch_depth=d)
        sid = eng.open_stream("tdenoise-t", 13, 24)
        for f in vid:
            eng.submit(VideoFrame(sid, {"in": f}))
        done = []
        while eng.pending:
            done += eng.step()
        ex = eng.cache.video_executor_for("tdenoise-t", 13, 24, chunk=4,
                                          rows_per_step=8, prefetch_depth=d)
        assert ex.prefetch_depth == d
        outs.append(torch.stack([c.output for c in done]))
    assert torch.equal(outs[0], outs[1])
    assert_overlap_equal(outs[1], _video_oracle("tdenoise-t", vid))


# --------------------------------------------- plans, keys, bills, limits
def test_depth_sibling_derived_without_recompile():
    """A plan differing only in prefetch_depth is a dataclasses.replace
    of its resident sibling: same schedule/alloc objects, no second ILP
    solve, distinct cache identity and fingerprint."""
    c = PlanCache(device="cpu")
    p1 = c.plan_for("unsharp-m", 24, rows_per_step=8)
    solve_s = c.stats.plan_compile_s
    p2 = c.plan_for("unsharp-m", 24, rows_per_step=8, prefetch_depth=2)
    assert p2 is not p1
    assert (p1.prefetch_depth, p2.prefetch_depth) == (1, 2)
    assert p2.cache_key[:4] == p1.cache_key[:4] != p2.cache_key
    assert p2.schedule is p1.schedule and p2.alloc is p1.alloc
    assert c.stats.plan_compile_s - solve_s < solve_s
    assert p2.fingerprint() != p1.fingerprint()
    assert c.plan_for("unsharp-m", 24, rows_per_step=8,
                      prefetch_depth=2) is p2
    # an executor built from the sibling plan runs at its depth
    ex = c.executor_for("unsharp-m", 16, 24, rows_per_step=8,
                        prefetch_depth=2)
    assert ex.plan is p2 and ex.program.prefetch_depth == 2


def test_executor_keys_and_carries_depth(cache):
    e1 = cache.executor_for("harris-s", 16, 24, rows_per_step=8)
    e2 = cache.executor_for("harris-s", 16, 24, rows_per_step=8,
                            prefetch_depth=2)
    assert e1 is not e2
    assert (e1.prefetch_depth, e2.prefetch_depth) == (1, 2)
    assert cache.executor_for("harris-s", 16, 24, rows_per_step=8,
                              prefetch_depth=2) is e2
    # the grown feed rows are real shared memory: the deep executor takes
    # more, at the same strip
    assert e2.program.strip_w == e1.program.strip_w
    assert e2.smem_bytes == e1.smem_bytes + e2.program.prefetch_bytes
    assert e2.smem_bytes > e1.smem_bytes
    # the fused-kernel memo keys on depth too
    ops._PIPE_CACHE.clear()
    dag = cache.dag_for("harris-s")
    plan = compile_pipeline(dag, 24)
    b1 = ops.pipeline_smem_bytes(dag, 16, 24, plan=plan, device="cpu")
    b4 = ops.pipeline_smem_bytes(dag, 16, 24, plan=plan, prefetch_depth=4,
                                 device="cpu")
    assert b4 > b1 and ops._PIPE_CACHE.stats.misses == 2


def _ring_rows(prog):
    rings = prog.table[sp.HDR + sp.MAX_STAGES * sp.STAGE_INTS:]
    return [int(n) for n in rings[1:2 * int(prog.table[sp.H_NRINGS]):2]]


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", IMAGE + VIDEO)
def test_smem_bill_is_rings_plus_staging_per_feed(name, depth, r):
    """At depth d each feed ring (the input's live ring and each history
    tap's) holds max(d * R + sh - 1, the plan's lines) rows, every other
    ring its depth-1 rows, so smem(d) - smem(1, same strip) = the grown
    rows * pitch * 4: (d - 1) * R * pitch * 4 per feed ring where the
    plan's lines do not already cover them. No staging region, no output
    rings and no lane padding, unlike the TPU's prefetch_ring_bytes; and
    the default strip keeps depth 1's CTAs per SM."""
    dag = (algorithms.ALGORITHMS.get(name)
           or algorithms.VIDEO_ALGORITHMS[name])()
    plan = compile_pipeline(dag, 1920)
    bufs = plan.alloc.buffers
    prog = sp.build_program(dag, 1080, 1920, r, alloc_buffers=bufs,
                            prefetch_depth=depth)
    one = sp.build_program(dag, 1080, 1920, r, alloc_buffers=bufs,
                           strip_w=prog.strip_w)
    # the input's rings come first: its taps, oldest first, then its live
    # ring, which alone has plan lines to grow from
    n = dag.temporal_depths().get("in", 1)
    edges = dag.out_edges("in")
    reach = [max(e.sh for e in edges if e.st > j) for j in range(n - 1, 0, -1)]
    reach.append(max(e.sh for e in edges
                     if not dag.stages[e.consumer].is_output))
    lines = [0] * (n - 1) + [bufs["in"].n_lines_phys if "in" in bufs else 0]
    rows_d, rows_1 = _ring_rows(prog), _ring_rows(one)
    assert len(rows_d) == len(rows_1)
    for i, (sh, k) in enumerate(zip(reach, lines)):
        assert rows_1[i] == max(r + sh - 1, k)
        assert rows_d[i] == max(depth * r + sh - 1, k)
    assert rows_d[n:] == rows_1[n:]
    pitch, ncols = int(prog.table[sp.H_PITCH]), int(prog.table[sp.H_NCOLS])
    grown = (sum(rows_d) - sum(rows_1)) * pitch * 4
    assert prog.prefetch_bytes == grown
    assert prog.smem_bytes == one.smem_bytes + grown == 4 * (
        sum(rows_d) * pitch + r * ncols + 2 * sp.MAX_RINGS)
    if all(max(r + sh - 1, k) == r + sh - 1 for sh, k in zip(reach, lines)):
        assert grown == n * (depth - 1) * r * pitch * 4
    assert int(prog.table[sp.H_DEPTH]) == depth
    default = sp.build_program(dag, 1080, 1920, r, alloc_buffers=bufs)
    assert sp._resident(prog.smem_bytes) >= sp._resident(default.smem_bytes)
    if depth > 1:
        assert prefetch_ring_bytes(dag, r, depth, 1920) != grown


# the d=2 bills at 1080p, R=8, 240-column strips: the depth-1 bill plus
# R * pitch * 4 bytes per feed ring
DEPTH2_BILLS = {"canny-m": 93_664, "canny-s": 83_264, "harris-m": 62_464,
                "harris-s": 62_464, "denoise-m": 45_824,
                "unsharp-m": 45_824, "xcorr-m": 42_176,
                "tbackground-t": 147_648, "tdenoise-t": 85_344,
                "tunsharp-t": 72_864, "tmotion-t": 60_384}


@pytest.mark.parametrize("name", sorted(DEPTH2_BILLS))
def test_depth2_bill_at_1080p(name):
    """The d=2 bills at 240-column strips; where they would allow fewer
    CTAs per SM than depth 1's, the default strip narrows until they do
    not (canny-s, tdenoise-t, tbackground-t to 120 columns)."""
    dag = (algorithms.ALGORITHMS.get(name)
           or algorithms.VIDEO_ALGORITHMS[name])()
    bufs = compile_pipeline(dag, 1920).alloc.buffers
    prog = sp.build_program(dag, 1080, 1920, 8, alloc_buffers=bufs,
                            prefetch_depth=2, strip_w=240)
    assert prog.smem_bytes == DEPTH2_BILLS[name]
    one = sp.build_program(dag, 1080, 1920, 8, alloc_buffers=bufs)
    default = sp.build_program(dag, 1080, 1920, 8, alloc_buffers=bufs,
                               prefetch_depth=2)
    narrowed = sp._resident(prog.smem_bytes) < sp._resident(one.smem_bytes)
    assert narrowed == (name in ("canny-s", "tdenoise-t", "tbackground-t"))
    assert default.strip_w == (120 if narrowed else 240)
    assert sp._resident(default.smem_bytes) >= sp._resident(one.smem_bytes)


def test_depth_below_one_rejected():
    dag = algorithms.unsharp_m()
    for bad in (0, -1):
        with pytest.raises(ValueError, match="prefetch_depth"):
            sp.build_program(dag, 16, 24, 8, prefetch_depth=bad)
        with pytest.raises(ValueError, match="prefetch_depth"):
            sp.make_executor(dag, 16, 24, prefetch_depth=bad, device="cpu")
        with pytest.raises(ValueError, match="prefetch_depth"):
            sp.make_video_executor(algorithms.tmotion_t(), 16, 24,
                                   prefetch_depth=bad, device="cpu")


def test_staging_over_the_block_limit_rejected():
    """Deep grown rings pass the 227 KB block limit where depth 1 fits,
    even at the narrowest strip: tbackground-t (input + 7 taps, eight
    feed rings) at R=8, depth 64."""
    dag = algorithms.tbackground_t()
    sp.build_program(dag, 1080, 1920, 8, prefetch_depth=4)
    with pytest.raises(ValueError, match="shared memory"):
        sp.build_program(dag, 1080, 1920, 8, prefetch_depth=64)
    with pytest.raises(ValueError, match="shared memory"):
        sp.make_video_executor(dag, 1080, 1920, rows_per_step=8,
                               prefetch_depth=64, device="cpu")


def test_any_depth_accepted():
    """Depths are not limited to the TPU's {2, 4}: 3 and 9 run and give
    the depth-1 pixels."""
    dag = algorithms.canny_m()
    img = RNG.rand(21, 24).astype(np.float32)
    exp = sp.make_executor(dag, 21, 24, rows_per_step=8,
                           device="cpu")({"in": img})
    for d in (3, 9):
        ex = sp.make_executor(dag, 21, 24, rows_per_step=8,
                              prefetch_depth=d, device="cpu")
        assert torch.equal(ex({"in": img}), exp)
