"""The CUDA kernels, the serving paths and the LM stack on the card.

These tests need an NVIDIA GPU: on a machine without one they skip (the
kernel has no CPU mode; the CPU tests hold its plain version against the
JAX oracle). They import nothing of JAX, so they run where the port does:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bitwise for the stencil kernels (any prefetch depth, payload
and expression stages: the registered pipelines' bare forms and the fuzz
harness's random DAGs) and conv2d. They round every product and sum on
their own (``_rn`` intrinsics, built with ``-fmad=false``) in the plain
version's order, and the square root is correctly rounded like the plain
one's. The lowering cases of ``tests/test_torch_expr.py`` are bitwise
too, except sums, means, the library functions (exp, log, tanh, rsqrt,
sigmoid, erf, sin, cos, powf), a division by a number against the
card's eager version and a float32 ``torch.sqrt`` against the CPU's (4
ULP at the array's scale; ``core/expr.py`` says why). The registered
pipelines on NaN frames equal their plain version with NaN positions
equal and every other bit equal.
swa_decode sums its dot products in another order: rtol 2e-4, atol
2e-5. A program with an expression stage launches from a library of its
own, built by nvcc at its first use: the expression tests share one
parallel build wave (``expr_libraries``).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, expr, fuzz
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache, \
    execute_tiled, rows_per_step_for_tile
from repro_torch.kernels import _build, conv2d_stencil, expr_codegen, ops
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.kernels import swa_decode as swa
from repro_torch.kernels import stage_ahead, unorm8
from repro_torch.resilience import ResilienceConfig, RetryPolicy
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos
from repro_torch.video import VideoEngine, VideoFrame
from test_torch_expr import (CASES, CPU_SQRT, DIVIDES_BY_A_NUMBER, NAN_FNS,
                             NAN_FREE, NAN_SHAPES, TAPS, assert_bounded,
                             case_frames, case_pipeline, case_plain,
                             conv_pipeline, two_stage_pipeline)
from test_torch_nan import (FRAME_KINDS, NAN_PIPELINES,
                            assert_equal_nan_positions, nan_frames)

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


@pytest.fixture(scope="module")
def expr_libraries():
    """Every library the expression tests below launch from (one per
    program with an expression stage and instantiation), built in one
    parallel wave; {library: nvcc seconds} of those built here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    dags = [expr.bare_pipeline(f()) for f in (
        *algorithms.ALGORITHMS.values(), *algorithms.VIDEO_ALGORITHMS.values(),
        _generic, lambda: _generic(True))]
    dags += [fuzz.random_pipeline(seed, conv, temporal=t) for seed in range(8)
             for conv in (fuzz.bare_conv, algorithms.conv_fn)
             for t in (False, True)]
    dags += [case_pipeline(n) for n in CASES]
    dags += [case_pipeline(f"nan-{op}", NAN_FNS[op], NAN_SHAPES)
             for op in NAN_FNS]
    return sp.build_libraries([sp.build_program(g, 37, 53, 1,
                                                prefetch_depth=d)
                               for g in dags for d in (1, 2)])


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


def _launch_and_plain(dag, x, states_np, r, depth, dev):
    """(kernel output, plain output, program) of ``dag`` over frames
    ``x`` and frame-ring states at R = ``r`` and prefetch depth
    ``depth`` (the grown slots poisoned with NaN)."""
    h, w = x.shape[1:]
    prog = sp.build_program(dag, h, w, r, frames=x.shape[0],
                            prefetch_depth=depth, poison_prefetch=depth > 1)
    states = [torch.from_numpy(a).to(dev) for a in states_np]
    got = sp.stencil_pipeline(prog, [x], states)
    torch.cuda.synchronize()
    inputs = {"in": x}
    exp, _ = sp.video_pipeline_plain(dag, {
        **inputs, **sp.tap_feeds(dag, inputs, dict(zip(prog.states, states)),
                                 x.shape[0])})
    return got, exp, prog


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", NAMES + VIDEO + ["generic", "tgeneric"])
def test_bare_forms_match_payload_forms_bitwise(cuda_device, expr_libraries,
                                                name, depth):
    """Every computed stage through the expression body (each payload
    replaced by its eager function) equals the payload form and the plain
    version bit for bit, at a scalar and a float4 width, R = 1 and 8,
    batches and chunks of 4 over random frame-ring states; each bare
    launch takes the expression instantiation."""
    dag = (algorithms.ALGORITHMS.get(name) or algorithms.VIDEO_ALGORITHMS.get(
        name) or (lambda: _generic(name == "tgeneric")))()
    bare = expr.bare_pipeline(dag)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(23)
    for h, w in [(37, 53), (45, 1920)]:
        for r in (1, 8):
            x = torch.from_numpy(_frames(r, 4, h, w)).to(cuda_device)
            states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                      for p in sorted(depths, key=dag.topo_order.index)]
            got_p, exp, _ = _launch_and_plain(dag, x, states, r, depth,
                                              cuda_device)
            before = sp.stencil_pipeline.expr_launches
            got_b, exp_b, prog = _launch_and_plain(bare, x, states, r, depth,
                                                   cuda_device)
            assert sp.stencil_pipeline.expr_launches == before + 1
            assert prog.exprs and sp.blocks_per_sm(prog) >= 1
            where = (name, (h, w), r, depth)
            assert torch.equal(got_b, got_p), where
            assert torch.equal(got_b, exp_b) and torch.equal(exp_b, exp), \
                where


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("form", ["payload", "bare"])
def test_fuzz_dags_match_plain_bitwise(cuda_device, expr_libraries, form,
                                       temporal, depth):
    """The fuzz harness's random DAGs (seeds 0-7) through the expression
    body equal the plain version bit for bit."""
    conv = fuzz.bare_conv if form == "bare" else algorithms.conv_fn
    rng = np.random.RandomState(24)
    for seed in range(8):
        dag = fuzz.random_pipeline(seed, conv, temporal=temporal)
        depths = dag.temporal_depths()
        for h, w in [(37, 53), (45, 1920)]:
            for r in (1, 8):
                x = torch.from_numpy(_frames(seed, 4, h, w)).to(cuda_device)
                states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                          for p in sorted(depths, key=dag.topo_order.index)]
                got, exp, _ = _launch_and_plain(dag, x, states, r, depth,
                                                cuda_device)
                assert torch.equal(got, exp), (seed, (h, w), r, depth)


def _launch_case(dag, x, states, r, depth, dev):
    """(kernel output, program) of a lowering case's pipeline on the
    card; the launch takes the expression instantiation."""
    b, h, w = x.shape
    prog = sp.build_program(dag, h, w, r, frames=b, prefetch_depth=depth,
                            poison_prefetch=depth > 1)
    before = sp.stencil_pipeline.expr_launches
    got = sp.stencil_pipeline(prog, [torch.from_numpy(x).to(dev)],
                              [torch.from_numpy(a).to(dev) for a in states])
    torch.cuda.synchronize()
    assert sp.stencil_pipeline.expr_launches == before + 1
    return (got[0] if prog.frame_outs else got).cpu(), prog


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_lowering_cases_match_the_eager_function_on_the_card(
        cuda_device, expr_libraries, name):
    """Each lowering case of ``tests/test_torch_expr.py`` (together they
    take every instruction of the expression body) as stage "s" of a
    small pipeline, at a scalar and a float4 width, R = 1 and 8, depths 1
    and 2: equal to the eager function run on the card and on the CPU
    over the same frames, bit for bit but where the module docstring
    says."""
    fn, shapes, bounded = CASES[name]
    dag = case_pipeline(name)
    b = 1 if dag.temporal_depths() else 4
    for seed, (h, w) in enumerate([(37, 53), (45, 1920)]):
        x, states = case_frames(dag, b, h, w, seed)
        for r, depth in [(1, 1), (8, 1), (8, 2)]:
            got, prog = _launch_case(dag, x, states, r, depth, cuda_device)
            card = case_plain(dag, prog, torch.from_numpy(x).to(cuda_device),
                              [torch.from_numpy(a).to(cuda_device)
                               for a in states]).cpu()
            cpu = case_plain(dag, prog, torch.from_numpy(x),
                             [torch.from_numpy(a) for a in states])
            for exp, loose in ((card, name in DIVIDES_BY_A_NUMBER),
                               (cpu, name in CPU_SQRT)):
                if bounded or loose:
                    assert_bounded(got, exp)
                else:
                    assert torch.equal(got, exp), (name, (h, w), r, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(NAN_FNS))
def test_max_and_min_pass_a_nan_on_the_card(cuda_device, expr_libraries,
                                            op):
    dag = case_pipeline(f"nan-{op}", NAN_FNS[op], NAN_SHAPES)
    x, _ = case_frames(dag, 4, 45, 1920, 0)
    x.reshape(-1)[::31] = np.nan
    got, prog = _launch_case(dag, x, [], 8, 1, cuda_device)
    exp = case_plain(dag, prog, torch.from_numpy(x).to(cuda_device), [])
    if op in NAN_FREE:
        assert not bool(exp.isnan().any())
    else:
        assert 0 < int(exp.isnan().sum()) < exp.numel()
    torch.testing.assert_close(got, exp.cpu(), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("name", NAN_PIPELINES)
def test_nan_frames_match_plain_on_the_card(cuda_device, name, kind):
    """NaN frames through the payload bodies that take a max or a clamp
    (PTX max.NaN / min.NaN): single frames and batches of 4 at a scalar
    and a float4 width, R = 1 and 8, depths 1 and 2, and a frame tiled
    through ``execute_tiled``, equal to the plain version with NaN
    positions equal and every other bit equal (tests/test_torch_nan.py
    holds the plain version against the jnp oracle on the same kinds of
    frame)."""
    dag = algorithms.ALGORITHMS[name]()
    for seed, (b, h, w) in enumerate([(1, 37, 53), (4, 37, 53),
                                      (4, 45, 1920)]):
        x = torch.from_numpy(nan_frames(name, kind, b, h, w, seed)).to(
            cuda_device)
        exp = sp.stencil_pipeline_plain(dag, {"in": x}).cpu().numpy()
        for r in (1, 8):
            for depth in (1, 2):
                prog = sp.build_program(dag, h, w, r, frames=b,
                                        prefetch_depth=depth,
                                        poison_prefetch=depth > 1)
                before = sp.stencil_pipeline.launches
                got = sp.stencil_pipeline(prog, [x])
                torch.cuda.synchronize()
                assert sp.stencil_pipeline.launches == before + 1
                assert_equal_nan_positions(got.cpu().numpy(), exp)
    cache = PlanCache(device=cuda_device)
    x = nan_frames(name, kind, 1, 90, 130, 7)
    for depth in (1, 2):
        got = execute_tiled(cache, name, {"in": x[0]}, 40, 48, batch=4,
                            prefetch_depth=depth)
        exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
        assert_equal_nan_positions(got.cpu().numpy()[None], exp.numpy())


@pytest.mark.cuda
def test_a_second_executor_loads_the_cached_library(cuda_device,
                                                    monkeypatch):
    """An executor of a program with an expression stage builds its
    library at construction; another executor of the same program (or
    of one that differs only in its constants, or at another R) loads
    it, in this process or from the disk, without running nvcc."""
    dags = [conv_pipeline(t) for t in TAPS]
    sp.make_executor(dags[0], 37, 53, batch=2, device=cuda_device)

    def no_nvcc(lib):
        raise AssertionError(f"nvcc ran again for {lib.name}")
    monkeypatch.setattr(_build, "_compile", no_nvcc)
    x = torch.from_numpy(_frames(40, 2, 37, 53)).to(cuda_device)
    for forget in (False, True):
        if forget:                     # a new process: only the disk knows
            monkeypatch.setattr(_build, "_LIBS", {})
        for dag in dags:
            ex = sp.make_executor(dag, 37, 53, batch=2, rows_per_step=8,
                                  device=cuda_device)
            assert torch.equal(ex({"in": x}), sp.stencil_pipeline_plain(
                dag, {"in": x}))


@pytest.mark.cuda
def test_a_cold_user_pipeline_is_built_at_admission(cuda_device,
                                                    monkeypatch, tmp_path):
    """A user pipeline whose libraries are on no disk, served by a
    resilient FrameEngine whose attempts time out long before one nvcc
    build ends: ``submit`` builds both of its libraries (depth 1 and
    prefetch) when the cache first meets the pipeline, outside the
    fallback ladder, so the first batch is served on the primary rung
    and equals the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    dag = two_stage_pipeline()
    eng = FrameEngine(cache=PlanCache(pipelines={dag.name: lambda: dag},
                                      device=cuda_device),
                      max_batch=2, resilience=ResilienceConfig(
                          retry=RetryPolicy(max_attempts=1, timeout_s=2.0)))
    frames = _frames(43, 2, 37, 53)
    for i in range(2):
        assert eng.submit(FrameRequest(rid=i, pipeline=dag.name,
                                       frames={"in": frames[i]})) is True
    assert sorted(f.name for f in tmp_path.glob("lib*.so")) == sorted(
        f"lib{lib.name}.so" for lib in sp.dag_libraries(dag))
    assert eng.cache.stats.exec_compile_s > 2.0       # the nvcc wave
    done = eng.step()
    assert [c.rung for c in done] == ["default"] * 2
    assert eng.metrics.fallback_frames == 0
    for c, f in zip(done, frames):
        x = torch.from_numpy(f).to(cuda_device)
        assert torch.equal(c.output, sp.stencil_pipeline_plain(
            dag, {"in": x}))


@pytest.mark.cuda
def test_a_fragment_that_does_not_compile_raises(cuda_device, monkeypatch):
    """A generated body nvcc refuses: the executor's construction, the
    wrapper and a strict FrameEngine raise or fail with nvcc's output,
    and no kernel launches (no interpreter, no plain version in its
    place)."""
    monkeypatch.setitem(expr_codegen.RULES, "sub",
                        "__no_such_intrinsic({a}, {b})")
    monkeypatch.setattr(_build, "_FAILED", {})
    dag = two_stage_pipeline()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sp.make_executor(dag, 37, 53, device=cuda_device)
    kern = sp.stencil_pipeline
    before = kern.launches
    prog = sp.build_program(dag, 37, 53, 8)
    x = torch.from_numpy(_frames(41, 1, 37, 53)).to(cuda_device)
    with pytest.raises(RuntimeError, match="__no_such_intrinsic"):
        kern(prog, [x])
    eng = FrameEngine(cache=PlanCache(pipelines={dag.name: lambda: dag},
                                      device=cuda_device),
                      max_batch=1)
    res = eng.run([FrameRequest(rid=0, pipeline=dag.name,
                                frames={"in": _frames(42, 1, 37, 53)[0]})])
    assert not isinstance(res[0], torch.Tensor)
    assert "nvcc failed" in res[0].error
    assert kern.launches == before


@pytest.mark.cuda
def test_a_stage_that_does_not_lower_is_refused_on_the_card(cuda_device):
    p = Pipeline("opaque")
    x = p.input("in")
    y = p.stage("y", [(x, 1, 1)], lambda w: torch.atan(w["in"][..., 0, 0]))
    p.output("out", [(y, 1, 1)])
    with pytest.raises(ValueError, match="opaque/y: aten op aten.atan"):
        sp.make_executor(p.build(), 16, 32, device=cuda_device)


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


@pytest.fixture(params=["ahead", "inline"])
def hand_over_path(request, monkeypatch):
    """Every frame to the card by one way: staged ahead by the engine's
    stager (the host busy), or by ``torch.as_tensor`` (the host idle).
    Yields the stagers the engines made, held so no later tensor takes
    their ring's memory."""
    ahead = request.param == "ahead"
    monkeypatch.setattr(FrameEngine, "_host_busy", lambda self: ahead)
    made, real = [], stage_ahead.Stager

    def make(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(stage_ahead, "Stager", make)
    yield made
    assert bool(made) == ahead


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 53), (1080, 1920)])
def test_staged_batches_equal_the_pageable_path_bitwise(cuda_device, h, w,
                                                        hand_over_path):
    """Two successive batches handed over (the second partial and in
    float64, which the stager does not take) equal the executor on
    ``torch.as_tensor`` frames stacked with zero slots, and the first
    batch's outputs hold after the second batch's hand-over."""
    eng = FrameEngine(max_batch=4, tile_shape=(h, w), device=cuda_device)
    ex = eng.cache.executor_for(
        "harris-m", h, w, batch=4,
        rows_per_step=rows_per_step_for_tile(h, eng.rows_per_step))
    batches = [list(_frames(20, 4, h, w)),
               list(_frames(21, 3, h, w).astype(np.float64))]
    got = []
    for k, frames in enumerate(batches):
        for i, f in enumerate(frames):
            assert eng.submit(FrameRequest(rid=10 * k + i,
                                           pipeline="harris-m",
                                           frames={"in": f}))
        got += [r.output for r in eng.step()]
    exp = []
    for frames in batches:
        ts = [torch.as_tensor(f, dtype=torch.float32, device=cuda_device)
              for f in frames]
        ts += [torch.zeros((h, w), device=cuda_device)] * (4 - len(ts))
        ref = ex({"in": torch.stack(ts)})
        exp += [ref[i] for i in range(len(frames))]
    assert len(got) == 7
    assert all(torch.equal(g, e) for g, e in zip(got, exp))


def _storages(tensors) -> set:
    return {t.untyped_storage().data_ptr() for t in tensors}


def _rings(stagers) -> list:
    """The page-locked and device halves of each stager's ring (the
    arguments its finalizer frees them with)."""
    return [t for s in stagers for t in s._close.peek()[2][2:4]]


def _served_ahead(feng, frames):
    """``frames`` through ``feng``, the tiled one first so the ring is
    made at its size; every frame staged ahead (each span's
    ``pinned_bytes`` its ``h2d_bytes``). Returns the outputs by rid."""
    from repro_torch.obs import trace
    trace.clear()
    trace.enable()
    try:
        res = feng.run([FrameRequest(rid=i, pipeline="unsharp-m",
                                     frames={"in": f})
                        for i, f in enumerate(frames)])
        asm = [e for e in trace.events() if e.name == "engine.assemble"]
    finally:
        trace.disable()
        trace.clear()
    # the tiled frame, the batch of three and the lone fifth frame
    assert len(asm) == 3 and all(
        e.attrs["pinned_bytes"] == e.attrs["h2d_bytes"] > 0 for e in asm)
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("hand_over_path", ["ahead"], indirect=True)
def test_no_output_shares_storage_with_a_staging_buffer(cuda_device,
                                                         hand_over_path):
    """A tiled frame, a frame batch and a lone frame, every one staged
    ahead: no returned output lies in the stager's ring, while it is
    alive."""
    feng = FrameEngine(max_batch=3, tile_shape=(40, 48), device=cuda_device)
    res = _served_ahead(feng, [_frames(24, 1, 90, 130)[0]]
                        + list(_frames(23, 4, 36, 44)))
    assert len(hand_over_path) == 1
    outs = list(res.values())
    assert len(outs) == 5
    assert not _storages(outs) & _storages(_rings(hand_over_path))


def _u8(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w),
                                                dtype=np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,skew", [((256,), 0), ((4, 2160, 3840), 0),
                                        ((4, 2161, 3839), 0),
                                        ((3, 37, 53), 1), ((3, 37, 53), 4)])
def test_unorm8_decode_kernel_matches_its_twin(cuda_device, shape, skew):
    """Every byte value, and 4K batches with w % 4 == 0 and != 0, through
    the kernel bit for bit as the table indexed on the host; ``skew``
    bytes or floats off the allocation (scalar loads or stores)."""
    n = int(np.prod(shape))
    host = (np.arange(n) % 256).astype(np.uint8) if n == 256 \
        else _u8(n % 1000, 1, 1, n)[0, 0]
    flat = torch.from_numpy(np.concatenate([np.zeros(skew, np.uint8), host])
                            ).to(cuda_device)
    raw = flat[skew:].view(shape)
    out = torch.full((n + skew,), float("nan"), device=cuda_device)
    before = unorm8.decode.launches
    got = unorm8.decode(raw, out[skew:].view(shape))
    torch.cuda.synchronize()
    assert unorm8.decode.launches == before + 1
    want = torch.from_numpy(unorm8.TABLE[host.reshape(shape)])
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, unorm8.decode_plain(raw))
    assert out[:skew].isnan().all()


@pytest.mark.cuda
def test_unorm8_4k_batches_equal_the_reference(cuda_device, hand_over_path):
    """Four 3840x2160 uint8 frames a batch through a unorm8 engine, by
    either hand-over, each output bit for bit the plain version on the
    decoded frame; the decode ran on the card, a byte a pixel crossed."""
    from repro_torch.obs import trace
    h, w = 2160, 3840
    eng = FrameEngine(max_batch=4, tile_shape=(h, w), device=cuda_device,
                      pixels="unorm8")
    frames = _u8(31, 4, h, w)
    before = unorm8.decode.launches
    trace.clear()
    trace.enable()
    try:
        for name in ("canny-m", "xcorr-m"):
            for i, f in enumerate(frames):
                assert eng.submit(FrameRequest(rid=i, pipeline=name,
                                               frames={"in": f}))
            res = eng.step()
            assert [r.rid for r in res] == [0, 1, 2, 3]
            for f, r in zip(frames, res):
                x = torch.from_numpy(unorm8.TABLE[f]).to(cuda_device)
                exp = sp.stencil_pipeline_plain(eng.cache.dag_for(name),
                                                {"in": x})
                assert torch.equal(r.output, exp), name
        spans = trace.events()
    finally:
        trace.disable()
        trace.clear()
    assert unorm8.decode.launches == before + 2
    asm = [e for e in spans if e.name == "engine.assemble"]
    assert [e.attrs["h2d_bytes"] for e in asm] == [4 * h * w] * 2
    dec = [e for e in spans if e.name == "engine.unorm8"]
    assert [(e.parent, e.attrs["pixels"]) for e in dec] == \
        [("engine.assemble", 4 * h * w)] * 2
    assert all(s.slot_bytes == h * w for s in hand_over_path)


@pytest.mark.cuda
@pytest.mark.parametrize("hand_over_path", ["ahead"], indirect=True)
def test_no_unorm8_output_shares_storage_with_a_staging_buffer(
        cuda_device, hand_over_path):
    """A tiled unorm8 frame, a batch and a lone frame, every one staged
    ahead: no output lies in the stager's ring."""
    feng = FrameEngine(max_batch=3, tile_shape=(40, 48), device=cuda_device,
                       pixels="unorm8")
    frames = [_u8(26, 1, 90, 130)[0]] + list(_u8(25, 4, 36, 44))
    res = _served_ahead(feng, frames)
    assert len(hand_over_path) == 1
    outs = [res[i] for i in range(len(frames))]
    assert not _storages(outs) & _storages(_rings(hand_over_path))
    for f, out in zip(frames, outs):
        x = torch.from_numpy(unorm8.TABLE[f]).to(cuda_device)
        assert torch.equal(out, sp.stencil_pipeline_plain(
            feng.cache.dag_for("unsharp-m"), {"in": x}))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4, 1])
def test_unorm8_video_4k_streams_equal_the_reference(cuda_device, chunk):
    """Two interleaved 3840x2160 uint8 streams a pipeline through a unorm8
    ``VideoEngine``, in chunks of 4 or frame by frame: every output bit
    for bit the plain version over the decoded stream; one
    ``engine.unorm8`` span inside each hand-over, with the decode's one
    launch, and a byte a pixel across."""
    from repro_torch.obs import trace
    from repro_torch.video import CompletedVideoFrame
    h, w, n = 2160, 3840, 8
    eng = VideoEngine(chunk=chunk, device=cuda_device, pixels="unorm8")
    streams = {}
    for i, name in enumerate(("tbackground-t", "tmotion-t")):
        for j in range(2):
            streams[eng.open_stream(name, h, w)] = (
                name, _u8(40 + 2 * i + j, n, h, w))
    done = {sid: [] for sid in streams}
    before = unorm8.decode.launches
    trace.clear()
    trace.enable()
    try:
        for t in range(0, n, chunk):
            for sid, (_, vid) in streams.items():
                for f in vid[t:t + chunk]:
                    assert eng.submit(VideoFrame(sid, {"in": f})) is True
            while eng.pending:
                for c in eng.step():
                    assert isinstance(c, CompletedVideoFrame), c
                    done[c.stream].append(c.output)
        spans = trace.events()
    finally:
        trace.disable()
        trace.clear()
    hand_overs = len(streams) * n // chunk
    assert unorm8.decode.launches == before + hand_overs
    asm = [e for e in spans if e.name == "engine.assemble"]
    assert [e.attrs["h2d_bytes"] for e in asm] == [chunk * h * w] * \
        hand_overs
    dec = [e for e in spans if e.name == "engine.unorm8"]
    assert [(e.parent, e.attrs["n_frames"], e.attrs["pixels"])
            for e in dec] == [("engine.assemble", chunk, chunk * h * w)] * \
        hand_overs
    for sid, (name, vid) in streams.items():
        dag = eng.cache.dag_for(name)
        x = {"in": torch.from_numpy(unorm8.TABLE[vid]).to(cuda_device)}
        zero = sp.init_frame_state(dag.temporal_depths(), h, w, cuda_device)
        exp, _ = sp.video_pipeline_plain(
            dag, {**x, **sp.tap_feeds(dag, x, zero, n)})
        assert torch.equal(torch.stack(done[sid]), exp), name


@pytest.fixture
def busy_host(monkeypatch):
    """Every admission staging ahead, as while the host is busy."""
    monkeypatch.setattr(FrameEngine, "_host_busy", lambda self: True)


def _settled(stager, held):
    """Wait until ``stager`` has no ticket waiting and ``held`` slots
    held, then for its team to finish the frames in its hands (at most
    two, each well under a millisecond): every frame admitted is issued."""
    t0 = time.perf_counter()
    while stager.counts() != (0, held):
        assert time.perf_counter() - t0 < 10, stager.counts()
        time.sleep(0.001)
    time.sleep(0.05)


def _inline(pixels, h, w, name, batches, tile_shape=None):
    """Outputs of an engine that stages nothing ahead, batch by batch."""
    eng = FrameEngine(max_batch=4, tile_shape=tile_shape or (h, w),
                      device="cuda", pixels=pixels)
    eng._stages_ahead = lambda: False
    out = []
    for k, frames in enumerate(batches):
        for i, f in enumerate(frames):
            assert eng.submit(FrameRequest(rid=10 * k + i, pipeline=name,
                                           frames={"in": f}))
        out += [r.output for r in eng.step()]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pixels,h,w", [("float32", 1080, 1920),
                                        ("unorm8", 2160, 3840)])
def test_frames_staged_ahead_equal_the_inline_path(cuda_device, busy_host,
                                                   pixels, h, w):
    """A full and a partial batch, their frames staged by the stager
    before the hand-over (``pinned_bytes`` and ``ahead_bytes`` both the
    span's ``h2d_bytes``), bit for bit the outputs of an engine that
    stages inline; a unorm8 batch is decoded once, inside
    ``engine.assemble``."""
    from repro_torch.obs import trace
    make = _frames if pixels == "float32" else _u8
    batches = [list(make(40, 4, h, w)), list(make(41, 3, h, w))]
    eng = FrameEngine(max_batch=4, tile_shape=(h, w), device=cuda_device,
                      pixels=pixels)
    before = unorm8.decode.launches
    got = []
    trace.clear()
    trace.enable()
    try:
        for k, frames in enumerate(batches):
            for i, f in enumerate(frames):
                assert eng.submit(FrameRequest(rid=10 * k + i,
                                               pipeline="canny-m",
                                               frames={"in": f}))
            assert isinstance(eng._stager, stage_ahead.Stager)
            _settled(eng._stager, len(frames))
            got += [r.output for r in eng.step()]
        spans = trace.events()
    finally:
        trace.disable()
        trace.clear()
    launches = unorm8.decode.launches - before
    want = _inline(pixels, h, w, "canny-m", batches)
    assert len(got) == 7 and all(torch.equal(g, e)
                                 for g, e in zip(got, want))
    asm = [e for e in spans if e.name == "engine.assemble"]
    item = 4 if pixels == "float32" else 1
    assert [(e.attrs["h2d_bytes"], e.attrs["pinned_bytes"],
             e.attrs["ahead_bytes"]) for e in asm] == \
        [(n * h * w * item,) * 3 for n in (4, 3)]
    if pixels == "unorm8":
        dec = [e for e in spans if e.name == "engine.unorm8"]
        assert [e.parent for e in dec] == ["engine.assemble"] * 2
        assert launches == 2
    assert eng._stager.counts() == (0, 0)


@pytest.mark.cuda
def test_tiled_frames_staged_ahead_equal_the_inline_path(cuda_device,
                                                         busy_host):
    """1080p frames served through 128x128 tiles: a batch of three staged
    ahead (its span's ``pinned_bytes`` and ``ahead_bytes`` its
    ``h2d_bytes``) and then claimed by the tiled rung's hand-over, bit for
    bit the outputs of an engine that hands them over inline."""
    from repro_torch.obs import trace
    h, w = 1080, 1920
    frames = list(_frames(44, 3, h, w))
    eng = FrameEngine(max_batch=4, tile_shape=(128, 128), device=cuda_device)
    trace.clear()
    trace.enable()
    try:
        for i, f in enumerate(frames):
            assert eng.submit(FrameRequest(rid=i, pipeline="harris-m",
                                           frames={"in": f}))
        assert eng._stager.slot_bytes == 4 * h * w
        _settled(eng._stager, len(frames))
        got = [r.output for r in eng.step()]
        spans = trace.events()
    finally:
        trace.disable()
        trace.clear()
    want = _inline("float32", h, w, "harris-m", [frames],
                   tile_shape=(128, 128))
    assert len(got) == 3 and all(torch.equal(g, e)
                                 for g, e in zip(got, want))
    (asm,) = [e for e in spans if e.name == "engine.assemble"]
    assert (asm.attrs["h2d_bytes"], asm.attrs["pinned_bytes"],
            asm.attrs["ahead_bytes"]) == (3 * 4 * h * w,) * 3
    assert eng._stager.counts() == (0, 0)


def _stress(stager, frames, batch, cycles):
    """``frames`` through ``stager`` in batches of ``batch``: each batch
    claimed behind a sleep on the current stream, then released, with no
    host synchronise until the end. Returns the outputs (a frame taken
    back copied in as the hand-over would) and the claims' results."""
    h, w = frames[0].shape
    outs = torch.full((len(frames), h, w), float("nan"), device="cuda")
    tickets = [stager.put(f, stage_ahead.layout(f, torch.float32))
               for f in frames]
    found = []
    for b in range(0, len(frames), batch):
        ids = tickets[b:b + batch]
        torch.cuda._sleep(cycles)
        got = stager.claim(ids, [outs[b + i] for i in range(len(ids))])
        for i, st in enumerate(got):
            if st == stage_ahead.TAKEN:
                outs[b + i].copy_(torch.from_numpy(frames[b + i]))
        found += got
        stager.release(ids)
    torch.cuda.synchronize()
    return outs, found


@pytest.mark.cuda
@pytest.mark.parametrize("slots,batch,n,h,w", [(2, 1, 40, 1080, 1920),
                                               (8, 4, 200, 540, 960)],
                         ids=["pinned-slot", "device-slot"])
def test_a_slot_is_rewritten_only_after_its_copies(cuda_device, slots,
                                                   batch, n, h, w):
    """Each gather queued behind a ~1 ms sleep, so a slot's copy to the
    card and its gather run late: a page-locked slot rewritten before its
    copy to the card (a ring of 2, lone frames), or a device slot before
    its gather (a ring of 8, batches of 4, 200 frames), would hand a
    later frame's pixels to an earlier one."""
    rng = np.random.default_rng(n)
    frames = [rng.random((h, w), dtype=np.float32) for _ in range(n)]
    st = stage_ahead.Stager(cuda_device, slots, 4 * h * w)
    outs, found = _stress(st, frames, batch, int(2e6))
    assert found.count(stage_ahead.TAKEN) < n
    for i, f in enumerate(frames):
        assert torch.equal(outs[i].cpu(), torch.from_numpy(f)), i
    assert st.counts() == (0, 0)
    st.close()


@pytest.mark.cuda
def test_two_hundred_frames_through_a_ring_of_eight(cuda_device, busy_host):
    """200 frames, 50 batches of 4, through the engine's ring of 8, every
    output equal to the executor on the frames stacked by
    ``torch.as_tensor``."""
    h, w = 270, 480
    frames = _frames(42, 200, h, w)
    eng = FrameEngine(max_batch=4, tile_shape=(h, w), device=cuda_device)
    res = eng.run([FrameRequest(rid=i, pipeline="harris-m",
                                frames={"in": frames[i]})
                   for i in range(200)])
    assert eng._stager is not None and eng._stager.slots == 8
    ex = eng.cache.executor_for(
        "harris-m", h, w, batch=4,
        rows_per_step=rows_per_step_for_tile(h, eng.rows_per_step))
    for b in range(50):
        ref = ex({"in": torch.as_tensor(frames[4 * b:4 * b + 4],
                                        device=cuda_device)})
        for i in range(4):
            assert torch.equal(res[4 * b + i], ref[i]), 4 * b + i
    assert eng._stager.counts() == (0, 0) and eng._ahead == {}


@pytest.mark.cuda
def test_the_stagers_threads_end_with_the_engine(cuda_device, busy_host):
    """The stager's threads are the process's own: none is left once the
    engine is collected; frames on the card never make a stager."""
    import gc
    import os

    def threads():
        return len(os.listdir("/proc/self/task"))

    def serve(frames):
        eng = FrameEngine(max_batch=2, tile_shape=(64, 96),
                          device=cuda_device)
        eng.run([FrameRequest(rid=i, pipeline="unsharp-m",
                              frames={"in": f})
                 for i, f in enumerate(frames)])
        return eng
    host = list(_frames(43, 4, 64, 96))
    serve(host)                       # torch's own threads start here
    gc.collect()
    before = threads()
    eng = serve(host)
    assert eng._stager is not None
    assert threads() >= before + eng._stager.threads
    del eng
    gc.collect()
    assert threads() <= before
    resident = serve([torch.from_numpy(f).to(cuda_device) for f in host])
    assert resident._stager is None


# FrameEngine's lookahead: a step launches the next batch, then waits for
# the oldest in flight (an event, not the stream) and returns it.
LOOKAHEAD_BURST = [("canny-m", 4, (270, 480)), ("xcorr-m", 3, (270, 480)),
                   ("canny-m", 4, (136, 240)), ("harris-m", 4, (270, 480)),
                   ("xcorr-m", 2, (136, 240)), ("canny-m", 2, (270, 480))]


def _burst(pixels, device=None, spec=LOOKAHEAD_BURST, seed=50):
    """Requests of ``spec`` ((pipeline, frames, (h, w)) in submission
    order): host float32 or unorm8 frames, or float32 frames on
    ``device``."""
    reqs = []
    for k, (pipe, n, (h, w)) in enumerate(spec):
        fs = _u8(seed + k, n, h, w) if pixels == "unorm8" \
            else _frames(seed + k, n, h, w)
        for f in fs:
            if device is not None:
                f = torch.from_numpy(f).to(device)
            reqs.append(FrameRequest(rid=len(reqs), pipeline=pipe,
                                     frames={"in": f}))
    return reqs


def _stepped(eng, reqs):
    """Submit ``reqs``, step until idle: the results in the order
    returned and ``pending`` after each step."""
    for r in reqs:
        assert eng.submit(r) is True
    out, pending = [], []
    while res := eng.step():
        out += res
        pending.append(eng.pending)
    return out, pending


def _lookahead_against_synchronous(pixels, reqs, device):
    eng = FrameEngine(max_batch=4, tile_shape=(270, 480), device=device,
                      pixels=pixels)
    assert eng._lookahead
    sync = FrameEngine(max_batch=4, tile_shape=(270, 480), device=device,
                       pixels=pixels)
    sync._lookahead = False
    got, pending = _stepped(eng, reqs)
    want, _ = _stepped(sync, reqs)
    assert [c.rid for c in got] == [c.rid for c in want]
    for p in {r.pipeline for r in reqs}:
        assert [c.rid for c in got if c.pipeline == p] == \
            [r.rid for r in reqs if r.pipeline == p]
    for g, w in zip(got, want):
        assert torch.equal(g.output, w.output), g.rid
    assert pending[-1] == 0 and len(pending) == 6
    assert pending[0] == len(reqs) - 4 and not eng._inflight
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("pixels", ["float32", "unorm8"])
def test_the_lookahead_equals_a_synchronous_engine_bitwise(cuda_device,
                                                            hand_over_path,
                                                            pixels):
    """A burst of three pipelines at two shapes, host frames by either
    hand-over: every output bit for bit a synchronous engine's, every
    pipeline's frames back in submission order, ``pending`` counting
    the batch in flight."""
    eng = _lookahead_against_synchronous(pixels, _burst(pixels),
                                         cuda_device)
    if eng._stager is not None:
        assert eng._stager.counts() == (0, 0) and eng._ahead == {}


@pytest.mark.cuda
def test_the_lookahead_on_frames_on_the_card(cuda_device):
    """The same burst with frames already on the card."""
    eng = _lookahead_against_synchronous(
        "float32", _burst("float32", cuda_device), cuda_device)
    assert eng._stager is None
    again = _burst("float32", cuda_device, seed=60)
    res = eng.run(again)
    assert sorted(res) == [r.rid for r in again] and eng.pending == 0


class _Slow:
    """An executor whose batches each start behind ``cycles`` of
    ``torch.cuda._sleep`` on the current stream."""

    def __init__(self, ex, cycles):
        self.ex, self.cycles = ex, cycles
        self.smem_bytes = ex.smem_bytes

    def __call__(self, inputs):
        torch.cuda._sleep(self.cycles)
        return self.ex(inputs)


@pytest.mark.cuda
def test_every_output_is_complete_when_returned(cuda_device):
    """Each batch behind ~20 ms of sleep on the card: when ``step()``
    returns, the returned batch's event has completed with no
    synchronise by the caller, and the batch launched ahead's has not
    (the step did not wait for it)."""
    eng = FrameEngine(max_batch=4, tile_shape=(270, 480),
                      device=cuda_device)
    handed_over, record = eng._handed_over, eng._record
    events = []

    def slow(*a):
        ex, inputs = handed_over(*a)
        return _Slow(ex, int(3e7)), inputs

    def logged():
        events.append(record())
        return events[-1]
    eng._handed_over, eng._record = slow, logged
    reqs = _burst("float32", spec=[("canny-m", 4, (270, 480)),
                                   ("xcorr-m", 4, (270, 480)),
                                   ("harris-m", 4, (270, 480))])
    for r in reqs:
        assert eng.submit(r)
    returned, got = 0, []
    while res := eng.step():
        assert events[returned].query()
        if len(events) > returned + 1:
            assert not events[returned + 1].query()
        returned += 1
        assert [c.rid for c in res] == list(range(4 * returned - 4,
                                                  4 * returned))
        got += res
    assert returned == 3 and len(events) == 3
    assert len({id(e) for e in events}) == 2     # reused
    for c in got:
        assert torch.equal(c.output, _plain_out(eng, reqs[c.rid]))


def _plain_out(eng, req):
    return sp.stencil_pipeline_plain(
        eng.cache.dag_for(req.pipeline),
        {"in": torch.as_tensor(req.frames["in"], device=eng.device)})


@pytest.mark.cuda
def test_a_launch_that_raises_ahead_fails_its_batch_only(cuda_device):
    """The batch launched ahead raises at its launch: its frames come
    back as FailedFrame results right after the batch in flight's; the
    batches before and after it are served."""
    eng = FrameEngine(max_batch=4, tile_shape=(270, 480),
                      device=cuda_device)
    handed_over = eng._handed_over

    class Broken:
        smem_bytes = 0

        def __call__(self, inputs):
            raise RuntimeError("launch failed")

    def breaking(name, *a):
        ex, inputs = handed_over(name, *a)
        return (Broken() if name == "xcorr-m" else ex), inputs
    eng._handed_over = breaking
    reqs = _burst("float32", spec=[("canny-m", 4, (270, 480)),
                                   ("xcorr-m", 4, (270, 480)),
                                   ("harris-m", 4, (270, 480))])
    got, _ = _stepped(eng, reqs)
    assert [(c.rid, type(c).__name__) for c in got] == \
        [(i, "CompletedFrame") for i in range(4)] \
        + [(i, "FailedFrame") for i in range(4, 8)] \
        + [(i, "CompletedFrame") for i in range(8, 12)]
    assert all("launch failed" in c.error for c in got[4:8])
    for c in got[:4] + got[8:]:
        assert torch.equal(c.output, _plain_out(eng, reqs[c.rid]))
    assert eng.pending == 0 and eng.metrics.frames_failed == 4


@pytest.mark.cuda
def test_two_batches_in_flight_leave_the_ring_its_slots(cuda_device,
                                                        busy_host):
    """Three batches of host frames staged ahead: while two batches are
    in flight (the step waits for the older), the ring's slots are held
    by the queued batch's frames only, so at least ``max_batch`` of its
    ``2 * max_batch`` slots are free or being refilled."""
    eng = FrameEngine(max_batch=4, tile_shape=(270, 480),
                      device=cuda_device)
    wait, seen = eng._wait, []

    def counted(b):
        if len(eng._inflight) == 2:
            seen.append(eng._stager.counts())
        wait(b)
    eng._wait = counted
    reqs = _burst("float32", spec=[("canny-m", 4, (270, 480)),
                                   ("xcorr-m", 4, (270, 480)),
                                   ("harris-m", 4, (270, 480))])
    got, _ = _stepped(eng, reqs)
    assert [c.rid for c in got] == list(range(12))
    assert eng._stager.slots == 8 and len(seen) == 2
    assert all(eng._stager.slots - held >= 4 for _, held in seen)
    assert eng._stager.counts() == (0, 0) and eng._ahead == {}


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
    _build.load("stencil_pipeline")   # build it outside the timer
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
def test_conv2d_and_swa_decode_on_nan_inputs(cuda_device):
    """The NaN audit of tests/test_torch_nan_audit.py on the card: conv2d
    passes a NaN input pixel on as its plain version does (NaN positions
    equal, every other bit equal); swa_decode gives NaN for the group of
    a NaN in a valid K row, as its plain version does, and stays finite
    for a NaN in V at a masked slot, where the plain version and the
    reference give NaN (ROADMAP.md C.3)."""
    rng = np.random.RandomState(32)
    for k in ((3, 3), (5, 5), (9, 9)):
        img = rng.rand(45, 1920).astype(np.float32)
        img[7, 9] = img[0, 3] = img[12, 0] = img[15, 1919] = np.nan
        img = torch.from_numpy(img).to(cuda_device)
        wts = torch.from_numpy(rng.randn(*k).astype(np.float32)).to(
            cuda_device)
        exp = conv2d_stencil.conv2d_plain(img, wts)
        assert_equal_nan_positions(ops.conv2d(img, wts).cpu().numpy(),
                                   exp.cpu().numpy())
    b, hq, hkv, d, s = 3, 8, 2, 32, 48
    q, kk, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
                .to(cuda_device)
                for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    length = torch.tensor([s, s // 2 + 3, 9], dtype=torch.int32,
                          device=cuda_device)
    start = torch.tensor([0, s - 2, 5], dtype=torch.int32,
                         device=cuda_device)
    kk[0, 11, 1, 4] = float("nan")
    masked = (5 + 9 + 4) % s
    v[2, masked, 1, 5] = float("nan")
    got = ops.swa_decode(q, kk, v, length, start).cpu()
    exp = swa.swa_decode_plain(q, kk, v, length, start).cpu()
    g = hq // hkv
    assert got[0, g:2 * g].isnan().all() and exp[0, g:2 * g].isnan().all()
    assert exp[2, g:2 * g, 5].isnan().all()
    assert torch.isfinite(got[1:]).all()
    rest = ~exp.isnan()
    torch.testing.assert_close(got[rest], exp[rest], rtol=swa.RTOL,
                               atol=swa.ATOL)


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


@pytest.mark.cuda
def test_launch_counts_split_by_instantiation(cuda_device):
    """``prefetch_launches`` counts the prefetch instantiations,
    ``temporal_launches`` the temporal one at depth 1, and the rest of
    ``launches`` the spatial one (the smoke's examples phase reads them
    so)."""
    kern = sp.stencil_pipeline
    x = torch.from_numpy(_frames(3, 4, 37, 53)).to(cuda_device)
    spatial = sp.build_program(algorithms.unsharp_m(), 37, 53, 8, frames=4)
    deep = sp.build_program(algorithms.unsharp_m(), 37, 53, 8, frames=4,
                            prefetch_depth=2)
    dag = algorithms.VIDEO_ALGORITHMS["tdenoise-t"]()
    zero = sp.init_frame_state(dag.temporal_depths(), 37, 53, cuda_device)
    temporal = [sp.build_program(dag, 37, 53, 8, frames=4,
                                 prefetch_depth=d) for d in (1, 2)]
    runs = [(spatial, (1, 0, 0)), (deep, (1, 1, 0)),
            (temporal[0], (1, 0, 1)), (temporal[1], (1, 1, 0))]
    for prog, want in runs:
        before = (kern.launches, kern.prefetch_launches,
                  kern.temporal_launches)
        kern(prog, [x], [zero[p] for p in prog.states])
        torch.cuda.synchronize()
        got = (kern.launches - before[0], kern.prefetch_launches
               - before[1], kern.temporal_launches - before[2])
        assert got == want, (prog.dag.name, prog.prefetch_depth)
