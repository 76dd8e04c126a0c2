#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` and
drives the port's two serving paths — ``repro_torch.imaging.FrameEngine``
serving 1080p frames of the paper's seven spatial pipelines, untiled and
tiled, and ``repro_torch.video.VideoEngine`` serving interleaved 1080p
streams of the four temporal pipelines — holding every kernel and every
served frame against the kernel's plain PyTorch version on the same
inputs. Each phase prints one JSON line:

  1. device  — the card, its compute capability (must be 9.0) and power
               limit;
  2. build   — the kernels built with nvcc for sm_90a, the time, and
               ptxas's registers and spill bytes (per instantiation of
               the fused stencil kernel);
  3. kernel  — the fused stencil kernel against its plain version for the
               7 pipelines x R in {1, 8} x four frame shapes, single-frame
               and batched (B=4, last slot an idle zero frame);
  4. serve   — the spatial path, with the kernel's launch count over it,
               throughput, and per-pipeline kernel (per call and device
               time) / plain / bound times at B=4, 1080p, R=8, with the
               launch's threads, shared memory and CTAs per SM;
  5. video_kernel — the temporal kernel (history taps, frame outputs)
               against its plain version: the 4 video pipelines plus an
               internal temporal producer, R in {1, 8}, four frame shapes,
               single-frame and chunks of 4, 24-frame streams from a zero
               state; output and returned state at every step;
  6. video_serve — the video path: 2 interleaved 16-frame streams per
               video pipeline at 1080p, chunk 4, R=8, every served frame
               against the plain version over its whole stream, delivery
               order and warm flags, the temporal launch count, fps,
               latency, and per-pipeline kernel (both clocks) / plain /
               bound times of one chunk-4 launch with its resources;
  7. tuned   — the autotuned rung: VideoEngine(autotune=True) on the 4
               video pipelines and FrameEngine(autotune=True) on
               unsharp-m at 1080p, against the plain version;
  8. depth   — prefetch depth 2 and 4 (feeds copied ahead into their
               grown line rings, the grown slots poisoned with NaN): the 7
               spatial pipelines at 1080p B=4 and three odd shapes, and
               canny-m tiled, against depth 1 and the plain version; the
               4 video pipelines in chunks of 4 and an internal temporal
               producer, 12-frame streams, output and state at every
               step; FrameEngine and VideoEngine serving at depth 2; then
               per-pipeline kernel times (both clocks) at depth 1, 2 and
               4 with shared memory per CTA and CTAs per SM;
  9. conv2d  — the conv2d kernels through ``kernels.ops.conv2d`` on a
               1080p frame with 3x3 and 5x5 filters (the row-streaming
               kernel; the launch names the instantiation it ran) and the
               JAX package's sweep shapes, against ``conv2d_plain``;
               kernel / plain / bound / ``F.conv2d`` times at 1080p, each
               per call (CUDA events) and on the device (profiler), with
               the band, columns per thread and registers;
 10. swa_decode — the swa_decode kernels (split, then combine) through
               ``kernels.ops.swa_decode`` at gemma3-1b's local-attention
               shape (Hq=4, Hkv=1, D=256, window 512) and a decode batch
               of 64, an empty, a wrapped and a half-filled ring among the
               rows, and at Mixtral-8x22b's sliding-window layer (B=8,
               Hq=48, Hkv=8, D=128, window 4096; a one-slot ring, one
               shorter than a split, and a wrap inside a split among the
               rows), and the JAX package's sweep shapes, against
               ``swa_decode_plain``; kernel / plain / bound / SDPA times per
               call and on the device, with the split count and CTAs;
 11. kernels — one line per kernel path: route, source, launches, error
               and times (the K1 entries with device time, registers,
               spill bytes, shared memory and CTAs per SM).

Tolerance: bitwise (0 ULP) for the stencil kernel at every depth and for
conv2d. They round every product and sum on their own in the plain
version's order (``_rn`` intrinsics, ``-fmad=false``) and take correctly
rounded square roots. swa_decode sums its dot products in another order
than the plain version: rtol 2e-4, atol 2e-5 (``kernels/swa_decode.py``).
Then the card's name and power limit as nvidia-smi prints them, and last
the device JSON line.

Imports nothing of JAX or of the reference package. Exits non-zero, with
no result line, when there is no CUDA device or a phase fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# per call (CUDA events) and device (profiler) milliseconds
from repro_torch.perf.timing import device_ms  # noqa: E402
from repro_torch.perf.timing import event_ms as cuda_ms  # noqa: E402

TOLERANCE_ULP = 0
SHAPES = [(37, 53), (5, 48), (320, 480), (1080, 1920)]
SERVE_H, SERVE_W, SERVE_B, SERVE_R = 1080, 1920, 4, 8
REQUESTS_PER_PIPELINE = 8
TILED_FRAMES, TILE = 4, (256, 512)
SEED = 0
VIDEO_SHAPES = [(13, 24), (37, 53), (320, 480), (1080, 1920)]
VIDEO_T, VIDEO_CHUNK = 24, 4
STREAMS_PER_PIPELINE, STREAM_FRAMES = 2, 16
TUNED_FRAMES = 8
DEPTHS = (2, 4)
DEPTH_SHAPES = [(21, 130), (5, 257), (37, 53), (1080, 1920)]
DEPTH_VIDEO_SHAPES = [(37, 53), (1080, 1920)]
DEPTH_T = 12
CONV_FILTERS = [(3, 3), (5, 5)]
CONV_SWEEP = ([(8, 16), (20, 24), (13, 130), (9, 257)],
              [(1, 1), (3, 3), (1, 5), (5, 1), (2, 4)])
# gemma3-1b local attention (src/repro/configs/gemma3_1b.py): Hq=4, Hkv=1,
# head_dim 256, sliding window 512; a decode batch of 64
SWA_SHAPE = (64, 4, 1, 256, 512)                 # B, Hq, Hkv, D, S
# Mixtral-8x22b's sliding-window layer (src/repro/configs/mixtral_8x22b.py):
# 48 heads, 8 kv heads, head dim 6144 / 48, window 4096; a decode batch of 8
SWA_SHAPE_2 = (8, 48, 8, 128, 4096)
SWA_SWEEP = [(1, 4, 4, 32, 16), (2, 8, 2, 64, 32), (3, 8, 1, 16, 64)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def peak_rates(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, float32 non-tensor-core FLOP/s) of the
    card, from NVIDIA's data sheets (dense, at the full power limit)."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12                     # H100 SXM (80GB HBM3)


def frames(seed: int, n: int, h: int, w: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


def ulp_err(got: torch.Tensor, exp: torch.Tensor) -> tuple[float, float]:
    """(max |got - exp|, that error in ULP at the array's scale)."""
    if got.shape != exp.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(exp.shape)}")
    if not torch.isfinite(got).all():
        fail("non-finite output")
    err = (got - exp).abs().max().item()
    scale = float(np.spacing(np.float32(exp.abs().max().item())))
    return err, err / scale


def tinternal():
    """A temporal tap on a computed stage: its frames leave the kernel as
    a frame output and come back as state."""
    from repro_torch.core import algorithms
    from repro_torch.core.dsl import Pipeline
    p = Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], algorithms.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


def plain_stream(dag, vid: torch.Tensor) -> torch.Tensor:
    """The plain version over a whole (T, h, w) stream from a zero state:
    one call whose frame b reads its history from frames b - j."""
    from repro_torch.kernels import stencil_pipeline as sp
    t, h, w = vid.shape
    zero = sp.init_frame_state(dag.temporal_depths(), h, w, vid.device)
    inputs = {"in": vid}
    out, _ = sp.video_pipeline_plain(
        dag, {**inputs, **sp.tap_feeds(dag, inputs, zero, t)})
    return out


def video_kernel_phase(dev) -> tuple[float, float]:
    """Phase 5: the temporal kernel against its plain version, stepping
    24-frame streams; returns (max abs error, max ULP)."""
    from repro_torch.core import algorithms
    from repro_torch.core.codegen import compile_pipeline
    from repro_torch.kernels import stencil_pipeline as sp
    dags = [algorithms.VIDEO_ALGORITHMS[n]()
            for n in sorted(algorithms.VIDEO_ALGORITHMS)] + [tinternal()]
    max_err, max_ulp, cases, launches = 0.0, 0.0, 0, 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dag in dags:
        depths = dag.temporal_depths()
        chunks = (None,) if dag.name == "tinternal" else (None, VIDEO_CHUNK)
        for h, w in VIDEO_SHAPES:
            plan = compile_pipeline(dag, w)
            for r in (1, 8):
                for chunk in chunks:
                    vid = torch.rand((VIDEO_T, h, w), generator=gen,
                                     device=dev)
                    ex = sp.make_video_executor(dag, h, w, plan=plan,
                                                rows_per_step=r, chunk=chunk,
                                                device=dev)
                    state = ex.init_state()
                    step = chunk or 1
                    for t in range(0, VIDEO_T, step):
                        x = vid[t:t + step]
                        before = sp.stencil_pipeline.launches
                        got, new = ex({"in": x if chunk else x[0]}, state)
                        torch.cuda.synchronize()
                        if sp.stencil_pipeline.launches != before + 1:
                            fail(f"{dag.name} {h}x{w}: the temporal kernel "
                                 f"did not launch")
                        launches += 1
                        inputs = {"in": x}
                        exp, frames = sp.video_pipeline_plain(dag, {
                            **inputs,
                            **sp.tap_feeds(dag, inputs, state, step)})
                        where = (f"{dag.name} {h}x{w} R={r} chunk={chunk} "
                                 f"t={t}")
                        err, ulp = ulp_err(got.reshape(-1, h, w), exp)
                        if ulp > TOLERANCE_ULP:
                            fail(f"{where}: kernel differs from plain by "
                                 f"{ulp} ULP (abs {err})")
                        max_err, max_ulp = max(max_err, err), max(max_ulp,
                                                                  ulp)
                        for p, d in depths.items():
                            cur = x if p == "in" else frames[p]
                            roll = torch.cat([cur.flip(0), state[p]])[:d - 1]
                            if not torch.equal(new[p], roll):
                                fail(f"{where}: state of {p} differs from "
                                     f"the plain roll")
                        state = new
                    cases += 1
    emit("video_kernel", kernel="stencil_pipeline (temporal)", cases=cases,
         launches=launches, pipelines=[d.name for d in dags],
         rows_per_step=[1, 8], shapes=[list(s) for s in VIDEO_SHAPES],
         chunks=[None, VIDEO_CHUNK], frames_per_stream=VIDEO_T,
         max_abs_err=max_err, max_ulp=max_ulp, tolerance_ulp=TOLERANCE_ULP)
    return max_err, max_ulp


def video_serve_phase(dev, mem_rate: float, flop_rate: float,
                      sms: int) -> dict:
    """Phase 6: the video path at 1080p, then per-pipeline times of one
    chunk-4 launch. Returns the K1c kernels-line entry."""
    from repro_torch.core import algorithms
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.video import VideoEngine, VideoFrame
    names = sorted(algorithms.VIDEO_ALGORITHMS)
    eng = VideoEngine(device=dev, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R)
    t0 = time.perf_counter()
    for name in names:          # the server builds its executors at start
        eng.cache.video_executor_for(name, SERVE_H, SERVE_W,
                                     chunk=VIDEO_CHUNK, rows_per_step=SERVE_R)
    compile_s = time.perf_counter() - t0
    streams = {}
    for i, name in enumerate(names):
        for k in range(STREAMS_PER_PIPELINE):
            sid = eng.open_stream(name, SERVE_H, SERVE_W)
            streams[sid] = (name, frames(4000 + 10 * i + k, STREAM_FRAMES,
                                         SERVE_H, SERVE_W))
    done = {sid: [] for sid in streams}

    sp.stencil_pipeline.launches = 0
    t0 = time.perf_counter()
    for t in range(0, STREAM_FRAMES, VIDEO_CHUNK):
        # every stream offers its next chunk; the engine interleaves them
        for sid, (_, vid) in streams.items():
            for f in vid[t:t + VIDEO_CHUNK]:
                if not eng.submit(VideoFrame(sid, {"in": f})):
                    fail(f"stream {sid} refused a frame")
        while eng.pending:
            for c in eng.step():
                if not hasattr(c, "warm"):
                    fail(f"stream {c.stream} frame failed: {c!r}")
                done[c.stream].append(c)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = sp.stencil_pipeline.launches
    if launches == 0:
        fail("the video path never launched the temporal kernel")

    max_err, max_ulp = 0.0, 0.0
    for sid, (name, vid) in streams.items():
        dag = eng.cache.dag_for(name)
        got = done[sid]
        warmup = dag.cumulative_extent(temporal=True)[0]
        if [c.index for c in got] != list(range(STREAM_FRAMES)):
            fail(f"stream {sid} delivered {[c.index for c in got]}")
        if [c.warm for c in got] != [i >= warmup
                                     for i in range(STREAM_FRAMES)]:
            fail(f"stream {sid}: wrong warm flags")
        exp = plain_stream(dag, torch.from_numpy(vid).to(dev))
        err, ulp = ulp_err(torch.stack([c.output for c in got]), exp)
        if ulp > TOLERANCE_ULP:
            fail(f"stream {sid} ({name}) differs from plain by {ulp} ULP")
        max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)

    per = {}
    for name in names:
        ex = eng.cache.video_executor_for(name, SERVE_H, SERVE_W,
                                          chunk=VIDEO_CHUNK,
                                          rows_per_step=SERVE_R)
        prog, dag = ex.program, ex.dag
        x = torch.from_numpy(frames(5000, VIDEO_CHUNK, SERVE_H,
                                    SERVE_W)).to(dev)
        state = {p: torch.from_numpy(frames(5001, d - 1, SERVE_H,
                                            SERVE_W)).to(dev)
                 for p, d in ex.depths.items()}
        rings = [state[p] for p in prog.states]
        def call():
            sp.stencil_pipeline(prog, [x], rings)
        k_ms = cuda_ms(call, iters=20)
        dev_ms = device_ms(call, 20)[0]
        inputs = {"in": x}
        p_ms = cuda_ms(lambda: sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs, state, VIDEO_CHUNK)}),
            iters=3, warmup=1)
        roll_ms = cuda_ms(lambda: ex({"in": x}, state), iters=10) - k_ms
        nbytes, ops = sp.launch_work(prog, VIDEO_CHUNK)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        per[name] = {
            "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "x_bound": dev_ms / max(t_bytes, t_ops),
            "bytes": nbytes, "ops": ops,
            **k1_resources(prog, VIDEO_CHUNK, sms),
            "state_bytes": ex.frame_state_bytes,
            "state_roll_bytes": ex.state_roll_bytes,
            "executor_call_minus_kernel_ms": roll_ms}
    snap = eng.snapshot()
    n_frames = len(streams) * STREAM_FRAMES
    emit("video_serve", streams=len(streams), frames=n_frames,
         pipelines=names, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
         shape=[SERVE_H, SERVE_W], launches=launches, compile_s=compile_s,
         serve_s=serve_s, fps=n_frames / serve_s,
         execute_s=eng.metrics.execute_s, fps_execute=snap["fps_execute"],
         batches=snap["batches"], latency=snap["latency"],
         warmup_latency=snap["warmup_latency"],
         max_abs_err=max_err, max_ulp=max_ulp, per_pipeline=per)
    return {"launches": launches, "max_abs_err": max_err,
            "max_ulp": max_ulp,
            **{k: sum(p[k] for p in per.values())
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(p["bound_by"] == "bytes"
                                       for p in per.values())
            else "operations",
            **k1_entry_resources(per, "temporal")}


def tuned_phase(dev) -> float:
    """Phase 7: the autotuned rung of both engines at 1080p against the
    plain version; returns the max ULP."""
    from repro_torch.core import algorithms
    from repro_torch.imaging import FrameEngine, FrameRequest
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.video import VideoEngine, VideoFrame
    names = sorted(algorithms.VIDEO_ALGORITHMS)
    veng = VideoEngine(device=dev, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
                       autotune=True)
    max_ulp, combos = 0.0, {}
    before = sp.stencil_pipeline.launches
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        sid = veng.open_stream(name, SERVE_H, SERVE_W)
        vid = frames(6000 + i, TUNED_FRAMES, SERVE_H, SERVE_W)
        for f in vid:
            veng.submit(VideoFrame(sid, {"in": f}))
        got = []
        while veng.pending:
            got += veng.step()
        if [getattr(c, "rung", None) for c in got] != \
                ["tuned"] * TUNED_FRAMES:
            fail(f"{name}: tuned rung served {got!r}")
        exp = plain_stream(veng.cache.dag_for(name),
                           torch.from_numpy(vid).to(dev))
        _, ulp = ulp_err(torch.stack([c.output for c in got]), exp)
        if ulp > TOLERANCE_ULP:
            fail(f"{name}: tuned rung differs from plain by {ulp} ULP")
        max_ulp = max(max_ulp, ulp)
        combos[name] = veng.cache.tuning_for(name, SERVE_W).best.combo
    video_s = time.perf_counter() - t0

    feng = FrameEngine(device=dev, max_batch=SERVE_B, rows_per_step=SERVE_R,
                       tile_shape=(SERVE_H, SERVE_W), autotune=True)
    reqs = [FrameRequest(rid=i, pipeline="unsharp-m",
                         frames={"in": frames(7000 + i, 1, SERVE_H,
                                              SERVE_W)[0]})
            for i in range(SERVE_B)]
    t0 = time.perf_counter()
    served = {}
    for r in reqs:
        feng.submit(r)
    while feng.pending:
        for c in feng.step():
            served[c.rid] = c
    frame_s = time.perf_counter() - t0
    for r in reqs:
        c = served[r.rid]
        if getattr(c, "rung", None) != "tuned":
            fail(f"request {r.rid}: tuned rung served {c!r}")
        exp = sp.stencil_pipeline_plain(feng.cache.dag_for("unsharp-m"), {
            "in": torch.from_numpy(r.frames["in"]).to(dev)})
        _, ulp = ulp_err(c.output, exp)
        if ulp > TOLERANCE_ULP:
            fail(f"unsharp-m tuned rung differs from plain by {ulp} ULP")
        max_ulp = max(max_ulp, ulp)
    combos["unsharp-m"] = feng.cache.tuning_for("unsharp-m",
                                                SERVE_W).best.combo
    emit("tuned", video_pipelines=names, frame_pipeline="unsharp-m",
         shape=[SERVE_H, SERVE_W], video_tune_s=veng.cache.stats.tune_s,
         frame_tune_s=feng.cache.stats.tune_s, video_s=video_s,
         frame_s=frame_s, launches=sp.stencil_pipeline.launches - before,
         winners=combos, max_ulp=max_ulp, tolerance_ulp=TOLERANCE_ULP)
    return max_ulp


def depth_phase(dev, mem_rate: float, flop_rate: float, sms: int) -> dict:
    """Phase 8: the prefetch instantiations (K1d). Returns the kernels-
    line entry."""
    from repro_torch.core import algorithms
    from repro_torch.core.codegen import compile_pipeline
    from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
    from repro_torch.imaging.tiling import execute_tiled
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.video import VideoEngine, VideoFrame
    names = sorted(algorithms.ALGORITHMS)
    vnames = sorted(algorithms.VIDEO_ALGORITHMS)
    max_err, max_ulp, cases = 0.0, 0.0, 0

    def check(got, exp, where):
        nonlocal max_err, max_ulp
        err, ulp = ulp_err(got, exp)
        if ulp > TOLERANCE_ULP:
            fail(f"{where}: differs by {ulp} ULP (abs {err})")
        max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)

    # spatial: depth d against depth 1 and plain, grown slots poisoned
    for name in names:
        dag = algorithms.ALGORITHMS[name]()
        for h, w in DEPTH_SHAPES:
            plan = compile_pipeline(dag, w)
            for batch in (1, SERVE_B):
                x = torch.from_numpy(frames(8000 + cases, batch, h, w)).to(dev)
                if batch > 1:
                    x[-1] = 0.0                           # idle slot
                bufs = plan.alloc.buffers
                base = sp.stencil_pipeline(sp.build_program(
                    dag, h, w, SERVE_R, frames=batch, alloc_buffers=bufs),
                    [x])
                plain = sp.stencil_pipeline_plain(dag, {"in": x})
                check(base, plain, f"{name} {h}x{w} depth 1")
                for d in DEPTHS:
                    prog = sp.build_program(dag, h, w, SERVE_R, frames=batch,
                                            alloc_buffers=bufs,
                                            prefetch_depth=d,
                                            poison_prefetch=True)
                    before = sp.stencil_pipeline.prefetch_launches
                    got = sp.stencil_pipeline(prog, [x])
                    torch.cuda.synchronize()
                    if sp.stencil_pipeline.prefetch_launches != before + 1:
                        fail(f"{name}: the prefetch kernel did not launch")
                    where = f"{name} {h}x{w} B={batch} depth {d}"
                    check(got, base, where + " vs depth 1")
                    check(got, plain, where + " vs plain")
                    cases += 1
    cache = PlanCache(device=dev)
    img = torch.from_numpy(frames(8500, 1, SERVE_H, SERVE_W)[0]).to(dev)
    tiled_exp = sp.stencil_pipeline_plain(cache.dag_for("canny-m"),
                                          {"in": img})
    check(execute_tiled(cache, "canny-m", {"in": img}, *TILE,
                        batch=SERVE_B, rows_per_step=SERVE_R,
                        prefetch_depth=2), tiled_exp, "canny-m tiled depth 2")

    # temporal: chunked streams (one-frame steps for tinternal), output
    # and state at every step against depth 1 and plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for dag in [algorithms.VIDEO_ALGORITHMS[n]() for n in vnames] \
            + [tinternal()]:
        chunk = None if dag.name == "tinternal" else VIDEO_CHUNK
        step = chunk or 1
        for h, w in DEPTH_VIDEO_SHAPES:
            plan = compile_pipeline(dag, w)
            vid = torch.rand((DEPTH_T, h, w), generator=gen, device=dev)
            for d in DEPTHS:
                ex1, exd = (sp.make_video_executor(
                    dag, h, w, plan=plan, rows_per_step=SERVE_R, chunk=chunk,
                    prefetch_depth=k, device=dev) for k in (1, d))
                s1 = sd = ex1.init_state()
                for t in range(0, DEPTH_T, step):
                    x = vid[t:t + step]
                    feed = {"in": x if chunk else x[0]}
                    got, new_d = exd(feed, sd)
                    exp, new_1 = ex1(feed, s1)
                    torch.cuda.synchronize()
                    plain, _ = sp.video_pipeline_plain(dag, {
                        "in": x, **sp.tap_feeds(dag, {"in": x}, sd, step)})
                    where = f"{dag.name} {h}x{w} depth {d} t={t}"
                    check(got.reshape(-1, h, w), plain, where + " vs plain")
                    check(got, exp, where + " vs depth 1")
                    for p in new_d:
                        if not torch.equal(new_d[p], new_1[p]):
                            fail(f"{where}: state of {p} differs from "
                                 f"depth 1")
                    sd, s1 = new_d, new_1
                    cases += 1

    # the serving paths at depth 2, counted from zero
    feng = FrameEngine(device=dev, max_batch=SERVE_B, rows_per_step=SERVE_R,
                       tile_shape=(SERVE_H, SERVE_W), prefetch_depth=2)
    reqs = [FrameRequest(rid=i, pipeline=names[i % len(names)],
                         frames={"in": frames(8600 + i, 1, SERVE_H,
                                              SERVE_W)[0]})
            for i in range(2 * len(names))]
    veng = VideoEngine(device=dev, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
                       prefetch_depth=2)
    streams = {veng.open_stream(n, SERVE_H, SERVE_W):
               (n, frames(8700 + i, 2 * VIDEO_CHUNK, SERVE_H, SERVE_W))
               for i, n in enumerate(vnames)}
    sp.stencil_pipeline.launches = sp.stencil_pipeline.prefetch_launches = 0
    t0 = time.perf_counter()
    served = feng.run(reqs)
    for sid, (_, vid) in streams.items():
        for f in vid:
            if not veng.submit(VideoFrame(sid, {"in": f})):
                fail(f"stream {sid} refused a frame")
    vdone = {sid: [] for sid in streams}
    while veng.pending:
        for c in veng.step():
            if not hasattr(c, "warm"):
                fail(f"stream {c.stream} frame failed: {c!r}")
            vdone[c.stream].append(c.output)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = sp.stencil_pipeline.prefetch_launches
    if launches == 0 or launches != sp.stencil_pipeline.launches:
        fail(f"depth-2 serving launched the prefetch kernel {launches} "
             f"of {sp.stencil_pipeline.launches} times")
    for r in reqs:
        if not isinstance(served.get(r.rid), torch.Tensor):
            fail(f"request {r.rid} not served: {served.get(r.rid)!r}")
        check(served[r.rid], sp.stencil_pipeline_plain(
            feng.cache.dag_for(r.pipeline),
            {"in": torch.from_numpy(r.frames["in"]).to(dev)}),
            f"served frame {r.rid} ({r.pipeline}) depth 2")
    for sid, (name, vid) in streams.items():
        check(torch.stack(vdone[sid]),
              plain_stream(veng.cache.dag_for(name),
                           torch.from_numpy(vid).to(dev)),
              f"stream {sid} ({name}) depth 2")

    # times at depth 1, 2, 4: one B=4 batch / one chunk-4 launch, 1080p
    per = {}
    x = torch.from_numpy(frames(8800, SERVE_B, SERVE_H, SERVE_W)).to(dev)
    for name in names + vnames:
        dag = (algorithms.ALGORITHMS.get(name)
               or algorithms.VIDEO_ALGORITHMS[name])()
        plan = compile_pipeline(dag, SERVE_W)
        depths = dag.temporal_depths()
        states = [torch.from_numpy(frames(8900, depths[p] - 1, SERVE_H,
                                          SERVE_W)).to(dev)
                  for p in dag.topo_order if p in depths]
        row = {}
        for d in (1, *DEPTHS):
            prog = sp.build_program(dag, SERVE_H, SERVE_W, SERVE_R,
                                    frames=SERVE_B,
                                    alloc_buffers=plan.alloc.buffers,
                                    prefetch_depth=d)
            def call():
                sp.stencil_pipeline(prog, [x], states)
            row[f"d{d}"] = {
                "ms": cuda_ms(call, iters=20),
                "device_ms": device_ms(call, 10)[0],
                "prefetch_bytes": prog.prefetch_bytes,
                **k1_resources(prog, SERVE_B, sms)}
        inputs = {"in": x}
        row["plain_ms"] = cuda_ms(lambda: sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs, dict(zip(
                prog.states, states)), SERVE_B)}), iters=3, warmup=1)
        nbytes, ops = sp.launch_work(prog, SERVE_B)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        per[name] = row
    emit("depth", kernel="stencil_pipeline (prefetch)", depths=list(DEPTHS),
         cases=cases, spatial_shapes=[list(s) for s in DEPTH_SHAPES],
         video_shapes=[list(s) for s in DEPTH_VIDEO_SHAPES],
         frames_per_stream=DEPTH_T, rows_per_step=SERVE_R,
         served_frames=len(reqs), served_streams=len(streams),
         serve_s=serve_s, launches=launches, max_abs_err=max_err,
         max_ulp=max_ulp, tolerance_ulp=TOLERANCE_ULP,
         timed_on=f"B={SERVE_B} (chunk of {SERVE_B} for video) "
                  f"{SERVE_H}x{SERVE_W} R={SERVE_R}",
         per_pipeline=per)
    spatial = [per[n] for n in names]
    video = [per[n] for n in vnames]
    return {"launches": launches, "max_abs_err": max_err,
            "max_ulp": max_ulp,
            "ms": sum(p["d2"]["ms"] for p in spatial),
            "device_ms": sum(p["d2"]["device_ms"] for p in spatial),
            "ms_depth4": sum(p["d4"]["ms"] for p in spatial),
            "device_ms_depth1": sum(p["d1"]["device_ms"] for p in spatial),
            "video_device_ms": sum(p["d2"]["device_ms"] for p in video),
            "video_device_ms_depth1": sum(p["d1"]["device_ms"]
                                          for p in video),
            "video_bound_ms": sum(p["bound_ms"] for p in video),
            "ptxas": _registers("stencil_pipeline",
                                K1_INSTANCES["spatial_prefetch"]),
            "ptxas_temporal": _registers(
                "stencil_pipeline", K1_INSTANCES["temporal_prefetch"]),
            "smem_bytes": {n: per[n]["d2"]["smem_bytes"] for n in per},
            "blocks_per_sm": {n: per[n]["d2"]["blocks_per_sm"]
                              for n in per},
            "blocks_per_sm_depth1": {n: per[n]["d1"]["blocks_per_sm"]
                                     for n in per},
            "plain_ms": sum(p["plain_ms"] for p in spatial),
            "bound_ms": sum(p["bound_ms"] for p in spatial),
            "bound_by": "bytes" if all(p["bound_by"] == "bytes"
                                       for p in spatial) else "operations"}


def _registers(lib: str, pattern: str) -> dict | None:
    """ptxas's registers and spill bytes of the one entry function of
    library ``lib`` whose mangled name holds ``pattern``."""
    from repro_torch.kernels import _build
    hits = [v for k, v in _build.ptxas(lib).items() if pattern in k]
    return hits[0] if len(hits) == 1 else None


# the fused kernel's instantiations: <kTemporal, kPrefetch>
K1_INSTANCES = {"spatial": "ILb0ELb0E", "temporal": "ILb1ELb0E",
                "spatial_prefetch": "ILb0ELb1E",
                "temporal_prefetch": "ILb1ELb1E"}


def k1_resources(prog, frames_: int, sms: int) -> dict:
    """Threads, shared memory, CTAs and CTAs per SM of one launch of the
    fused kernel over ``frames_`` frames."""
    from repro_torch.kernels import stencil_pipeline as sp
    occ = sp.blocks_per_sm(prog)
    ctas = prog.grid_x * prog.grid_y * frames_
    return {"threads": int(prog.table[sp.H_THREADS]),
            "smem_bytes": prog.smem_bytes, "ctas": ctas,
            "blocks_per_sm": occ, "waves": ctas / (occ * sms),
            "strip_w": prog.strip_w, "band_h": prog.band_h}


def k1_entry_resources(per: dict, instance: str) -> dict:
    """The K1 kernels-line fields beside the times: ptxas's registers and
    spill bytes of ``instance``, and per pipeline the shared memory and
    CTAs per SM."""
    return {"ptxas": _registers("stencil_pipeline", K1_INSTANCES[instance]),
            "smem_bytes": {n: p["smem_bytes"] for n, p in per.items()},
            "blocks_per_sm": {n: p["blocks_per_sm"]
                              for n, p in per.items()}}


def conv2d_phase(dev, mem_rate: float, flop_rate: float) -> dict:
    """Phase 9: the conv2d kernels (K2). Returns the kernels-line entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_stencil, ops
    rng = np.random.RandomState(SEED + 9)
    img = torch.from_numpy(rng.rand(SERVE_H, SERVE_W)
                           .astype(np.float32)).to(dev)
    wts = [torch.from_numpy(rng.randn(*k).astype(np.float32)).to(dev)
           for k in CONV_FILTERS]
    conv2d_stencil.conv2d.launches = 0
    outs, variants = [], []
    for (kh, kw), wt in zip(CONV_FILTERS, wts):
        outs.append(ops.conv2d(img, wt, device=dev))
        variants.append(f"conv2d_rows<{kh}, {kw}, {conv2d_stencil.COLS}> "
                        f"({conv2d_stencil.conv2d.variant})")
    torch.cuda.synchronize()
    launches = conv2d_stencil.conv2d.launches
    if launches != len(wts):
        fail(f"ops.conv2d launched the kernel {launches} times")
    if not all(v.endswith("(rows_vector)") for v in variants):
        fail(f"the 1080p filters ran {variants}, not the row kernel")
    max_err, max_ulp = 0.0, 0.0
    checks = [(img, wt, out) for wt, out in zip(wts, outs)]
    for h, w in CONV_SWEEP[0]:
        for k in CONV_SWEEP[1]:
            x = torch.from_numpy(rng.rand(h, w).astype(np.float32)).to(dev)
            wt = torch.from_numpy(rng.randn(*k).astype(np.float32)).to(dev)
            checks.append((x, wt, conv2d_stencil.conv2d(x, wt)))
    for x, wt, got in checks:
        err, ulp = ulp_err(got, conv2d_stencil.conv2d_plain(x, wt))
        if ulp > TOLERANCE_ULP:
            fail(f"conv2d {tuple(x.shape)} {tuple(wt.shape)}: kernel "
                 f"differs from plain by {ulp} ULP (abs {err})")
        max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)
    per = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False        # a float32 yardstick
    try:
        for (kh, kw), wt, variant in zip(CONV_FILTERS, wts, variants):
            padded = F.pad(img, (kw - 1, 0, kh - 1, 0))[None, None]
            nbytes = 2 * SERVE_H * SERVE_W * 4 + kh * kw * 4
            ops_n = 2 * kh * kw * SERVE_H * SERVE_W
            t_bytes, t_ops = nbytes / mem_rate * 1e3, ops_n / flop_rate * 1e3
            lib = F.conv2d(padded, wt[None, None])[0, 0]

            def kernel():
                return conv2d_stencil.conv2d(img, wt)

            def library():
                return F.conv2d(padded, wt[None, None])
            per[f"{kh}x{kw}"] = {
                "ms": cuda_ms(kernel, iters=50),
                "device_ms": device_ms(kernel, 50)[0],
                "plain_ms": cuda_ms(lambda: conv2d_stencil.conv2d_plain(
                    img, wt), iters=5, warmup=1),
                "library_ms": cuda_ms(library, iters=50),
                "library_device_ms": device_ms(library, 50)[0],
                "library_max_abs_diff": (lib - kernel()).abs().max().item(),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops_n, "variant": variant,
                "band": 8,  # ops.conv2d's default tile_rows
                "cols": conv2d_stencil.COLS,
                "ptxas": _registers("conv2d_stencil",
                                    f"conv2d_rowsILi{kh}ELi{kw}ELi"
                                    f"{conv2d_stencil.COLS}E"),
                "smem_bytes": conv2d_stencil.smem_bytes(kh, kw, 8)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit("conv2d", kernel="conv2d", shape=[SERVE_H, SERVE_W],
         filters=[list(k) for k in CONV_FILTERS], launches=launches,
         variants=variants, sweep_shapes=[list(s) for s in CONV_SWEEP[0]],
         sweep_filters=[list(k) for k in CONV_SWEEP[1]], cases=len(checks),
         max_abs_err=max_err, max_ulp=max_ulp, tolerance_ulp=TOLERANCE_ULP,
         cudnn_allow_tf32=False, per_filter=per)
    return {"launches": launches, "max_abs_err": max_err,
            "max_ulp": max_ulp, "variants": variants,
            **{k: sum(p[k] for p in per.values())
               for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "library_ms", "library_device_ms")},
            "bound_by": "bytes" if all(p["bound_by"] == "bytes"
                                       for p in per.values())
            else "operations"}


def swa_inputs(shape, rng, dev):
    b, hq, hkv, d, s = shape
    q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev)
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    length = rng.randint(1, s + 1, size=b).astype(np.int32)
    start = rng.randint(0, s, size=b).astype(np.int32)
    return q, k, v, length, start


def swa_phase(dev, mem_rate: float, flop_rate: float) -> dict:
    """Phase 10: the swa_decode kernels (K3). Returns the kernels-line
    entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_decode as swa
    rng = np.random.RandomState(SEED + 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = []                      # (shape, q, k, v, length, ring_start)
    for shape in (SWA_SHAPE, SWA_SHAPE_2):
        b, hq, hkv, d, s = shape
        q, k, v, _, _ = swa_inputs(shape, rng, dev)
        # a full window on most rows (steady decode)
        length = np.full(b, s, np.int32)
        start = rng.randint(0, s, size=b).astype(np.int32)
        if shape == SWA_SHAPE:
            # an empty ring, a ring that wraps, and a half-filled one
            length[0], length[1], start[1] = 0, s // 2, s - 3
        else:
            # a one-slot ring, one shorter than a split, and a wrap that
            # falls inside a split
            _, chunk = swa.split_plan(b, hkv, hq // hkv, s, d, sms)
            length[0], length[1], start[2] = 1, chunk // 2, s - chunk // 3
        main.append((shape, q, k, v, torch.from_numpy(length).to(dev),
                     torch.from_numpy(start).to(dev)))
    swa.swa_decode.launches = 0
    outs, splits = [], []
    for _, q, k, v, ln, st in main:
        outs.append(ops.swa_decode(q, k, v, ln, st, device=dev))
        splits.append(swa.swa_decode.splits)
    torch.cuda.synchronize()
    launches = swa.swa_decode.launches
    if launches != len(main):
        fail(f"ops.swa_decode launched the kernel {launches} times")
    if not torch.equal(outs[0][0], torch.zeros_like(outs[0][0])):
        fail("swa_decode: an empty ring did not give zeros")
    checks = [(m[0], out, m[1:]) for m, out in zip(main, outs)]
    for shape in SWA_SWEEP:
        q2, k2, v2, ln, st = swa_inputs(shape, rng, dev)
        ln[0] = 0
        args = (q2, k2, v2, torch.from_numpy(ln).to(dev),
                torch.from_numpy(st).to(dev))
        checks.append((shape, swa.swa_decode(*args), args))
    max_err = 0.0
    for shape, out, args in checks:
        exp = swa.swa_decode_plain(*args)
        if not torch.isfinite(out).all() or not torch.allclose(
                out, exp, rtol=swa.RTOL, atol=swa.ATOL):
            fail(f"swa_decode {shape}: kernel differs from plain by "
                 f"{(out - exp).abs().max().item()}")
        max_err = max(max_err, (out - exp).abs().max().item())
    per = {}
    for (shape, q, k, v, ln, st), n_splits in zip(main, splits):
        b, hq, hkv, d, s = shape
        g = hq // hkv
        # bytes: q and out once, K and V rows of the valid slots once
        valid = int(ln.clamp(0, s).sum().item())
        nbytes = 2 * valid * hkv * d * 4 + 2 * b * hq * d * 4 + 2 * b * 4
        ops_n = 4 * valid * hq * d
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops_n / flop_rate * 1e3
        mask = swa.ring_valid(ln, st, s)[:, None, None, :]
        qs, ks, vs = (q[:, :, None], k.permute(0, 2, 1, 3),
                      v.permute(0, 2, 1, 3))

        def kernel():
            return swa.swa_decode(q, k, v, ln, st)

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
        gp = swa.rows_per_pass(g, d)
        p = swa.share(d)
        per["x".join(map(str, shape))] = {
            "shape": list(shape),
            "ms": cuda_ms(kernel, iters=50),
            "device_ms": device_ms(kernel, 50)[0],
            "plain_ms": cuda_ms(lambda: swa.swa_decode_plain(
                q, k, v, ln, st), iters=10),
            "library_ms": cuda_ms(library, iters=50),
            "library_device_ms": device_ms(library, 50)[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops_n, "valid_slots": valid,
            "splits": n_splits, "rows_per_pass": gp,
            "ctas": n_splits * hkv * -(-g // gp) * b,
            "ptxas": _registers("swa_decode",
                                f"swa_split_kernelILi{gp}ELi{p}ELb1E"),
            "smem_bytes": swa.smem_bytes(g, d)}
    emit("swa_decode", kernel="swa_decode",
         shapes=[list(m[0]) for m in main],
         shapes_are="B, Hq, Hkv, D, S (gemma3-1b local layers; "
                    "Mixtral-8x22b sliding-window layer)",
         sweep_shapes=[list(x) for x in SWA_SWEEP], launches=launches,
         cases=len(checks), max_abs_err=max_err,
         tolerance={"rtol": swa.RTOL, "atol": swa.ATOL}, per_shape=per)
    return {"launches": launches, "max_abs_err": max_err,
            "splits": splits,
            **{k: sum(p[k] for p in per.values())
               for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "library_ms", "library_device_ms")},
            "bound_by": "bytes" if all(p["bound_by"] == "bytes"
                                       for p in per.values())
            else "operations"}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.core import algorithms
    from repro_torch.core.codegen import compile_pipeline
    from repro_torch.imaging import FrameEngine, FrameRequest
    from repro_torch.kernels import _build
    from repro_torch.kernels import stencil_pipeline as sp

    dev = torch.device("cuda")
    names = sorted(algorithms.ALGORITHMS)

    # ---------------------------------------------------------- 1. device
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", kind=kind, capability=list(cap), sms=sms,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    mem_rate, flop_rate = peak_rates(kind)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = _build.build("stencil_pipeline", "conv2d_stencil", "swa_decode")
    build_s = time.perf_counter() - t0
    ptxas = {}
    for n in libs:
        rep = _build.ptxas(n).values()
        ptxas[n] = {"kernels": len(rep),
                    "max_registers": max((r.get("registers", 0)
                                          for r in rep), default=None),
                    "spill_bytes": sum(r.get("spill_bytes", 0)
                                       for r in rep)}
    emit("build", seconds=build_s, flags=list(_build.NVCC_FLAGS),
         libraries={n: os.path.relpath(p, ROOT) for n, p in libs.items()},
         ptxas=ptxas, stencil_pipeline={
             k: _registers("stencil_pipeline", v)
             for k, v in K1_INSTANCES.items()})

    # ---------------------------------------------- 3. kernel vs plain
    max_err, max_ulp, cases = 0.0, 0.0, 0
    for name in names:
        dag = algorithms.ALGORITHMS[name]()
        for h, w in SHAPES:
            plan = compile_pipeline(dag, w)
            for r in (1, 8):
                for batch in (None, SERVE_B):
                    x = frames(SEED + cases, batch or 1, h, w)
                    if batch:
                        x[-1] = 0.0                  # idle slot
                    else:
                        x = x[0]
                    x = torch.from_numpy(x).to(dev)
                    ex = sp.make_executor(dag, h, w, batch=batch, plan=plan,
                                          rows_per_step=r, device=dev)
                    before = sp.stencil_pipeline.launches
                    got = ex({"in": x})
                    torch.cuda.synchronize()
                    if sp.stencil_pipeline.launches != before + 1:
                        fail(f"{name} {h}x{w}: the kernel did not launch")
                    exp = sp.stencil_pipeline_plain(dag, {"in": x})
                    err, ulp = ulp_err(got, exp)
                    if ulp > TOLERANCE_ULP:
                        fail(f"{name} {h}x{w} R={r} batch={batch}: kernel "
                             f"differs from plain by {ulp} ULP (abs {err})")
                    max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)
                    cases += 1
    emit("kernel", kernel="stencil_pipeline", cases=cases,
         pipelines=len(names), rows_per_step=[1, 8],
         shapes=[list(s) for s in SHAPES], batches=[None, SERVE_B],
         max_abs_err=max_err, max_ulp=max_ulp,
         tolerance_ulp=TOLERANCE_ULP)

    # ------------------------------------------------- 4. the main path
    engine = FrameEngine(device=dev, max_batch=SERVE_B,
                         rows_per_step=SERVE_R,
                         tile_shape=(SERVE_H, SERVE_W))
    t0 = time.perf_counter()
    for name in names:          # the server compiles its plans at start
        engine.cache.executor_for(name, SERVE_H, SERVE_W, batch=SERVE_B,
                                  rows_per_step=SERVE_R)
    compile_s = time.perf_counter() - t0
    reqs = [FrameRequest(rid=i, pipeline=names[i % len(names)],
                         frames={"in": frames(1000 + i, 1, SERVE_H,
                                              SERVE_W)[0]})
            for i in range(REQUESTS_PER_PIPELINE * len(names))]
    tiled = FrameEngine(device=dev, max_batch=SERVE_B,
                        rows_per_step=SERVE_R, tile_shape=TILE)
    treqs = [FrameRequest(rid=i, pipeline="canny-m",
                          frames={"in": frames(2000 + i, 1, SERVE_H,
                                               SERVE_W)[0]})
             for i in range(TILED_FRAMES)]

    sp.stencil_pipeline.launches = 0
    t0 = time.perf_counter()
    served = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches_untiled = sp.stencil_pipeline.launches
    t0 = time.perf_counter()
    served_tiled = tiled.run(treqs)
    torch.cuda.synchronize()
    tiled_s = time.perf_counter() - t0
    launches = sp.stencil_pipeline.launches
    if launches_untiled == 0 or launches == launches_untiled:
        fail(f"main path launched the kernel {launches_untiled} times "
             f"untiled, {launches - launches_untiled} tiled")

    for eng, rs, out in ((engine, reqs, served), (tiled, treqs,
                                                   served_tiled)):
        for r in rs:
            if not isinstance(out.get(r.rid), torch.Tensor):
                fail(f"request {r.rid} not served: {out.get(r.rid)!r}")
            x = torch.from_numpy(r.frames["in"]).to(dev)
            exp = sp.stencil_pipeline_plain(eng.cache.dag_for(r.pipeline),
                                            {"in": x})
            err, ulp = ulp_err(out[r.rid], exp)
            if ulp > TOLERANCE_ULP:
                fail(f"served frame {r.rid} ({r.pipeline}) differs from "
                     f"plain by {ulp} ULP")
            max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)

    # kernel / plain / bound at the main path's batch shape, per pipeline
    per = {}
    for name in names:
        ex = engine.cache.executor_for(name, SERVE_H, SERVE_W,
                                       batch=SERVE_B, rows_per_step=SERVE_R)
        prog = ex.program
        x = torch.from_numpy(frames(3000, SERVE_B, SERVE_H,
                                    SERVE_W)).to(dev)
        def call():
            sp.stencil_pipeline(prog, [x])
        k_ms = cuda_ms(call, iters=20)
        p_ms = cuda_ms(lambda: sp.stencil_pipeline_plain(
            ex.dag, {"in": x}), iters=3, warmup=1)
        nbytes, ops = sp.launch_work(prog, SERVE_B)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        per[name] = {
            "ms": k_ms, "device_ms": device_ms(call, 20)[0],
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            **k1_resources(prog, SERVE_B, sms)}
    snap = engine.snapshot()
    emit("serve", frames=len(reqs), tiled_frames=len(treqs),
         pipelines=names, batch=SERVE_B, rows_per_step=SERVE_R,
         shape=[SERVE_H, SERVE_W], tile_shape=list(TILE),
         launches=launches, launches_untiled=launches_untiled,
         launches_tiled=launches - launches_untiled,
         compile_s=compile_s, serve_s=serve_s, tiled_s=tiled_s,
         fps=len(reqs) / serve_s, tiled_fps=len(treqs) / tiled_s,
         execute_s=engine.metrics.execute_s,
         fps_execute=snap["fps_execute"], batches=snap["batches"],
         latency=snap["latency"], smem_high_water_bytes=snap[
             "smem_high_water_bytes"],
         tiled_execute_s=tiled.metrics.execute_s,
         max_abs_err=max_err, max_ulp=max_ulp,
         peak_bytes_per_s=mem_rate, peak_flops=flop_rate,
         per_pipeline=per)

    # ------------------------------------------- 5-7. the video path
    k1c_err, k1c_ulp = video_kernel_phase(dev)
    k1c = video_serve_phase(dev, mem_rate, flop_rate, sms)
    tuned_phase(dev)

    # ------------------------------------- 8-10. depth, conv2d, swa_decode
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    k1d = depth_phase(dev, mem_rate, flop_rate, sms)
    k2 = conv2d_phase(dev, mem_rate, flop_rate)
    k3 = swa_phase(dev, mem_rate, flop_rate)

    # --------------------------------------------------- 11. kernels line
    share: dict[str, float] = {}
    for p in per.values():
        share[p["bound_by"]] = share.get(p["bound_by"], 0.0) + p["bound_ms"]
    print(json.dumps({"kernels": [{
        "name": sp.stencil_pipeline.name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "launches": launches, "max_abs_err": max_err, "max_ulp": max_ulp,
        "ms": sum(p["ms"] for p in per.values()),
        "device_ms": sum(p["device_ms"] for p in per.values()),
        **k1_entry_resources(per, "spatial"),
        "plain_ms": sum(p["plain_ms"] for p in per.values()),
        "bound_ms": sum(p["bound_ms"] for p in per.values()),
        "bound_by": max(share, key=share.get),
        "library_ms": None,
        "timed_on": f"one B={SERVE_B} {SERVE_H}x{SERVE_W} R={SERVE_R} "
                    f"batch of each of the {len(names)} pipelines",
    }, {
        "name": f"{sp.stencil_pipeline.name} (temporal)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "replaces_part": "temporal taps and frame outputs (:153-173, "
                         ":188-194, :200-213, :227-235, :255-266, "
                         ":631-688)",
        "launches": k1c["launches"],
        "max_abs_err": max(k1c_err, k1c["max_abs_err"]),
        "max_ulp": max(k1c_ulp, k1c["max_ulp"]), "ms": k1c["ms"],
        "device_ms": k1c["device_ms"],
        **{k: k1c[k] for k in ("ptxas", "smem_bytes", "blocks_per_sm")},
        "plain_ms": k1c["plain_ms"], "bound_ms": k1c["bound_ms"],
        "bound_by": k1c["bound_by"], "library_ms": None,
        "timed_on": f"one chunk-{VIDEO_CHUNK} {SERVE_H}x{SERVE_W} "
                    f"R={SERVE_R} launch of each of the 4 video pipelines",
    }, {
        "name": f"{sp.stencil_pipeline.name} (prefetch)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "replaces_part": "prefetch_depth >= 2 rings (:319-421)",
        "launches": k1d["launches"], "max_abs_err": k1d["max_abs_err"],
        "max_ulp": k1d["max_ulp"], "ms": k1d["ms"],
        **{k: k1d[k] for k in ("device_ms", "device_ms_depth1",
                               "video_device_ms", "video_device_ms_depth1",
                               "video_bound_ms", "ptxas", "ptxas_temporal",
                               "smem_bytes", "blocks_per_sm",
                               "blocks_per_sm_depth1")},
        "ms_depth4": k1d["ms_depth4"], "plain_ms": k1d["plain_ms"],
        "bound_ms": k1d["bound_ms"], "bound_by": k1d["bound_by"],
        "library_ms": None,
        "timed_on": f"one B={SERVE_B} {SERVE_H}x{SERVE_W} R={SERVE_R} "
                    f"batch of each of the {len(names)} pipelines at "
                    f"depth 2 (ms_depth4: depth 4; video_*: one "
                    f"chunk-{SERVE_B} launch of each of the 4 video "
                    f"pipelines)",
    }, {
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_stencil.cu",
        "replaces": "src/repro/kernels/conv2d_stencil.py:52",
        **{key: k2[key] for key in ("launches", "max_abs_err", "max_ulp",
                                    "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "device_ms",
                                    "library_device_ms", "variants")},
        "library": "torch.nn.functional.conv2d, cudnn TF32 off",
        "timed_on": f"a {SERVE_H}x{SERVE_W} frame with a 3x3 and a 5x5 "
                    f"filter, summed",
    }, {
        "name": "swa_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_decode.cu",
        "replaces": "src/repro/kernels/swa_decode.py:66",
        **{key: k3[key] for key in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms", "splits")},
        "library": "torch.nn.functional.scaled_dot_product_attention, "
                   "boolean ring mask, enable_gqa",
        "timed_on": "B=64, Hq=4, Hkv=1, D=256, S=512 (gemma3-1b local "
                    "layers) and B=8, Hq=48, Hkv=8, D=128, S=4096 "
                    "(Mixtral-8x22b sliding-window layer), summed",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
