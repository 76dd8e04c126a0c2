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
  2. build   — the kernels built with nvcc for sm_90a, and the time;
  3. kernel  — the fused stencil kernel against its plain version for the
               7 pipelines x R in {1, 8} x four frame shapes, single-frame
               and batched (B=4, last slot an idle zero frame);
  4. serve   — the spatial path, with the kernel's launch count over it,
               throughput, and per-pipeline kernel / plain / bound times at
               B=4, 1080p, R=8;
  5. video_kernel — the temporal kernel (history taps, frame outputs)
               against its plain version: the 4 video pipelines plus an
               internal temporal producer, R in {1, 8}, four frame shapes,
               single-frame and chunks of 4, 24-frame streams from a zero
               state; output and returned state at every step;
  6. video_serve — the video path: 2 interleaved 16-frame streams per
               video pipeline at 1080p, chunk 4, R=8, every served frame
               against the plain version over its whole stream, delivery
               order and warm flags, the temporal launch count, fps,
               latency, and per-pipeline kernel / plain / bound times of
               one chunk-4 launch;
  7. tuned   — the autotuned rung: VideoEngine(autotune=True) on the 4
               video pipelines and FrameEngine(autotune=True) on
               unsharp-m at 1080p, against the plain version;
  8. kernels — one line per kernel path: route, source, launches, error
               and times.

Tolerance: bitwise (0 ULP). The kernel rounds every product and sum on
its own in the plain version's order (``_rn`` intrinsics, ``-fmad=false``)
and both take correctly rounded square roots. Then the card's name and
power limit as nvidia-smi prints them, and last the device JSON line.

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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        k_ms = cuda_ms(lambda: sp.stencil_pipeline(prog, [x], rings),
                       iters=20)
        inputs = {"in": x}
        p_ms = cuda_ms(lambda: sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs, state, VIDEO_CHUNK)}),
            iters=3, warmup=1)
        roll_ms = cuda_ms(lambda: ex({"in": x}, state), iters=10) - k_ms
        nbytes, ops = sp.launch_work(prog, VIDEO_CHUNK)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        occ = sp.blocks_per_sm(prog)
        ctas = prog.grid_x * prog.grid_y * VIDEO_CHUNK
        per[name] = {
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "x_bound": k_ms / max(t_bytes, t_ops),
            "bytes": nbytes, "ops": ops, "smem_bytes": prog.smem_bytes,
            "ctas": ctas, "blocks_per_sm": occ, "waves": ctas / (occ * sms),
            "strip_w": prog.strip_w, "band_h": prog.band_h,
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
               for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(p["bound_by"] == "bytes"
                                       for p in per.values())
            else "operations"}


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
    libs = _build.build("stencil_pipeline")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get(
        "stencil_pipeline", "").splitlines() if "registers" in ln]
    emit("build", seconds=build_s, flags=list(_build.NVCC_FLAGS),
         libraries={n: os.path.relpath(p, ROOT) for n, p in libs.items()},
         ptxas=ptxas)

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
        k_ms = cuda_ms(lambda: sp.stencil_pipeline(prog, [x]), iters=20)
        p_ms = cuda_ms(lambda: sp.stencil_pipeline_plain(
            ex.dag, {"in": x}), iters=3, warmup=1)
        nbytes, ops = sp.launch_work(prog, SERVE_B)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        occ = sp.blocks_per_sm(prog)
        ctas = prog.grid_x * prog.grid_y * SERVE_B
        per[name] = {
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "smem_bytes": prog.smem_bytes,
            "ctas": ctas, "blocks_per_sm": occ,
            "waves": ctas / (occ * sms),
            "strip_w": prog.strip_w, "band_h": prog.band_h}
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

    # ---------------------------------------------------- 8. kernels line
    share: dict[str, float] = {}
    for p in per.values():
        share[p["bound_by"]] = share.get(p["bound_by"], 0.0) + p["bound_ms"]
    print(json.dumps({"kernels": [{
        "name": sp.stencil_pipeline.name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "launches": launches, "max_abs_err": max_err, "max_ulp": max_ulp,
        "ms": sum(p["ms"] for p in per.values()),
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
        "plain_ms": k1c["plain_ms"], "bound_ms": k1c["bound_ms"],
        "bound_by": k1c["bound_by"], "library_ms": None,
        "timed_on": f"one chunk-{VIDEO_CHUNK} {SERVE_H}x{SERVE_W} "
                    f"R={SERVE_R} launch of each of the 4 video pipelines",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
