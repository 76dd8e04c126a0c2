#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` and
drives the port's main path — ``repro_torch.imaging.FrameEngine`` serving
1080p frames of the paper's seven spatial pipelines, untiled and tiled —
holding every kernel and every served frame against the kernel's plain
PyTorch version on the same inputs. Each phase prints one JSON line:

  1. device  — the card, its compute capability (must be 9.0) and power
               limit;
  2. build   — the kernels built with nvcc for sm_90a, and the time;
  3. kernel  — the fused stencil kernel against its plain version for the
               7 pipelines x R in {1, 8} x four frame shapes, single-frame
               and batched (B=4, last slot an idle zero frame);
  4. serve   — the main path, with the kernel's launch count over it,
               throughput, and per-pipeline kernel / plain / bound times at
               B=4, 1080p, R=8;
  5. kernels — one line per kernel: route, source, launches, error and
               times.

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

    # ---------------------------------------------------- 5. kernels line
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
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
