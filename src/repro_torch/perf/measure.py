"""Measured-side performance extraction: timing, launch counts, trace splits.

Three independent measurement channels, joined with the analytic model
by :mod:`repro_torch.perf.attribution`:

  * **steady-state timing** (:func:`measure_executor`) — warm the
    executor, then time a seeded stream of host frames, waiting for the
    device after every call. Frames arrive as numpy arrays, as they do
    at the engines, so the time includes the pageable host-to-device
    copy the serving paths pay.
  * **launch counts** (:func:`executor_cost`) — float32 operations and
    bytes loaded and stored per executor call, counted from the
    executor's :class:`~repro_torch.kernels.stencil_pipeline.
    StencilProgram` (its stage table and launch geometry). These are
    counts, not measurements: the JAX package reads XLA's cost analysis
    here, and no profiler of the card's memory traffic (``ncu``) runs
    where the port is measured.
  * **trace breakdown** (:func:`step_breakdown`) — queue-wait vs
    assemble vs execute *self*-time per pipeline, aggregated from the
    obs plane's ``engine.step`` spans (reusing the flame summary's
    per-thread interval-containment arithmetic in
    :func:`repro_torch.obs.export._self_times_us`).

Roofline peaks and the DMA-bound vs compute-bound classification also
live here (:class:`Peaks`, :func:`classify`). The card's peaks come two
ways: NVIDIA's data sheets (:func:`datasheet_peaks`) and two probes timed
on the card itself (:func:`calibrate`).
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.kernels.stencil_pipeline import launch_traffic, launch_work
from repro_torch.obs.export import _self_times_us, _span_rows
from repro_torch.perf.timing import event_ms


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Machine peaks the roofline classification is evaluated against."""
    flops_per_s: float
    hbm_bytes_per_s: float

    @property
    def ridge_intensity(self) -> float:
        """Flops/byte above which a kernel is compute-bound."""
        return self.flops_per_s / self.hbm_bytes_per_s

    def to_dict(self) -> dict:
        return {"flops_per_s": self.flops_per_s,
                "hbm_bytes_per_s": self.hbm_bytes_per_s,
                "ridge_intensity": self.ridge_intensity}


def datasheet_peaks(name: str) -> Peaks:
    """Float32 (non-tensor-core) FLOP/s and device-memory bytes/s of the
    card named ``name`` (``torch.cuda.get_device_name``), from NVIDIA's
    data sheets: dense rates at the full power limit."""
    if "H200" in name:
        return Peaks(flops_per_s=67e12, hbm_bytes_per_s=4.8e12)
    if "PCIe" in name:
        return Peaks(flops_per_s=51e12, hbm_bytes_per_s=2.0e12)
    if "NVL" in name:
        return Peaks(flops_per_s=60e12, hbm_bytes_per_s=3.9e12)
    return Peaks(flops_per_s=67e12, hbm_bytes_per_s=3.35e12)   # H100 SXM


def card_info(index: int = 0) -> dict:
    """The card's name (``torch.cuda.get_device_name``) and its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints
    them: what every number measured on it is reported beside."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return {"device": torch.cuda.get_device_name(index),
            "nvidia_smi": smi.stdout.strip()}


def _calibrate_host(reps: int) -> Peaks:
    """The JAX package's host probes: a 384^3 float32 numpy product and
    a 16 MiB copy."""
    n = 384
    a = np.random.RandomState(0).rand(n, n).astype(np.float32)
    b = a.T.copy()
    a @ b                                    # warm BLAS threads
    t0 = time.perf_counter()
    for _ in range(reps):
        a @ b
    flops = 2.0 * n * n * n * reps / (time.perf_counter() - t0)

    big = np.random.RandomState(1).rand(1 << 22).astype(np.float32)  # 16 MiB
    big.copy()
    t0 = time.perf_counter()
    for _ in range(reps):
        big.copy()
    bw = 2.0 * big.nbytes * reps / (time.perf_counter() - t0)  # read+write
    return Peaks(flops_per_s=flops, hbm_bytes_per_s=bw)


def _calibrate_card(dev: torch.device, reps: int) -> Peaks:
    """Two probes timed on the card with CUDA events: a device-to-device
    copy of 1 GiB (read plus write; far past the 50 MB L2) and an 8192^3
    float32 product with TF32 off, so the rate is the float32 one the
    stencil kernel runs at. TF32 is restored afterwards."""
    with torch.cuda.device(dev):
        src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
        src.uniform_()
        dst = torch.empty_like(src)
        ms = event_ms(lambda: dst.copy_(src), iters=reps)
        bw = 2.0 * src.nbytes / (ms / 1e3)
        del src, dst
        n = 8192
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.rand((n, n), generator=gen, device=dev)
        b = torch.rand((n, n), generator=gen, device=dev)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ms = event_ms(lambda: torch.mm(a, b), iters=reps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        flops = 2.0 * n * n * n / (ms / 1e3)
    return Peaks(flops_per_s=flops, hbm_bytes_per_s=bw)


def calibrate(device: str | torch.device = "cuda", reps: int = 5) -> Peaks:
    """Measure the device's achievable peaks with two probes.

    On the card (the default) a float32 product bounds the flops peak
    and a device-to-device copy the memory-bandwidth peak, both timed
    with CUDA events. ``device="cpu"`` keeps the JAX package's numpy
    probes of the host. A missing card raises; nothing falls back.
    """
    dev = _device.resolve_device(device)
    if dev.type == "cpu":
        return _calibrate_host(reps)
    return _calibrate_card(dev, reps)


def classify(flops: float, bytes_moved: float, peaks: Peaks) -> dict:
    """Roofline-style classification of one executor call.

    Returns ``{"bound": "dma" | "compute", "t_compute_s", "t_memory_s",
    "intensity"}`` — DMA-bound when the memory-transfer term is at least
    the compute term at the given peaks (ties classify as DMA-bound:
    at the ridge point, transfers are what overlap would hide).
    """
    t_comp = flops / peaks.flops_per_s if peaks.flops_per_s else 0.0
    t_mem = (bytes_moved / peaks.hbm_bytes_per_s
             if peaks.hbm_bytes_per_s else 0.0)
    return {
        "bound": "dma" if t_mem >= t_comp else "compute",
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "intensity": flops / bytes_moved if bytes_moved else 0.0,
    }


# ------------------------------------------------------------- cost side
def _frames_per_call(ex) -> int:
    return getattr(ex, "batch", None) or getattr(ex, "chunk", None) or 1


def executor_cost(ex) -> dict:
    """Counted cost of one call of a frame or video executor.

    ``{"flops", "bytes_accessed", "arg_bytes", "out_bytes",
    "temp_bytes"}`` per *call* (divide by batch/chunk for per-frame), the
    JAX package's keys. ``flops`` are the float32 operations of
    :func:`~repro_torch.kernels.stencil_pipeline.launch_work`;
    ``bytes_accessed`` the bytes the launch loads and stores as its
    geometry dictates (:func:`~repro_torch.kernels.stencil_pipeline.
    launch_traffic`: every CTA's strip with its left halo, its band with
    its top halo, every history tap of every frame), where
    ``launch_work``'s bytes count each pixel once. ``arg_bytes`` and
    ``out_bytes`` are the launch's feed and state tensors and its
    outputs, ``temp_bytes`` a video executor's state roll. All are
    counts, not measurements.
    """
    prog = ex.program
    frames = _frames_per_call(ex)
    _, ops = launch_work(prog, frames)
    px = prog.h * prog.w * 4
    depths = prog.dag.temporal_depths()
    state = sum((depths[p] - 1) * px for p in prog.states)
    return {"flops": float(ops),
            "bytes_accessed": float(launch_traffic(prog, frames)),
            "arg_bytes": len(prog.feeds) * frames * px + state,
            "out_bytes": (1 + len(prog.frame_outs)) * frames * px,
            "temp_bytes": getattr(ex, "state_roll_bytes", 0)}


# ----------------------------------------------------------- timing side
@dataclasses.dataclass(frozen=True)
class MeasuredPerf:
    """Steady-state measurement of one executor at one shape.

    ``last`` holds the timed loop's last call, ``(inputs, state, output)``
    (``state`` the frame rings it read, None for a frame executor), so a
    caller can hold the measured output against a reference; it is not
    part of :meth:`to_dict`.
    """
    pipeline: str
    h: int
    w: int
    frames: int
    wall_s: float                   # timed-loop wall clock
    fps: float                      # frames (not batches) per second
    flops_per_frame: float | None   # from executor_cost, per frame
    bytes_per_frame: float | None
    last: tuple | None = dataclasses.field(default=None, repr=False,
                                           compare=False)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "last"}


def _block(out: torch.Tensor) -> None:
    """Wait for the device that holds ``out``."""
    _device.synchronize(out.device)


def timed_stream(call: Callable, stream: Sequence, settle: int = 2,
                 per_frame_sleep_s: float = 0.0) -> tuple[float, object]:
    """Run ``call`` over ``stream`` and return (seconds, last output).

    The shared steady-state timing loop: the first ``settle`` items run
    un-timed to absorb build and allocator warm-up, then every item is
    dispatched and waited for (the device is synchronised after each
    call). ``per_frame_sleep_s`` is the regression gate's
    fault-injection seam: a deliberate stall per item that a healthy
    gate must flag.
    """
    for fr in stream[:settle]:
        _block(call(fr))
    t0 = time.perf_counter()
    out = None
    for fr in stream:
        out = call(fr)
        _block(out)
        if per_frame_sleep_s > 0.0:
            time.sleep(per_frame_sleep_s)
    return time.perf_counter() - t0, out


def measure_executor(ex, frames: int, rng: np.random.RandomState,
                     settle: int = 2,
                     per_frame_sleep_s: float = 0.0) -> MeasuredPerf:
    """Steady-state measurement of a frame or video executor.

    Frame executors stream independent frames; video executors carry
    their frame-ring state through the loop (the steady-state serving
    shape). ``frames // (batch or chunk)`` calls are timed, after the
    first ``settle`` of them ran once un-timed. The per-call counts of
    :func:`executor_cost` are normalized to per-frame using the
    executor's batch/chunk.

    Every call's frames are a host buffer of their own, so no call
    copies from memory that an earlier call left in the host's caches.
    The first call's are drawn from ``rng``, call ``i``'s are those
    rolled by ``i`` columns: at 1080p a draw per call costs the host
    more than the call it feeds.
    """
    h, w = ex.h, ex.w
    batch = getattr(ex, "batch", None)
    chunk = getattr(ex, "chunk", None)
    is_video = hasattr(ex, "init_state")
    per_call = (batch or chunk or 1)
    n_calls = max(1, frames // per_call)

    names = ex.dag.input_stages()
    shape = ((per_call, h, w) if (batch or chunk) else (h, w))
    first = {n: rng.rand(*shape).astype(np.float32) for n in names}
    stream = [{n: np.roll(a, i, axis=-1) for n, a in first.items()}
              for i in range(n_calls)]
    last: list = [None]

    if is_video:
        state_box = [ex.init_state()]

        def call(fr):
            state = state_box[0]
            out, state_box[0] = ex(fr, state)
            last[0] = (fr, state, out)
            return out
    else:
        def call(fr):
            out = ex(fr)
            last[0] = (fr, None, out)
            return out

    wall, _ = timed_stream(call, stream, settle=settle,
                           per_frame_sleep_s=per_frame_sleep_s)
    cost = executor_cost(ex)
    return MeasuredPerf(
        pipeline=ex.dag.name, h=h, w=w, frames=n_calls * per_call,
        wall_s=wall, fps=n_calls * per_call / wall,
        flops_per_frame=cost["flops"] / per_call,
        bytes_per_frame=cost["bytes_accessed"] / per_call,
        last=last[0])


# ------------------------------------------------------------ trace side
def step_breakdown(trace_data: dict, pipeline: str) -> dict | None:
    """Queue-wait / assemble / execute split for one pipeline's steps.

    Reads a Chrome-trace dict (``export.to_chrome_trace`` output or a
    ``--trace`` file) and aggregates, over every ``engine.step`` span
    whose ``pipeline`` attr matches: the summed queue wait (span attr,
    clocked by the engine), the total durations of the nested
    ``engine.assemble`` / ``engine.execute`` children, and the step
    *self* time left over (batching, delivery, metrics — computed with
    the flame summary's containment arithmetic). Returns seconds, or
    None when the trace holds no matching step spans; the returned
    parts feed :func:`repro_torch.perf.model.exact_fractions` so the
    report's time split provably partitions the step total.
    """
    spans = _span_rows(trace_data)
    if not spans:
        return None
    self_us = _self_times_us(spans)
    step_us = queue_s = 0.0
    parts_us = {"assemble": 0.0, "execute": 0.0, "step_self": 0.0}
    n_steps = 0
    for e, s in zip(spans, self_us):
        if (e.get("args") or {}).get("pipeline") != pipeline:
            continue
        if e["name"] == "engine.step":
            n_steps += 1
            step_us += float(e["dur"])
            parts_us["step_self"] += s
            queue_s += float(e["args"].get("queue_wait_s", 0.0))
        elif e["name"] == "engine.assemble":
            parts_us["assemble"] += float(e["dur"])
        elif e["name"] == "engine.execute":
            parts_us["execute"] += float(e["dur"])
    if n_steps == 0:
        return None
    return {
        "n_steps": n_steps,
        "step_s": step_us / 1e6,
        "queue_wait_s": queue_s,
        "assemble_s": parts_us["assemble"] / 1e6,
        "execute_s": parts_us["execute"] / 1e6,
        "step_self_s": parts_us["step_self"] / 1e6,
    }
