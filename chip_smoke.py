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
               the fused stencil kernel's shared library, the four of
               payload programs);
  3. kernel  — the fused stencil kernel against its plain version for the
               7 pipelines x R in {1, 8} x four frame shapes, single-frame
               and batched (B=4, last slot an idle zero frame); then NaN
               frames (NaN sprinkled in, and NaN on a grid that puts one
               in every nms window) through the 4 pipelines whose payload
               bodies take a max or a clamp (canny-s, canny-m, harris-s,
               denoise-m) at depths 1 and 2, NaN positions equal and
               every other bit equal;
  4. serve   — the spatial path, with the kernel's launch count over it,
               throughput, and per-pipeline kernel (per call and device
               time) / plain / bound times at B=4, 1080p, R=8, with the
               launch's threads, shared memory and CTAs per SM;
 4b. unorm8  — the decode of 8-bit frames (``kernels.unorm8``) on its main
               path: ``FrameEngine(pixels="unorm8")`` serving 3840x2160
               uint8 frames of the 7 pipelines in batches of 4, twice
               over (the first frames of a run by ``torch.as_tensor``,
               the later ones staged ahead by the engine's stager while
               the host stays busy), traced:
               the decode's launches counted from zero over that run, one
               ``engine.unorm8`` span a launch inside ``engine.assemble``,
               ``h2d_bytes`` a byte a pixel, every served frame against
               the plain stencil version on the table-decoded frame; the
               kernel against ``decode_plain`` on all 256 values, on the
               path's (4, 2160, 3840) batch and on an odd, misaligned
               shape; kernel (per call and device time) / plain / bound
               (5 B a pixel over the data sheet's bandwidth) times and
               those of ``torch.div(raw, 255.0)``, with the byte values
               whose quotient it rounds otherwise than the table; then
               ``VideoEngine(pixels="unorm8")`` serving a 3840x2160 uint8
               stream a video pipeline, a chunk of 4 frames and then
               single frames, traced (a decode launch and an
               ``engine.unorm8`` span a hand-over, a byte a pixel across),
               every output against the plain version over the decoded
               stream;
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
 11. resilience — both engines in resilient mode at 1080p: (a) fault
               free over the 7 spatial and the 4 video pipelines (2
               streams of 16 frames each) at depths 1 and 2, every frame
               on the primary rung with no retry and equal bit for bit to
               the strict engine's, with the kernel's launches counted
               from zero; (b) every compile broken: the reference rung
               serves the spatial frames on the card bit for bit as the
               kernel does, and each video stream (an internal temporal
               producer too) rides a blackout on the reference rung and
               resumes on the kernel within 32 ULP of the plain version;
               (c) a seeded storm of every fault kind through both
               engines with the telemetry collector running: the books
               balance with one outcome per offered frame, every served
               frame within 8 ULP of the plain version, the alert
               transitions; (d) the storm's trace exported and validated.
               Also the host time of ``screen_frames`` per 1080p request,
               the p50/p99 latency of (a) against the strict engine's,
               the reference rung's time per frame and the time to
               rebuild the 7 executors after an eviction storm;
 12. perf    — the perf lab and the memory trace at 1080p, R=8: for the
               7 spatial pipelines (B=4, prefetch depths 1 and 2) and the
               4 video pipelines (chunk 4) the analytic model
               (``perf.model.predict``), ``perf.measure.measure_executor``
               on the cache's executors (16 frames each; the last output
               against the plain version), the counted launch cost, the
               card's peaks calibrated and from the data sheet, and two
               ``perf_report/v1`` reports (depths 1 and 2) that must
               validate, printed as tables; a traced ``FrameEngine``
               burst over the 7 pipelines whose ``step_breakdown`` gives
               every one a time split summing to exactly 1.0; a
               ``memtrace/v1`` per pipeline and depth at the served shape
               (in worker processes), each valid and holding the served
               program's shared-memory ring bytes, merged onto the
               burst's trace; a ledger row appended to a temporary file
               and read back, the run gated against itself (quiet) and
               against a re-measure with an injected 2x slowdown (must
               fire);
 13. lm_serve — the LM serving stack (``repro_torch.models``,
               ``repro_torch.serve``; no hand-written kernel lies on it):
               (a) gemma3-1b at full config (26 layers, d 1152, vocab
               262144, bf16), random weights from a seeded generator on
               the card, served through ``Engine`` (4 slots of 1024
               positions, 6 requests with prompts of 4-700 tokens, 32 new
               tokens each, two sampled; the longest crosses the local
               window of 512): the KV plan, parameters, weight bytes, peak
               memory, prefill tokens/s, step times by active slots,
               generated tokens/s, the decode step at 4 slots per call and
               on the device against its bytes bound (the weights read
               once over the calibrated bandwidth); (b) the same config in
               float32: ``decode_step`` over a 600-token sequence against
               ``forward`` (rtol 2e-4, atol 2e-4, the JAX package's bound
               for it), and the engine's greedy tokens against a
               hand-written ``decode_step`` loop; (c) a request's tokens
               alone and with a second request admitted after its second
               step, equal, its cache rows and state untouched bit for bit
               (gemma3-1b, rwkv6-1.6b); (d) granite-moe-1b-a400m,
               rwkv6-1.6b and recurrentgemma-2b at full config in bf16
               through the engine (3 requests, 16 tokens each), and in
               float32 with one super-block, decode against forward as in
               (b); hubert-xlarge's forward on a (2, 256) batch, finite;
 14. lm_train — LM training (``repro_torch.train``, ``data``,
               ``checkpointing``, ``launch.train``; no hand-written kernel
               lies on it): (1) a reduced gemma3-1b in float32 with remat,
               3 steps from one state on the card and on the CPU, the same
               TokenStream batches: loss, grad norm, master copies and
               moments within rtol 1e-4 / atol 1e-6 (but for at most
               0.05% of the elements, masters within Adam's step bound);
               (2) gemma3-1b at full config (26 layers, d 1152, vocab
               262144, ~1.0 B parameters, bf16 with float32 master copies
               and moments, remat per super-block) for 10 steps at B=1,
               S=4096 (banded local and flash global attention, 8
               cross-entropy chunks): every loss and grad norm finite, the
               step-0 loss within 1% of a float32 loss of the same
               masters, the loss falling; per step wall and optimizer ms,
               tokens/s, model TFLOP/s and its share of the data sheet's
               dense bf16 rate, peak memory; the device time of a step and
               its top kernels; (3) the supervisor drill (12 float32
               steps, an async checkpoint every 4, a Preemption at step 5
               and a HardwareFailure at step 9): 2 restarts, every loss
               within rtol 1e-5 of an uninterrupted run's, save and
               restore seconds; (4) the training CLI in a subprocess, its
               ``loss:`` line;
 15. launch — the launch helpers, ``distributed/`` and the dry run (no
               hand-written kernel lies on it): (a) the dry run over all
               40 cells on the card's (1, 1) mesh, counted on meta (33
               run, 7 skip; per cell arg_bytes, fits, FLOPs, dominant
               term; no card memory allocated); (b) gemma3-1b x
               decode_32k at full config in bf16 (B=128, caches of 32,768
               positions, every row at the last one): the allocation
               within 1% of the dry run's arg_bytes, 1 warm and 5 timed
               steps, peak memory above arg_bytes (the temp bytes the dry
               run cannot give), step ms against the roofline memory term,
               finite logits; (c) ``pipeline_forward`` over the 4
               super-blocks of gemma3-1b's first segment in float32, 6
               microbatches of (1, 512), within 1e-5 of the super-blocks
               in sequence; (d) the training CLI at full config (3 steps,
               B=1, S=4096) with ``--distributed`` (NCCL, one rank) and
               without: losses bit for bit; (e)
               ``examples/train_lm_torch.py --full --steps 100``: its
               learning assert;
 16. examples — the twins of the examples and tools through their
               ``main(argv)`` at full width, in a temporary directory:
               ``examples/{quickstart, stream_frames, stream_video,
               overlap_depth, tune_pipeline, memtrace_pipeline,
               trace_serving, imagen_dse, serve_lm}_torch.py --full``
               (1080p frames and 1920-wide plans; gemma3-1b at full
               config in bf16), every frame they serve at 0 ULP against
               the plain version, one line per twin with its seconds,
               frames or tokens and K1 launches by instantiation;
               ``tools/obs_report_torch.py`` over this run's storm trace
               and telemetry snapshot, perf reports, memory traces and
               the twins' own files (``--validate`` and each renderer,
               exit codes checked); ``tools/debug_memory_torch.py`` on
               gemma3-1b x train_4k;
 17. expr    — stage functions written in torch, lowered and compiled
               into the kernel (each program with such a stage launches
               from a library of its own: csrc/ plus its generated
               bodies), at 1080p, B=4, R=8: (0) every library the phase
               launches from but the user pipelines', built in one
               parallel nvcc wave first (a line with the wave's seconds,
               each library's nvcc seconds and the ptxas report of those
               built in this run, and the registers and local memory of
               every library's entry, read from the loaded library); (a)
               the bare form of the 7 spatial pipelines (every payload
               replaced by its eager function) at depths 1 and 2 and of
               the 4 video pipelines in chunks of 4 over random
               frame-ring states, each equal to the payload form and the
               plain version; (b) the fuzz harness's DAGs, seeds 0-7,
               convolutions as payloads and lowered, spatial and
               temporal, against the plain version; (c) five ops
               pipelines that with the user pipelines run every
               instruction: the "rounding" and "transcendental" ones pick
               an op per pixel by its left neighbour, and a line gives
               each op's worst ULP (rounding, casts and window indices 0,
               the library functions within EXPR_BOUND_ULP); (d) the main path: a user pipeline through a
               resilient FrameEngine (fault free, every frame on the
               primary rung) and its temporal form through a resilient
               VideoEngine, both with an attempt timeout shorter than
               one nvcc build and their libraries not yet built, so
               that the first submit and open_stream build them outside
               the fallback ladder (the first frame's and first chunk's
               wall seconds, builds included), the kernel's counts set
               to 0 just before and read just after; (e) per pipeline
               the expression form's times (per call and on the device)
               beside the payload form's, its plain and bound times,
               instructions, its library's registers and local memory,
               shared memory and CTAs per SM beside the payload form's;
               the shared library's registers and local memory per
               instantiation;
 18. kernels — one line per kernel path: route, source, launches, error
               and times (the K1 entries with device time, registers,
               spill bytes, shared memory and CTAs per SM, and their
               launches in the resilient run, the perf phase and the
               examples phase; the expression entry with the payload
               form's times beside its own, the build wave's seconds,
               its libraries' registers and local memory, and the user
               pipelines' first frame and chunk).

Tolerance: bitwise (0 ULP) for the stencil kernel at every depth, with
payload and expression stages, and for conv2d, and for every frame the resilient engines serve fault free or
off the spatial reference rung (the reference rung is the kernel's plain
version); 32 ULP for a video stream resumed from rings the reference
rung rebuilt, and 8 ULP in the storm, as the JAX package's resilience
tests hold theirs. They round every product and sum on their own in the plain
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
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the card's name and data-sheet peaks (the bounds' one home), the gate's
# bands
from repro_torch.perf.ledger import Band  # noqa: E402
from repro_torch.perf.measure import card_info, datasheet_peaks  # noqa: E402
from repro_torch._device import synchronize  # noqa: E402
# per call (CUDA events) and device (profiler) milliseconds
from repro_torch.perf.timing import device_ms  # noqa: E402
from repro_torch.perf.timing import event_ms as cuda_ms  # noqa: E402
# the bf16 data-sheet rate's one home; the attention FLOPs of a stack
from repro_torch.launch.mesh import H100_BF16_DENSE_FLOPS  # noqa: E402
from repro_torch.launch.dryrun import attention_flops  # noqa: E402

TOLERANCE_ULP = 0
# the registered pipelines whose payload bodies take a max or a clamp,
# and the NaN grid pitch (rows, columns) that puts a NaN in every window
# of their first nms stage (denoise-m: finite blurs beside NaN
# Laplacians), as tests/test_torch_nan.py sets them
NAN_PITCH = {"canny-s": (9, 9), "canny-m": (7, 7), "harris-s": (4, 6),
             "denoise-m": (7, 7)}
# the expression body against eager PyTorch on the card where the two
# round differently (core/expr.py): sum and mean add in another order (the
# card's mean is the sum times the float32 reciprocal of the count), exp,
# log and tanh; ULP at the array's scale
EXPR_BOUND_ULP = 4
# the user pipelines' attempt timeout on the expr phase's main path: under
# one nvcc build of a library (4.4 s or more on the H100's host), well
# over a first frame whose libraries are built
ATTEMPT_TIMEOUT_S = 3.0
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
# resilience phase: the storm's seed, frame requests, video frames per
# stream, and fault rates (high enough that every kind fires)
SOAK_SEED, SOAK_REQUESTS, SOAK_STREAM_FRAMES = 11, 56, 32
SOAK_DEADLINE_S = 0.25          # the SLO rules' p99 queue-wait bound
SOAK_RATES = dict(compile=0.2, executor=0.1, nan_frame=0.1,
                  shape_frame=0.08, dtype_frame=0.08, evict_storm=0.1,
                  churn=0.15)
# perf phase: frames each executor is timed over (32 calls at B=4 or
# chunk 4), the un-timed settling calls before them, the stream's seed, the
# injected slowdown of the gate's negative control, and the gate's bands
# (ratio current/baseline; the JAX package's perf lab's): the model's
# metrics are pure functions of the plans and gate exactly, throughput
# widely
PERF_FRAMES, PERF_SETTLE, PERF_SEED, PERF_SLOWDOWN = 128, 2, 5, 2.0
PERF_BANDS = [Band("predicted_cycles_total", 1.0, 1.0),
              Band("model_bytes_total", 1.0, 1.0),
              Band("smem_ring_bytes_total", 1.0, 1.0),
              Band("alloc_bits_total", 1.0, 1.0),
              Band("power_total", 0.999, 1.001),
              Band("throughput_norm", 0.2, 5.0)]
INJECT_BANDS = [Band("fps_geomean", 1 / 1.4, 1.4)]
# lm_serve phase: gemma3-1b at full width and depth through the Engine (4
# slots of 1024 positions; prompts of 4-700 tokens, the 700-token one and
# its output cross the local window of 512; two requests sampled), the
# decode-vs-forward sequence (past the window) and its bound, the JAX
# package's (tests/test_models.py:95-97), and the other families at full
# config
LM_ARCH, LM_SEED = "gemma3-1b", 3
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 4, 1024, 32
LM_PROMPTS = (4, 700, 96, 260, 31, 480)
LM_SAMPLED = (1, 4)
LM_CHECK_LEN = 600
LM_RTOL = LM_ATOL = 2e-4
LM_OTHERS = ("granite-moe-1b-a400m", "rwkv6-1.6b", "recurrentgemma-2b")
# lm_train phase: gemma3-1b; (1) a reduced float32 model (remat on) for 3
# steps on the card and on the CPU, batches of 4 x 64 (the local layers'
# banded path), the optimizer at a learning rate that shows a wrong update;
# states compared within rtol 1e-4 / atol 1e-6 but for at most 0.05% of
# the elements (Adam's sign of a gradient at rounding level is the
# rounding's), those within Adam's step bound (4 x the summed learning
# rate); (2) the full config at B=1, S=4096 (banded local layers, flash
# global ones, 8 chunks of the cross-entropy) for 10 steps, the step-0
# bf16 loss within 1% of a float32 loss of the same master copies; (3) the
# supervisor drill: 12 float32 steps of the reduced model, a checkpoint
# every 4 (async), a Preemption at step 5 and a HardwareFailure at step 9,
# every step's loss within rtol 1e-5 of an uninterrupted run's (the
# embedding backward adds with atomics on the card); (4) the CLI. The
# bf16 rate is NVIDIA's H100 SXM data sheet's, dense
LT_ARCH, LT_SEED = "gemma3-1b", 0
LT_CMP_STEPS, LT_CMP_BATCH, LT_CMP_SEQ = 3, 4, 64
LT_CMP_RTOL, LT_CMP_ATOL, LT_FEW = 1e-4, 1e-6, 5e-4
LT_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
LT_STEPS, LT_BATCH, LT_SEQ = 10, 1, 4096
LT_LOSS_RTOL = 1e-2
LT_DRILL_STEPS, LT_DRILL_EVERY, LT_DRILL_RTOL = 12, 4, 1e-5
LT_DRILL_FAILS = {5: "Preemption", 9: "HardwareFailure"}
# launch phase: (b) gemma3-1b x decode_32k at full config (bf16, B=128,
# caches of 32,768 positions, every row at the last position), its
# allocation held within 1% of the dry run's arg_bytes, 1 warm and 5
# timed steps; (c) pipeline_forward over the 4 super-blocks of gemma3-1b's
# first segment (5 local + 1 global each, d 1152) in float32, 6
# microbatches of (1, 512) tokens, within 1e-5 of the super-blocks in
# sequence (the JAX package's bound, tests/test_distributed.py); (d) the
# training CLI with and without --distributed, losses bit for bit; (e)
# examples/train_lm_torch.py --full
LA_ARCH, LA_SEED, LA_SHAPE = "gemma3-1b", 21, "decode_32k"
LA_ALLOC_RTOL, LA_WARM, LA_TIMED = 0.01, 1, 5
LA_MICRO, LA_MB_SEQ, LA_PIPE_TOL = 6, 512, 1e-5
LA_CLI = ["--arch", "gemma3-1b", "--steps", "3", "--batch", "1", "--seq",
          "4096"]
LA_EXAMPLE_STEPS = 100
# unorm8 phase: the 8-bit 4K UHD frame of the spatial7-4k-u8 deployment,
# a pool of distinct frames, the 7 pipelines' requests served twice over
U8_H, U8_W, U8_POOL, U8_ROUNDS = 2160, 3840, 8, 2
# examples phase: the twins of examples/ and tools/ through main(argv) at
# full width (--full: 1080p frames, 1920-wide plans, gemma3-1b at full
# config in bf16), in a temporary directory; debug_memory on gemma3-1b x
# train_4k
EX_FULL = ["--full", "--device", "cuda"]
EX_DEBUG = ["--arch", "gemma3-1b", "--shape", "train_4k", "--top", "10",
            "--device", "cuda"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def frames(seed: int, n: int, h: int, w: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


def nan_frames(name: str, kind: str, b: int, h: int, w: int,
               seed: int) -> np.ndarray:
    """``b`` seeded frames of values in [0, 4) with NaN pixels: 0.4% at
    seeded positions ("sprinkled") or on ``name``'s NaN_PITCH grid with
    the first and last row and column ("centres")."""
    rng = np.random.RandomState(seed)
    x = (4 * rng.rand(b, h, w)).astype(np.float32)
    if kind == "sprinkled":
        x[rng.rand(b, h, w) < 0.004] = np.nan
    else:
        py, px = NAN_PITCH[name]
        for i in range(b):
            rows = sorted({0, h - 1, *range(i % py, h, py)})
            cols = sorted({0, w - 1, *range(2 * i % px, w, px)})
            x[i][np.ix_(rows, cols)] = np.nan
    return x


def nan_equal(got: torch.Tensor, exp: torch.Tensor, where: str) -> int:
    """Fails unless ``got`` has NaN where ``exp`` has and every other bit
    equal (a NaN's payload may differ: max.NaN gives the canonical one);
    returns the NaN pixels."""
    if got.shape != exp.shape:
        fail(f"{where}: shape {tuple(got.shape)} != {tuple(exp.shape)}")
    nan = exp.isnan()
    if not torch.equal(got.isnan(), nan):
        fail(f"{where}: NaN at {int((got.isnan() != nan).sum())} other "
             f"pixels")
    bad = int((got[~nan].view(torch.int32)
               != exp[~nan].view(torch.int32)).sum())
    if bad:
        fail(f"{where}: {bad} pixels differ from the plain version")
    return int(nan.sum())


def ulp_err(got: torch.Tensor, exp: torch.Tensor) -> tuple[float, float]:
    """(max |got - exp|, that error in ULP at the array's scale)."""
    if got.shape != exp.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(exp.shape)}")
    if not torch.isfinite(got).all():
        fail("non-finite output")
    err = (got - exp).abs().max().item()
    scale = float(np.spacing(np.float32(exp.abs().max().item())))
    return err, err / scale


def nan_frames_check(dev) -> int:
    """Phase 3's NaN frames: the 4 pipelines whose payload bodies take a
    max or a clamp (PTX max.NaN / min.NaN) over frames with NaN sprinkled
    in and on their NaN_PITCH grid, at every phase-3 shape, R 1 and 8,
    depths 1 and 2, single and batched, equal to the plain version with
    NaN positions equal and every other bit equal. Returns the cases."""
    from repro_torch.core import algorithms
    from repro_torch.core.codegen import compile_pipeline
    from repro_torch.kernels import stencil_pipeline as sp
    t0 = time.perf_counter()
    nan_cases, nan_pixels = 0, 0
    for name in sorted(NAN_PITCH):
        dag = algorithms.ALGORITHMS[name]()
        for h, w in SHAPES:
            plan = compile_pipeline(dag, w)
            for pattern in ("sprinkled", "centres"):
                for r, depth in ((1, 1), (8, 1), (8, 2)):
                    for batch in (None, SERVE_B):
                        x = nan_frames(name, pattern, batch or 1, h, w,
                                       SEED + nan_cases)
                        x = torch.from_numpy(x if batch else x[0]).to(dev)
                        ex = sp.make_executor(dag, h, w, batch=batch,
                                              plan=plan, rows_per_step=r,
                                              prefetch_depth=depth,
                                              device=dev)
                        before = sp.stencil_pipeline.launches
                        got = ex({"in": x})
                        torch.cuda.synchronize()
                        if sp.stencil_pipeline.launches != before + 1:
                            fail(f"{name} NaN frames: the kernel did not "
                                 f"launch")
                        nan_pixels += nan_equal(
                            got, sp.stencil_pipeline_plain(dag, {"in": x}),
                            f"{name} {h}x{w} {pattern} NaN frames R={r} "
                            f"depth {depth} batch={batch}")
                        nan_cases += 1
    emit("kernel", part="nan_frames", pipelines=sorted(NAN_PITCH),
         cases=nan_cases, kinds=["sprinkled", "centres"],
         steps=[[1, 1], [8, 1], [8, 2]], shapes=[list(s) for s in SHAPES],
         batches=[None, SERVE_B], nan_output_pixels=nan_pixels,
         compare="NaN positions equal, every other bit equal",
         seconds=time.perf_counter() - t0)
    return nan_cases


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


def drain(eng) -> list:
    """Step an engine until nothing is queued; every result it gave."""
    out = []
    while eng.pending:
        out += eng.step()
    return out + eng.step()             # a last shed outbox


def resilience_phase(dev) -> dict:
    """Phase 11: both engines in resilient mode at 1080p. Returns the
    kernel's launches in the fault-free resilient run per K1 entry, and
    the storm's trace and telemetry snapshot."""
    from repro_torch.core import algorithms
    from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.obs import trace
    from repro_torch.obs.export import slo_summary, to_chrome_trace, \
        validate_trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.telemetry import TelemetryCollector, \
        default_slo_rules
    from repro_torch.resilience import ResilienceConfig, RetryPolicy, \
        screen_frames
    from repro_torch.resilience.chaos import FAULT_KINDS, ChaosMonkey, \
        install_chaos
    from repro_torch.video import VideoEngine, VideoFrame
    names = sorted(algorithms.ALGORITHMS)
    vnames = sorted(algorithms.VIDEO_ALGORITHMS)
    kern = sp.stencil_pipeline
    frame_in = list(frames(9000, SERVE_B * len(names), SERVE_H, SERVE_W))
    streams_in = {(n, j): frames(9100 + 10 * i + j, STREAM_FRAMES, SERVE_H,
                                 SERVE_W)
                  for i, n in enumerate(vnames)
                  for j in range(STREAMS_PER_PIPELINE)}

    def frame_engine(**kw):
        return FrameEngine(device=dev, max_batch=SERVE_B,
                           rows_per_step=SERVE_R,
                           tile_shape=(SERVE_H, SERVE_W), **kw)

    def video_engine(**kw):
        return VideoEngine(device=dev, chunk=VIDEO_CHUNK,
                           rows_per_step=SERVE_R, **kw)

    def serve_frames(eng) -> dict:
        for i, x in enumerate(frame_in):
            if eng.submit(FrameRequest(rid=i, pipeline=names[i % len(names)],
                                       frames={"in": x})) is not True:
                fail(f"request {i} refused")
        done = {c.rid: c for c in drain(eng)}
        if sorted(done) != list(range(len(frame_in))) or not all(
                hasattr(c, "output") for c in done.values()):
            fail(f"frames not all served: {list(done.values())[:3]!r}")
        return done

    def serve_streams(eng) -> dict:
        sids = {eng.open_stream(key[0], SERVE_H, SERVE_W): key
                for key in streams_in}
        done = {key: [] for key in streams_in}
        for t in range(0, STREAM_FRAMES, VIDEO_CHUNK):
            for sid, key in sids.items():
                for f in streams_in[key][t:t + VIDEO_CHUNK]:
                    if eng.submit(VideoFrame(sid, {"in": f})) is not True:
                        fail(f"stream {sid} refused a frame")
            for c in drain(eng):
                if not hasattr(c, "warm"):
                    fail(f"stream frame not served: {c!r}")
                done[sids[c.stream]].append(c)
        return done

    def primary_only(eng, served, where: str) -> None:
        rungs = {c.rung for c in served}
        if rungs != {"default"} or eng.metrics.executor_retries \
                or eng.cache.stats.compile_retries \
                or eng.metrics.fallback_frames:
            fail(f"{where}: fault-free run served rungs {sorted(rungs)} "
                 f"with {eng.metrics.executor_retries} retries, "
                 f"{eng.cache.stats.compile_retries} compile retries, "
                 f"{eng.metrics.fallback_frames} fallback frames")
        if any(c.output.device.type != "cuda" for c in served):
            fail(f"{where}: an output left the card")

    def pct_ms(done) -> list:
        lat = [c.latency_s for c in done]
        return [float(v) * 1e3 for v in np.percentile(lat, [50, 99])]

    # ------------------------------------------------- (a) fault free
    def turns(strict, res, serve, flat):
        """Serve in turns strict, resilient, resilient, strict; returns
        per engine its turns' (results, execute seconds), and the kernel's
        launches in the resilient turns, counted from zero."""
        out, n = {"strict": [], "resilient": []}, 0
        for label in ("strict", "resilient", "resilient", "strict"):
            eng = strict if label == "strict" else res
            if label == "resilient":
                kern.launches = kern.prefetch_launches = 0
            e0 = eng.metrics.execute_s
            done = flat(serve(eng))
            torch.cuda.synchronize()
            if label == "resilient":
                n += kern.prefetch_launches if eng.prefetch_depth > 1 \
                    else kern.launches
            out[label].append((done, eng.metrics.execute_s - e0))
        return out, n

    def compare(out, depth: int, what: str) -> dict:
        want = out["strict"][0][0]
        for done, _ in out["resilient"] + out["strict"][1:]:
            if [c.rid for c in done] != [c.rid for c in want] or not all(
                    torch.equal(a.output, b.output)
                    for a, b in zip(done, want)):
                fail(f"{what} depth {depth}: a turn differs from the "
                     f"strict engine's first")
        return {label: [{"latency_ms_p50_p99": pct_ms(done),
                         "execute_ms_per_frame": ex / len(done) * 1e3}
                        for done, ex in runs]
                for label, runs in out.items()}

    def by_rid(done: dict) -> list:
        return [done[rid] for rid in sorted(done)]

    def by_stream(done: dict) -> list:
        for key, cs in done.items():
            if [c.index for c in cs] != list(range(STREAM_FRAMES)):
                fail(f"stream {key} delivered {[c.index for c in cs]}")
        return [c for key in sorted(done) for c in done[key]]

    fault_free, launches, strict_d1, recompile_s = {}, {}, None, None
    for depth in (1, 2):
        strict = frame_engine(prefetch_depth=depth)
        res = frame_engine(prefetch_depth=depth,
                           resilience=ResilienceConfig())
        for eng in (strict, res):   # the server builds its executors first
            for name in names:
                eng.cache.executor_for(name, SERVE_H, SERVE_W, batch=SERVE_B,
                                       rows_per_step=SERVE_R,
                                       prefetch_depth=depth)
        out, n_frames = turns(strict, res, serve_frames, by_rid)
        for done, _ in out["resilient"]:
            primary_only(res, done, f"frames depth {depth}")
        frame_turns = compare(out, depth, "frames")
        if depth == 1:
            strict_d1 = {c.rid: c for c in out["strict"][0][0]}
            n_ev = res.cache.evict_executors()
            t0 = time.perf_counter()
            for name in names:
                res.cache.executor_for(name, SERVE_H, SERVE_W, batch=SERVE_B,
                                       rows_per_step=SERVE_R)
            recompile_s = {"executors": n_ev,
                           "seconds": time.perf_counter() - t0}
        del out
        vstrict = video_engine(prefetch_depth=depth)
        vres = video_engine(prefetch_depth=depth,
                            resilience=ResilienceConfig())
        for eng in (vstrict, vres):
            for name in vnames:
                eng.cache.video_executor_for(name, SERVE_H, SERVE_W,
                                             chunk=VIDEO_CHUNK,
                                             rows_per_step=SERVE_R,
                                             prefetch_depth=depth)
        out, n_video = turns(vstrict, vres, serve_streams, by_stream)
        for done, _ in out["resilient"]:
            primary_only(vres, done, f"video depth {depth}")
        video_turns = compare(out, depth, "video")
        del out
        if n_frames == 0 or n_video == 0:
            fail(f"depth {depth}: the resilient run launched the kernel "
                 f"{n_frames} (frames) and {n_video} (video) times")
        launches[depth] = (n_frames, n_video)
        fault_free[f"depth{depth}"] = {
            "frames_per_turn": len(frame_in),
            "video_frames_per_turn": len(streams_in) * STREAM_FRAMES,
            "turns": "strict, resilient, resilient, strict",
            "launches_frames": n_frames, "launches_video": n_video,
            "max_ulp_vs_strict": 0.0, "frames": frame_turns,
            "video": video_turns}

    # --------------------------------------------- (b) reference rung
    def broken(label):
        raise RuntimeError(f"compile broken on purpose: {label}")

    ref_cfg = ResilienceConfig(retry=RetryPolicy(max_attempts=1),
                               breaker_failures=1, breaker_reset_s=0.0)
    reng = frame_engine(resilience=ref_cfg)
    reng.cache.compile_hook = broken
    t0 = time.perf_counter()
    got = serve_frames(reng)
    ladder_s = time.perf_counter() - t0
    for rid, c in got.items():
        if c.rung != "reference" or c.output.device.type != "cuda":
            fail(f"frame {rid} served by {c.rung} on {c.output.device}")
        if not torch.equal(c.output, strict_d1[rid].output):
            fail(f"reference rung frame {rid} differs from the kernel's")
    if reng.metrics.fallback_frames != len(got):
        fail(f"{reng.metrics.fallback_frames} fallback frames counted "
             f"for {len(got)}")
    ref_ms = {}
    for i, name in enumerate(names):        # the rung alone, one batch
        batch = [FrameRequest(rid=j, pipeline=name,
                              frames={"in": frame_in[j]})
                 for j in range(i, len(frame_in), len(names))]
        reng._run_reference(name, batch)
        t0 = time.perf_counter()
        reng._run_reference(name, batch)
        ref_ms[name] = (time.perf_counter() - t0) / len(batch) * 1e3
    del got, strict_d1

    vcache = PlanCache(device=dev, retry=ref_cfg.retry, pipelines={
        **algorithms.VIDEO_ALGORITHMS, "tinternal": tinternal})
    veng = video_engine(cache=vcache, resilience=ref_cfg)
    resumed = {}
    for i, name in enumerate(vnames + ["tinternal"]):
        vid = frames(9300 + i, STREAM_FRAMES, SERVE_H, SERVE_W)
        sid = veng.open_stream(name, SERVE_H, SERVE_W)
        outs, rungs, black_s = [], [], 0.0
        for t in range(0, STREAM_FRAMES, VIDEO_CHUNK):
            if t == VIDEO_CHUNK:            # blackout: chunks 1 and 2
                vcache.compile_hook = broken
                vcache.evict_executors()
            elif t == 3 * VIDEO_CHUNK:      # recovery
                vcache.compile_hook = None
            for f in vid[t:t + VIDEO_CHUNK]:
                if veng.submit(VideoFrame(sid, {"in": f})) is not True:
                    fail(f"{name}: a frame was refused")
            t0 = time.perf_counter()
            for c in drain(veng):
                if not hasattr(c, "warm"):
                    fail(f"{name}: frame not served: {c!r}")
                outs.append(c.output)
                rungs.append(c.rung)
            if vcache.compile_hook is not None:
                black_s += time.perf_counter() - t0
        want_rungs = ["default"] * VIDEO_CHUNK + ["reference"] * (
            2 * VIDEO_CHUNK) + ["default"] * (STREAM_FRAMES
                                              - 3 * VIDEO_CHUNK)
        if rungs != want_rungs:
            fail(f"{name}: rungs {rungs}")
        if any(o.device.type != "cuda" for o in outs):
            fail(f"{name}: an output left the card")
        exp = ref.video_pipeline_ref(vcache.dag_for(name),
                                     {"in": torch.from_numpy(vid).to(dev)})
        err, ulp = ulp_err(torch.stack(outs), exp)
        if ulp > 32:
            fail(f"{name}: resumed stream differs from video_pipeline_ref "
                 f"by {ulp} ULP")
        resumed[name] = {"max_abs_err": err, "max_ulp": ulp,
                         "blackout_ms_per_frame":
                             black_s / (2 * VIDEO_CHUNK) * 1e3}
        veng.close_stream(sid)

    # ------------------------------------------------- (c) the storm
    reg = MetricsRegistry()

    def soak_cfg():
        return ResilienceConfig(
            retry=RetryPolicy(max_attempts=2, base_delay_s=1e-4,
                              seed=SOAK_SEED),
            breaker_failures=2, breaker_reset_s=0.05,
            default_deadline_s=SOAK_DEADLINE_S)
    feng = frame_engine(registry=reg, max_pending=8, resilience=soak_cfg())
    seng = video_engine(registry=reg, max_pending=8, resilience=soak_cfg())
    fmonkey = ChaosMonkey(seed=SOAK_SEED, **{
        k: v for k, v in SOAK_RATES.items() if k != "churn"})
    vmonkey = ChaosMonkey(seed=SOAK_SEED + 1, **SOAK_RATES)
    install_chaos(feng.cache, fmonkey)
    install_chaos(seng.cache, vmonkey)
    col = TelemetryCollector(
        reg, period_s=0.05,
        rules=default_slo_rules("frame_engine", window_s=5.0)
        + default_slo_rules("video_engine", window_s=5.0))
    rng = np.random.RandomState(SOAK_SEED)
    sent, fed, fout, vout = {}, {}, [], []
    trace.clear()
    trace.enable()
    t0 = time.perf_counter()
    try:
        with col:
            for rid in range(SOAK_REQUESTS):
                x = rng.rand(SERVE_H, SERVE_W).astype(np.float32)
                fr, _ = fmonkey.corrupt({"in": x})
                fmonkey.maybe_storm(feng.cache)
                name = names[rid % len(names)]
                r = feng.submit(FrameRequest(rid=rid, pipeline=name,
                                             frames=fr))
                if r is True:
                    sent[rid] = (name, fr["in"])
                else:
                    fout.append(r)
                if rid % 3 == 2:
                    fout += feng.step()
            fout += drain(feng)
            sids = [seng.open_stream(n, SERVE_H, SERVE_W)
                    for n in ("tmotion-t", "tunsharp-t")]
            for sid in sids:
                fed[sid] = []
            for rid in range(2 * SOAK_STREAM_FRAMES):
                k = rid % 2
                if vmonkey.roll("churn"):
                    vout += seng.close_stream(sids[k], cancel=True)
                    sids[k] = seng.open_stream(
                        ("tmotion-t", "tunsharp-t")[k], SERVE_H, SERVE_W)
                    fed[sids[k]] = []
                x = rng.rand(SERVE_H, SERVE_W).astype(np.float32)
                fr, _ = vmonkey.corrupt({"in": x})
                vmonkey.maybe_storm(seng.cache)
                r = seng.submit(VideoFrame(sids[k], fr, rid=rid))
                if r is True:
                    fed[sids[k]].append((rid, fr["in"]))
                else:
                    vout.append(r)
                if rid % 3 == 2:
                    vout += seng.step()
            vout += drain(seng)
            col.sample_once()
        events = trace.events()
    finally:
        trace.disable()
        trace.clear()
    soak_s = time.perf_counter() - t0
    books = {}
    for label, eng, outs, n in (("frames", feng, fout, SOAK_REQUESTS),
                                ("video", seng, vout,
                                 2 * SOAK_STREAM_FRAMES)):
        rec = eng.metrics.reconcile()
        if not rec["balanced"] or rec["in_flight"] or rec["offered"] != n \
                or sorted(o.rid for o in outs) != list(range(n)):
            fail(f"soak {label}: books do not balance: {rec}, "
                 f"{len(outs)} outcomes for {n} offered")
        kinds = {}
        for o in outs:
            kind = "completed" if hasattr(o, "output") else \
                type(o).__name__
            kinds[kind] = kinds.get(kind, 0) + 1
        books[label] = {**rec, "outcomes": kinds,
                        "fallback_frames": eng.metrics.fallback_frames,
                        "retries": eng.metrics.executor_retries}
    soak_ulp = 0.0
    for o in fout:
        if hasattr(o, "output"):
            name, x = sent[o.rid]
            _, ulp = ulp_err(o.output, sp.stencil_pipeline_plain(
                feng.cache.dag_for(name), {"in": torch.from_numpy(x)
                                           .to(dev)}))
            soak_ulp = max(soak_ulp, ulp)
    vdone = {o.rid: o for o in vout if hasattr(o, "output")}
    if not vdone or not any(hasattr(o, "output") for o in fout):
        fail("the storm served no frame")
    for sid, items in fed.items():
        eff = [(rid, x) for rid, x in items if rid in vdone]
        if eff:
            exp = ref.video_pipeline_ref(
                seng.cache.dag_for(vdone[eff[0][0]].pipeline),
                {"in": torch.from_numpy(np.stack([x for _, x in eff]))
                 .to(dev)})
            _, ulp = ulp_err(torch.stack([vdone[rid].output
                                          for rid, _ in eff]), exp)
            soak_ulp = max(soak_ulp, ulp)
    if soak_ulp > 8:
        fail(f"the storm served a frame {soak_ulp} ULP off the plain "
             f"version")
    injected = fmonkey.injected + vmonkey.injected
    if any(injected[k] == 0 for k in FAULT_KINDS):
        fail(f"the storm missed a fault kind: {dict(injected)}")
    alerts = [{"rule": a["rule"], "fired_count": a["fired_count"],
               "firing": a["firing"], "transitions": a["transitions"]}
              for a in col.alert_snapshot()]

    # ------------------------------------------------------ (d) export
    data = to_chrome_trace(events)
    errs = validate_trace(data)
    if errs:
        fail(f"the storm's trace does not validate: {errs[:5]}")

    screen = {"repeated": [], "distinct": []}
    for kind, xs in (("repeated", [frame_in[0]] * 20),
                     ("distinct", frame_in)):
        for x in xs:
            t0 = time.perf_counter()
            if screen_frames({"in": x}, {"in"}) is not None:
                fail("a clean 1080p frame failed screening")
            screen[kind].append(time.perf_counter() - t0)
    totals = {k: sum(b[k] for b in books.values())
              for k in ("offered", "completed", "shed", "rejected",
                        "cancelled", "failed", "fallback_frames")}
    emit("resilience", shape=[SERVE_H, SERVE_W], batch=SERVE_B,
         chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
         fault_free=fault_free,
         reference={"frames": len(frame_in),
                    "ladder_s": ladder_s,
                    "ladder_ms_per_frame": ladder_s / len(frame_in) * 1e3,
                    "engine_execute_ms_per_frame":
                        reng.metrics.execute_s / len(frame_in) * 1e3,
                    "rung_ms_per_frame": ref_ms,
                    "video_resumed": resumed},
         soak={**totals, "seconds": soak_s, "books": books,
               "injected": dict(injected), "max_ulp": soak_ulp,
               "tolerance_ulp": 8, "alerts": alerts,
               "telemetry_samples": col.samples_taken},
         export={"events": len(events), "errors": len(errs),
                 "slo": slo_summary(data)},
         screen_ms_1080p={k: {"median": float(np.median(v)) * 1e3,
                              "max": max(v) * 1e3}
                          for k, v in screen.items()},
         recompile_after_evict_storm=recompile_s)
    # the storm's trace and telemetry snapshot, for the examples phase's
    # obs_report run
    return {"spatial": launches[1][0], "temporal": launches[1][1],
            "prefetch": sum(launches[2]),
            "artifacts": {"storm_trace": data,
                          "storm_telemetry": col.snapshot()}}


def _memtrace_job(job: tuple[str, int]) -> dict:
    """One ``PlanCache.memtrace_for`` at the served shape, in a worker
    process: the cycle sampler is host work (1-3 s a 1080p pipeline) and
    touches no device."""
    from repro_torch.imaging import PlanCache
    name, depth = job
    return PlanCache(device="cpu").memtrace_for(
        name, SERVE_W, SERVE_H, rows_per_step=SERVE_R,
        prefetch_depth=depth)


def perf_phase(dev, kind: str) -> dict:
    """Phase 12: the perf lab and the memory trace at 1080p, R=8. Returns
    the K1 launches of the phase by instantiation, and its two reports,
    canny-m's memory trace and the burst's merged trace."""
    import math
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core import algorithms
    from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.obs import export, trace
    from repro_torch.obs.memtrace import memtrace_text, validate_memtrace
    from repro_torch.perf import attribution, ledger, measure
    from repro_torch.perf import model as perf_model

    names = sorted(algorithms.ALGORITHMS)
    video = sorted(algorithms.VIDEO_ALGORITHMS)
    kern = sp.stencil_pipeline
    cache = PlanCache(device=dev)
    t_phase = time.perf_counter()

    # ----------------------------------------------------------- peaks
    t0 = time.perf_counter()
    peaks = measure.calibrate(dev)
    calibrate_s = time.perf_counter() - t0
    sheet = measure.datasheet_peaks(kind)
    for v in (peaks.flops_per_s, peaks.hbm_bytes_per_s):
        if not (math.isfinite(v) and v > 0):
            fail(f"calibrated peaks {peaks.to_dict()} are not finite and "
                 f"positive")
    card = measure.card_info()

    # ------------------------------------------------------- measure
    # K1 launches of the phase: K1d's where the prefetch instantiation
    # launched, K1a/K1b's and K1c's the rest, by the executor's kind
    launches = {"spatial": 0, "temporal": 0, "prefetch": 0}
    kern.launches = kern.prefetch_launches = 0

    def count(key: str, run):
        before, before_pf = kern.launches, kern.prefetch_launches
        out = run()
        torch.cuda.synchronize()
        prefetch = kern.prefetch_launches - before_pf
        launches["prefetch"] += prefetch
        launches[key] += kern.launches - before - prefetch
        return out

    def executor(name: str, depth: int):
        if name in video:
            return cache.video_executor_for(
                name, SERVE_H, SERVE_W, chunk=VIDEO_CHUNK,
                rows_per_step=SERVE_R, prefetch_depth=depth)
        return cache.executor_for(name, SERVE_H, SERVE_W, batch=SERVE_B,
                                  rows_per_step=SERVE_R,
                                  prefetch_depth=depth)

    def measured(ex, sleep_s: float = 0.0):
        before = dict(launches)
        inst = "temporal" if ex.dag.name in video else "spatial"
        meas = count(inst, lambda: measure.measure_executor(
            ex, PERF_FRAMES, np.random.RandomState(PERF_SEED),
            settle=PERF_SETTLE, per_frame_sleep_s=sleep_s))
        # the settling calls and one for each call of the timed stream,
        # all of the instantiation the executor's program selects
        want = dict.fromkeys(launches, 0)
        want["prefetch" if ex.program.prefetch_depth > 1 else inst] = \
            PERF_SETTLE + PERF_FRAMES // (
                ex.batch if hasattr(ex, "batch") else ex.chunk)
        got = {k: launches[k] - before[k] for k in launches}
        if got != want:
            fail(f"{ex.dag.name} at prefetch depth "
                 f"{ex.program.prefetch_depth}: measure_executor launched "
                 f"{got}, not {want}")
        return meas

    cells = {}             # (name, depth) -> (model, measured, executor)
    max_err, max_ulp = 0.0, 0.0
    jobs = [(n, 1) for n in names] + [(n, 2) for n in names] \
        + [(n, 1) for n in video]
    t0 = time.perf_counter()
    for name, depth in jobs:
        ex = executor(name, depth)
        plan = cache.plan_for(name, SERVE_W, rows_per_step=SERVE_R,
                              prefetch_depth=depth)
        meas = measured(ex)
        inputs, state, out = meas.last
        ins = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        if state is None:
            exp = sp.stencil_pipeline_plain(ex.dag, ins)
        else:
            exp, _ = sp.video_pipeline_plain(ex.dag, {
                **ins, **sp.tap_feeds(ex.dag, ins, state, VIDEO_CHUNK)})
        err, ulp = ulp_err(out, exp)
        if ulp > TOLERANCE_ULP:
            fail(f"perf {name} depth {depth}: measured output differs from "
                 f"plain by {ulp} ULP")
        max_err, max_ulp = max(max_err, err), max(max_ulp, ulp)
        cells[(name, depth)] = (perf_model.predict(plan, SERVE_H), meas, ex)
    measure_s = time.perf_counter() - t0

    # ------------------------------------------- traced serving burst
    reqs = [FrameRequest(rid=i, pipeline=names[i % len(names)],
                         frames={"in": frames(5000 + i, 1, SERVE_H,
                                              SERVE_W)[0]})
            for i in range(SERVE_B * len(names))]
    eng = FrameEngine(cache=cache, max_batch=SERVE_B, rows_per_step=SERVE_R,
                      tile_shape=(SERVE_H, SERVE_W))
    trace.clear()
    trace.enable()
    try:
        served = count("spatial", lambda: eng.run(reqs))
        burst = export.to_chrome_trace(trace.events())
    finally:
        trace.disable()
        trace.clear()
    for r in reqs:
        x = torch.from_numpy(r.frames["in"]).to(dev)
        err, ulp = ulp_err(served[r.rid], sp.stencil_pipeline_plain(
            cache.dag_for(r.pipeline), {"in": x}))
        if ulp > TOLERANCE_ULP:
            fail(f"perf burst frame {r.rid} differs from plain by {ulp} ULP")
    breakdowns = {}
    for name in names:
        breakdowns[name] = measure.step_breakdown(burst, name)
        if breakdowns[name] is None:
            fail(f"the traced burst holds no engine.step of {name}")

    # --------------------------------------------------------- reports
    config = {**card, "peaks_source": "calibrated",
              "datasheet_peaks": sheet.to_dict(), "h": SERVE_H,
              "w": SERVE_W, "rows_per_step": SERVE_R, "batch": SERVE_B,
              "chunk": VIDEO_CHUNK, "frames": PERF_FRAMES,
              "seed": PERF_SEED}
    reports = {}
    for depth in (1, 2):
        pairs = [(k[0], *cells[k][:2]) for k in cells if k[1] == depth]
        clock = attribution.effective_clock_hz([p[1:] for p in pairs])
        entries = [attribution.attribute(
            m, meas, clock, peaks,
            breakdown=breakdowns.get(name) if depth == 1 else None)
            for name, m, meas in pairs]
        rep = attribution.build_report(
            entries, {**config, "prefetch_depth": depth}, peaks, clock)
        errs = attribution.validate_perf_report(rep)
        if errs:
            fail(f"perf_report at depth {depth} invalid: {errs[:3]}")
        for e in rep["pipelines"]:
            tf = e.get("time_fractions")
            if depth == 1 and e["pipeline"] in names and (
                    not tf or math.fsum(tf.values()) != 1.0):
                fail(f"{e['pipeline']}: time fractions {tf} do not sum "
                     f"to 1.0")
        reports[depth] = rep
        print(f"perf_report prefetch_depth={depth} ({card['nvidia_smi']}, "
              f"calibrated peaks)", flush=True)
        print(attribution.perf_text(rep), flush=True)

    # -------------------------------------------------- memory traces
    t0 = time.perf_counter()
    mt_jobs = [(n, 1) for n in names] + [(n, 2) for n in names] \
        + [(n, 1) for n in video]
    workers = min(len(mt_jobs), os.cpu_count() or 1, 8)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        traces = dict(zip(mt_jobs, pool.map(_memtrace_job, mt_jobs)))
    memtrace_s = time.perf_counter() - t0
    waste = {}
    for (name, depth), mt in traces.items():
        errs = validate_memtrace(mt)
        if errs:
            fail(f"memtrace {name} depth {depth} invalid: {errs[:3]}")
        prog = cells[(name, depth)][2].program
        ring_bytes = int(prog.table[sp.H_OSTAGE]) * 4
        s = mt["summary"]
        if s["smem_ring_bytes"] != ring_bytes or \
                s["prefetch_ring_bytes"] != prog.prefetch_bytes:
            fail(f"memtrace {name} depth {depth}: rings "
                 f"{s['smem_ring_bytes']} B (prefetch "
                 f"{s['prefetch_ring_bytes']}), the served program "
                 f"reserves {ring_bytes} B ({prog.prefetch_bytes})")
        waste[f"{name}@d{depth}"] = {
            k: s[k] for k in ("smem_ring_bytes", "prefetch_ring_bytes",
                              "tap_ring_bytes", "alloc_bytes",
                              "peak_bytes", "waste_frac",
                              "worst_port_pressure", "conflict_cycles")}
        lines = [b["waste"] for b in mt["buffers"]
                 if b["kind"] == "line_buffer"]
        waste[f"{name}@d{depth}"].update(
            # the line rings alone (frame rings, full device-memory
            # frames, dominate a video trace's totals)
            line_ring_waste_frac=1.0 - sum(w["peak_bytes"] for w in lines)
            / sum(w["alloc_bytes"] for w in lines),
            ringless_buffers=[
                b["name"] for b in mt["buffers"]
                if b["kind"] == "line_buffer" and b["ring"] is None])
    merged = export.merge_counter_tracks(burst, list(traces.values()))
    errs = export.validate_trace(merged)
    if errs:
        fail(f"burst trace with memtrace counters invalid: {errs[:3]}")
    print(memtrace_text(traces[("canny-m", 1)]), flush=True)

    # ---------------------------------------------------------- ledger
    def metrics_of(fps: list[float]) -> dict:
        fps_geomean = math.exp(sum(map(math.log, fps)) / len(fps))
        d1 = [cells[k][0] for k in cells if k[1] == 1]
        s = reports[1]["summary"]
        return {
            "predicted_cycles_total": sum(m.cycles_per_frame for m in d1),
            "model_bytes_total": sum(m.bytes_per_frame for m in d1),
            "smem_ring_bytes_total": sum(
                traces[k]["summary"]["smem_ring_bytes"] for k in traces
                if k[1] == 1),
            "alloc_bits_total": sum(m.alloc_bits for m in d1),
            "power_total": sum(m.power_total for m in d1),
            "fps_geomean": fps_geomean,
            "throughput_norm": fps_geomean / (peaks.flops_per_s / 1e9),
            "efficiency_geomean": s["efficiency_geomean"],
            "bytes_amplification_geomean":
                s["bytes_amplification_geomean"]}

    clean = metrics_of([cells[k][1].fps for k in cells if k[1] == 1])
    t0 = time.perf_counter()
    slowed = []
    for k in [k for k in cells if k[1] == 1]:
        _, meas, ex = cells[k]
        calls = meas.frames // (ex.batch if k[0] in names else ex.chunk)
        stall = (PERF_SLOWDOWN - 1.0) * meas.wall_s / calls
        slowed.append(measured(ex, sleep_s=stall).fps)
    inject_s = time.perf_counter() - t0
    injected = metrics_of(slowed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "perf_ledger.jsonl")
        rows = [ledger.make_row("perf", PERF_SEED, config, m)
                for m in (clean, injected)]
        for row in rows:
            if ledger.validate_row(row):
                fail(f"ledger row invalid: {ledger.validate_row(row)}")
            ledger.append_row(path, row)
        if ledger.read_ledger(path) != rows:
            fail("the ledger did not read back the rows appended")
    quiet = ledger.gate(clean, clean, PERF_BANDS + INJECT_BANDS)
    if quiet:
        fail(f"the run gated against itself fired: {quiet}")
    fired = ledger.gate(clean, injected, INJECT_BANDS)
    if not fired:
        fail(f"a {PERF_SLOWDOWN}x injected slowdown did not fire the gate "
             f"(fps geomean {clean['fps_geomean']} -> "
             f"{injected['fps_geomean']})")

    if sum(launches.values()) != kern.launches or \
            launches["prefetch"] != kern.prefetch_launches:
        fail(f"the phase's K1 launches {launches} do not add up to the "
             f"wrapper's {kern.launches} ({kern.prefetch_launches} "
             f"prefetch)")
    per = {}
    for (name, depth), (m, meas, ex) in cells.items():
        e = next(x for x in reports[depth]["pipelines"]
                 if x["pipeline"] == name)
        tf = e.get("time_fractions")
        per[f"{name}@d{depth}"] = {
            "cycles_per_frame": m.cycles_per_frame,
            "predicted_fps": e["predicted_fps"], "fps": meas.fps,
            "wall_s": meas.wall_s, "frames": meas.frames,
            "efficiency": e["efficiency"],
            "bytes_x": e["bytes_amplification"],
            "bytes_x_hbm": meas.bytes_per_frame / m.hbm_bytes_per_frame,
            "model_bound": m.bound, "bound": e["roofline"]["bound"],
            "time_fractions": tf or None}
    emit("perf", shape=[SERVE_H, SERVE_W], rows_per_step=SERVE_R,
         batch=SERVE_B, chunk=VIDEO_CHUNK, frames=PERF_FRAMES,
         nvidia_smi=card["nvidia_smi"],
         peaks={"calibrated": peaks.to_dict(), "datasheet": sheet.to_dict(),
                "calibrated_over_datasheet": {
                    "flops": peaks.flops_per_s / sheet.flops_per_s,
                    "bytes": peaks.hbm_bytes_per_s / sheet.hbm_bytes_per_s},
                "seconds": calibrate_s},
         clock_hz={d: reports[d]["clock_hz"] for d in reports},
         summary={d: reports[d]["summary"] for d in reports},
         per_pipeline=per, memtrace=waste,
         memtrace_workers=workers, merged_trace_events=len(
             merged["traceEvents"]),
         gate={"clean": clean, "injected": injected, "fired": fired,
               "slowdown": PERF_SLOWDOWN},
         launches=launches, max_abs_err=max_err, max_ulp=max_ulp,
         tolerance_ulp=TOLERANCE_ULP,
         seconds={"measure": measure_s, "memtrace": memtrace_s,
                  "inject": inject_s,
                  "phase": time.perf_counter() - t_phase})
    # the reports and a memory trace, for the examples phase's obs_report
    return {**launches, "artifacts": {
        "perf_report_d1": reports[1], "perf_report_d2": reports[2],
        "memtrace_canny": traces[("canny-m", 1)], "burst_trace": merged}}


# ----------------------------------------------------------- lm_serve phase
def serve_timed(eng, reqs) -> tuple[dict, dict]:
    """``Engine.run`` with a host clock around each admission (prefill,
    which ends in a device sync) and each step (ends in one too)."""
    pending = list(reqs)
    results: dict[int, list[int]] = {}
    prefill_s, prefill_tokens, steps = 0.0, 0, {}
    t_all = time.perf_counter()
    while pending or eng.active.any():
        while pending:
            t0 = time.perf_counter()
            if not eng.add_request(pending[0]):
                break
            prefill_s += time.perf_counter() - t0
            prefill_tokens += len(pending.pop(0).prompt)
        n = int(eng.active.sum())
        t0 = time.perf_counter()
        results.update({c.rid: c.tokens for c in eng.step()})
        steps.setdefault(n, []).append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    step_s = sum(sum(v) for v in steps.values())
    stepped = sum(len(v) - 1 for v in results.values())
    for r in reqs:
        toks = results.get(r.rid)
        if toks is None or len(toks) != r.max_new:
            fail(f"request {r.rid} returned {toks!r}, not {r.max_new} tokens")
        if not all(0 <= t < eng.cfg.vocab for t in toks):
            fail(f"request {r.rid}: a token outside the vocabulary")
    return results, {
        "requests": len(reqs), "prefill_tokens": prefill_tokens,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": prefill_tokens / prefill_s,
        "steps": sum(len(v) for v in steps.values()),
        "step_ms_by_active_slots": {
            str(n): {"median": float(np.median(v)) * 1e3,
                     "min": min(v) * 1e3, "count": len(v)}
            for n, v in sorted(steps.items())},
        "generated_tokens": sum(len(v) for v in results.values()),
        "decode_tokens_per_s": stepped / step_s,
        "tokens_per_s": sum(len(v) for v in results.values()) / wall,
        "wall_s": wall}


def isolation(model, seed: int) -> dict:
    """A request alone, then the same request with a second one admitted
    after its second step: its tokens must be equal and the admission
    must leave its cache rows and recurrent state bit for bit."""
    from repro_torch.serve import Engine, Request
    rng = np.random.RandomState(seed)
    p0 = rng.randint(0, model.cfg.vocab, 12)
    p1 = rng.randint(0, model.cfg.vocab, 40)
    solo = Engine(model, 2, 256).run([Request(0, p0, 12)])[0]
    eng = Engine(model, 2, 256)
    eng.add_request(Request(0, p0, 12))
    eng.step()
    eng.step()
    before = [t[:, 0].clone() for seg in eng.caches for sub in seg
              for t in sub.values()]
    eng.add_request(Request(1, p1, 8))
    after = [t[:, 0] for seg in eng.caches for sub in seg
             for t in sub.values()]
    untouched = all(torch.equal(a, b) for a, b in zip(before, after))
    res = {}
    while eng.active.any():
        res.update({c.rid: c.tokens for c in eng.step()})
    if not untouched or res[0] != solo:
        fail(f"{model.cfg.name}: admitting a second request moved the "
             f"first (state untouched: {untouched}; tokens {res[0]} "
             f"against {solo} alone)")
    return {"tokens_alone": solo, "state_bit_for_bit": untouched}


def decode_vs_forward(model, n: int, seed: int) -> dict:
    """Token-by-token ``decode_step`` logits (the engine's step: a CUDA
    graph of it, replayed) against ``forward`` over one ``n``-token
    sequence (the JAX package's bound, LM_RTOL / LM_ATOL)."""
    from repro_torch.serve.engine import DecodeStep
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab, n)).to(
        model.device)
    pos = torch.arange(n, device=model.device)
    t0 = time.perf_counter()
    full, _ = model.forward({"tokens": toks[None]})
    synchronize(model.device)
    forward_s = time.perf_counter() - t0
    step = DecodeStep(model, model.decode_init(1, n), 1)
    max_err = torch.zeros((), device=model.device)
    worst = torch.zeros((), device=model.device)   # |d| / (atol + rtol|f|)
    t0 = time.perf_counter()
    for t in range(n):
        lg = step(toks[t:t + 1], pos[t:t + 1])
        exp = full[0, t]
        d = (lg[0] - exp).abs()
        max_err = torch.maximum(max_err, d.max())
        worst = torch.maximum(worst, (d / (LM_ATOL + LM_RTOL * exp.abs()))
                              .max())
    synchronize(model.device)
    decode_s = time.perf_counter() - t0
    out = {"tokens": n, "max_abs_err": float(max_err),
           "max_err_over_bound": float(worst), "rtol": LM_RTOL,
           "atol": LM_ATOL, "finite": bool(torch.isfinite(full).all()),
           "forward_s": forward_s, "decode_ms_per_token": decode_s / n * 1e3}
    if not out["finite"] or out["max_err_over_bound"] > 1.0:
        fail(f"{model.cfg.name} ({model.cfg.dtype}, {model.cfg.n_layers} "
             f"layers): decode against forward {out}")
    return out


def lm_serve_phase(dev, kind: str) -> None:
    """Phase 13: the LM serving stack (``repro_torch.models``,
    ``repro_torch.serve``) at full width on the card. No hand-written
    kernel lies on this path (the JAX package's models reach none)."""
    import dataclasses
    import gc

    from repro_torch.kernels import conv2d_stencil
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.models import build_model, get_config
    from repro_torch.models.transformer import plan_segments
    from repro_torch.perf import measure
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.engine import DecodeStep

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (sp.stencil_pipeline, conv2d_stencil.conv2d, swa.swa_decode)
    launches0 = [c.launches for c in counters]
    t_phase = time.perf_counter()
    peaks = measure.calibrate(dev)
    smi = card_info()["nvidia_smi"]

    def gen(seed: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------- (a) gemma3-1b, full config, bf16
    release()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=gen(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(model, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=LM_SEED)
    rng = np.random.RandomState(LM_SEED)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, n),
                    max_new=LM_MAX_NEW,
                    temperature=0.8 if i in LM_SAMPLED else 0.0)
            for i, n in enumerate(LM_PROMPTS)]
    if max(LM_PROMPTS) + LM_MAX_NEW <= cfg.window:
        fail("no request crosses the local window")
    results, stats = serve_timed(eng, reqs)
    # the decode step at 4 active slots: eager per call and on the device,
    # and the engine's CUDA graph of it
    caches = model.decode_init(LM_SLOTS, LM_MAX_LEN)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, LM_SLOTS)).to(dev)
    pos = torch.tensor([700, 650, 300, 20], device=dev)

    def step():
        model.decode_step(caches, toks, pos)
    step_ms = cuda_ms(step, iters=20)
    step_dev_ms, by_kernel = device_ms(step, 20)
    graphed = DecodeStep(model, caches, LM_SLOTS)
    graph_ms = cuda_ms(lambda: graphed(toks, pos), iters=50)
    weight_bytes = model.weight_bytes()
    table_bytes = model.embed.table.numel() * model.embed.table.element_size()
    bound_ms = weight_bytes / peaks.hbm_bytes_per_s * 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("lm_serve", part="a", arch=LM_ARCH, dtype=cfg.dtype,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         slots=LM_SLOTS, max_len=LM_MAX_LEN, prompts=list(LM_PROMPTS),
         max_new=LM_MAX_NEW, sampled=list(LM_SAMPLED),
         kv_plan_bytes_per_seq=eng.kv_plan.bytes_per_seq,
         params=model.param_count(), weight_bytes=weight_bytes,
         layer_weight_bytes=weight_bytes - table_bytes,
         table_bytes_fp32=table_bytes, init_s=init_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         **stats, eager_step_ms_at_4=step_ms,
         eager_step_device_ms_at_4=step_dev_ms,
         eager_device_busy_share=step_dev_ms / step_ms,
         graph_step_ms_at_4=graph_ms,
         step_bound_ms=bound_ms, step_bound_by="bytes",
         step_bound_bytes=weight_bytes,
         calibrated_bytes_per_s=peaks.hbm_bytes_per_s,
         datasheet_bound_ms=weight_bytes
         / datasheet_peaks(kind).hbm_bytes_per_s * 1e3,
         top_kernels_ms=dict(top), nvidia_smi=smi,
         tokens={str(k): v for k, v in sorted(results.items())})
    # ------------------------------------------ (c) isolation, gemma3
    iso = {LM_ARCH: isolation(model, LM_SEED + 1)}
    del model, eng, caches, graphed
    release()

    # ------------------- (b) the same config in fp32, full depth
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, device=dev, generator=gen(LM_SEED))
    check = decode_vs_forward(model, LM_CHECK_LEN, LM_SEED + 2)
    prompt = np.random.RandomState(LM_SEED + 3).randint(0, cfg.vocab, 20)
    got = Engine(model, n_slots=1, max_len=64).run(
        [Request(rid=0, prompt=prompt, max_new=8)])[0]
    caches = model.decode_init(1, 64)
    for t, tok in enumerate(prompt):
        lg, _ = model.decode_step(caches, torch.tensor([int(tok)], device=dev),
                                  torch.tensor([t], device=dev))
    manual = [int(lg[0].argmax())]
    for t in range(len(prompt), len(prompt) + 7):
        lg, _ = model.decode_step(caches, torch.tensor([manual[-1]],
                                                       device=dev),
                                  torch.tensor([t], device=dev))
        manual.append(int(lg[0].argmax()))
    if got != manual:
        fail(f"Engine's greedy tokens {got} differ from a decode_step loop's "
             f"{manual}")
    emit("lm_serve", part="b", arch=LM_ARCH, dtype="float32",
         layers=cfg32.n_layers, decode_vs_forward=check,
         engine_vs_decode_loop={"tokens": got, "equal": True},
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model, caches
    release()

    # ---------------- (d) granite-moe, rwkv6, recurrentgemma; hubert
    others = {}
    for name in LM_OTHERS:
        cfg = get_config(name)
        model = build_model(cfg, device=dev, generator=gen(LM_SEED))
        eng = Engine(model, n_slots=LM_SLOTS, max_len=256, seed=LM_SEED)
        rng = np.random.RandomState(LM_SEED + 4)
        reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, n),
                        max_new=16) for i, n in enumerate((9, 48, 23))]
        _, st = serve_timed(eng, reqs)
        entry = {"dtype": cfg.dtype, "layers": cfg.n_layers,
                 "params": model.param_count(),
                 "weight_bytes": model.weight_bytes(),
                 "kv_plan_bytes_per_seq": eng.kv_plan.bytes_per_seq, **st,
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if name == "rwkv6-1.6b":
            iso[name] = isolation(model, LM_SEED + 1)
        del model, eng
        release()
        unit = plan_segments(cfg)[0].kinds
        cut = dataclasses.replace(cfg, dtype="float32", n_layers=len(unit),
                                  capacity_factor=max(
                                      cfg.capacity_factor,
                                      cfg.n_experts / max(cfg.top_k, 1)))
        model = build_model(cut, device=dev, generator=gen(LM_SEED))
        entry["fp32_one_superblock"] = {
            "kinds": "".join(unit),
            **decode_vs_forward(model, LM_CHECK_LEN, LM_SEED + 2)}
        others[name] = entry
        del model
        release()
    cfg = get_config("hubert-xlarge")
    model = build_model(cfg, device=dev, generator=gen(LM_SEED))
    frames_ = torch.randn((2, 256, cfg.d_model), generator=gen(LM_SEED + 5),
                          device=dev)
    logits, _ = model.forward({"frame_embeds": frames_})
    if logits.shape != (2, 256, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"hubert-xlarge forward: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    hubert_ms = cuda_ms(lambda: model.forward({"frame_embeds": frames_}),
                        iters=5)
    others["hubert-xlarge"] = {
        "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": [2, 256],
        "params": model.param_count(), "forward_ms": hubert_ms,
        "finite": True,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, logits
    release()
    moved = [c.launches - n for c, n in zip(counters, launches0)]
    emit("lm_serve", part="c+d", isolation=iso, models=others,
         kernel_launches_in_phase=dict(zip(
             ("stencil_pipeline", "conv2d", "swa_decode"), moved)),
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)


def traced_step_ms(fn) -> tuple[float | None, dict]:
    """(device ms, {kernel: ms}) of one call of ``fn`` under the profiler;
    (None, {}) when the trace holds no device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from repro_torch.perf.timing import _device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {e.key: _device_us(e) / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0}
    return (sum(by_name.values()) if by_name else None), by_name


def card_copy_of_state(state, model):
    """A training state on the CPU, moved to ``model``'s card."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])

    def move(x):
        return ({k: move(v) for k, v in x.items()} if isinstance(x, dict)
                else x.to(model.device, copy=True))
    return {"params": params, "opt": move(state["opt"])}


def compare_states(got: dict, exp: dict, lr_sum: float) -> dict:
    """Master copies and moments of two training states (card, CPU):
    max abs differences, and the elements outside LT_CMP_RTOL /
    LT_CMP_ATOL, which must be few masters within Adam's step bound."""
    out = {}
    for key in ("master", "m", "v"):
        worst, outliers, total, worst_out = 0.0, 0, 0, 0.0
        for n, e in exp["opt"][key].items():
            g = got["opt"][key][n].cpu()
            err = (g - e).abs()
            bad = err > LT_CMP_ATOL + LT_CMP_RTOL * e.abs()
            worst = max(worst, float(err.max()))
            total += e.numel()
            if bad.any():
                outliers += int(bad.sum())
                worst_out = max(worst_out, float(err[bad].max()))
        out[key] = {"max_abs_diff": worst, "outside_tolerance": outliers,
                    "elements": total, "max_abs_diff_outside": worst_out}
        if outliers > LT_FEW * total or (outliers and (
                key != "master" or worst_out > 4 * lr_sum)):
            fail(f"lm_train card against CPU: {key} {out[key]}")
    return out


def lm_train_phase(dev, kind: str) -> None:
    """Phase 14: LM training (``repro_torch.train``, ``data``,
    ``checkpointing``, ``launch.train``) on the card. No hand-written
    kernel lies on this path."""
    import dataclasses
    import gc
    import subprocess
    import tempfile

    from repro_torch.checkpointing import (HardwareFailure, Preemption,
                                           Supervisor, SupervisorConfig)
    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.data import TokenStream
    from repro_torch.kernels import conv2d_stencil
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import build_model, get_config
    from repro_torch.train import OptConfig, make_train_state, \
        make_train_step
    from repro_torch.train import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (sp.stencil_pipeline, conv2d_stencil.conv2d, swa.swa_decode)
    launches0 = [c.launches for c in counters]
    t_phase = time.perf_counter()
    smi = card_info()["nvidia_smi"]

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------ (1) the card against the CPU, fp32
    small = dataclasses.replace(reduced_config(get_config(LT_ARCH)),
                                dtype="float32", remat=True)
    opt = OptConfig(**LT_OPT)
    cpu = build_model(small, device="cpu")
    cs = make_train_state(cpu, torch.Generator().manual_seed(LT_SEED))
    card = build_model(small, device=dev)
    ks = card_copy_of_state(cs, card)
    cpu_step, card_step = make_train_step(cpu, opt), make_train_step(card,
                                                                     opt)
    data = TokenStream(small.vocab, LT_CMP_BATCH, LT_CMP_SEQ, seed=LT_SEED)
    steps, lr_sum = [], 0.0
    for _ in range(LT_CMP_STEPS):
        batch = data.next()
        _, mc = cpu_step(cs, batch)
        _, mk = card_step(ks, batch)
        row = {k: (float(mk[k]), float(mc[k])) for k in ("loss",
                                                         "grad_norm")}
        for k, (a, b) in row.items():
            if not np.isfinite(a) or abs(a - b) > LT_CMP_RTOL * abs(b):
                fail(f"lm_train card against CPU: {k} {a} against {b}")
        steps.append({k: {"card": a, "cpu": b, "rel_diff": abs(a - b)
                          / abs(b)} for k, (a, b) in row.items()})
        lr_sum += float(mc["lr"])
    emit("lm_train", part="card_vs_cpu", arch=LT_ARCH, dtype="float32",
         remat=True, layers=small.n_layers, d_model=small.d_model,
         vocab=small.vocab, batch=[LT_CMP_BATCH, LT_CMP_SEQ],
         rtol=LT_CMP_RTOL, atol=LT_CMP_ATOL, steps=steps,
         state=compare_states(ks, cs, lr_sum), nvidia_smi=smi)
    del cpu, cs, card, ks
    release()

    # ------------------------------- (2) full width and depth, bf16
    cfg = get_config(LT_ARCH)
    batch0 = TokenStream(cfg.vocab, LT_BATCH, LT_SEQ, seed=0).next()
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    state = make_train_state(model, gen(LT_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the step-0 loss of the same master copies in float32
    ref = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(state["opt"]["master"][n])
        loss32 = float(ref.loss(train_loop.to_device(batch0, dev))[0])
    del ref
    release()
    opt_cfg = OptConfig(warmup_steps=max(LT_STEPS // 20, 5),
                        total_steps=LT_STEPS)    # as launch/train.py does
    events = []
    adamw = train_loop.adamw_update

    def timed_adamw(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = adamw(*a, **k)
        end.record()
        events.append((start, end))
        return out
    train_loop.adamw_update = timed_adamw
    try:
        step = make_train_step(model, opt_cfg)
        data = TokenStream(cfg.vocab, LT_BATCH, LT_SEQ, seed=0)
        n_params = model.param_count()
        tokens = LT_BATCH * LT_SEQ
        flops = 6.0 * n_params * tokens + attention_flops(cfg, LT_BATCH,
                                                          LT_SEQ)
        rows = []
        for i in range(LT_STEPS):
            batch = data.next()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, met = step(state, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rows.append({"step": i, "loss": loss, "grad_norm": gnorm,
                         "lr": float(met["lr"]), "wall_ms": dt * 1e3,
                         "optimizer_ms": events[-1][0].elapsed_time(
                             events[-1][1]),
                         "tokens_per_s": tokens / dt,
                         "model_tflops_per_s": flops / dt / 1e12,
                         "bf16_datasheet_share": flops / dt
                         / H100_BF16_DENSE_FLOPS,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated()})
        dev_ms, by_kernel = traced_step_ms(lambda: step(state, data.next()))
    finally:
        train_loop.adamw_update = adamw
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite([r["loss"] for r in rows] +
                           [r["grad_norm"] for r in rows])):
        fail(f"lm_train full width: non-finite loss or norm {rows}")
    if abs(losses[0] - loss32) > LT_LOSS_RTOL * abs(loss32):
        fail(f"lm_train full width: step-0 bf16 loss {losses[0]} against "
             f"float32 {loss32}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"lm_train full width: the loss did not fall {losses}")
    steady = rows[1:]
    wall = float(np.median([r["wall_ms"] for r in steady]))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("lm_train", part="full_width", arch=LT_ARCH, dtype=cfg.dtype,
         remat=cfg.remat, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, batch=[LT_BATCH, LT_SEQ], params=n_params,
         loss_chunk=model.LOSS_CHUNK, opt=dataclasses.asdict(opt_cfg),
         init_s=init_s, step0_loss_bf16=losses[0],
         step0_loss_fp32=loss32, loss_rtol=LT_LOSS_RTOL,
         model_flops_per_step=flops,
         attention_flops_per_step=attention_flops(cfg, LT_BATCH, LT_SEQ),
         bf16_datasheet_flops=H100_BF16_DENSE_FLOPS, steps=rows,
         median_wall_ms=wall,
         median_optimizer_ms=float(np.median([r["optimizer_ms"]
                                              for r in steady])),
         median_tokens_per_s=tokens / wall * 1e3,
         median_model_tflops_per_s=flops / wall / 1e9,
         step_device_ms=dev_ms,
         device_busy_share=dev_ms / wall if dev_ms else None,
         top_kernels_ms=dict(top),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         nvidia_smi=smi)
    del model, state, step
    release()

    # ------------------------------------- (3) the supervisor drill
    times = {"save_s": [], "restore_s": []}
    save, restore = ckpt.save, ckpt.restore

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return call
    fails_by_name = {"Preemption": Preemption,
                     "HardwareFailure": HardwareFailure}

    def drill(fails: dict) -> tuple[dict, list, dict]:
        m = build_model(small, device=dev)
        st = make_train_state(m, gen(LT_SEED))

        def hook(s):
            if s in fails:
                raise fails_by_name[fails.pop(s)](f"injected at {s}")
        with tempfile.TemporaryDirectory() as d:
            sup = Supervisor(SupervisorConfig(
                ckpt_dir=d, ckpt_every=LT_DRILL_EVERY, async_save=True),
                make_train_step(m, opt), st,
                TokenStream(small.vocab, LT_CMP_BATCH, LT_CMP_SEQ,
                            seed=LT_SEED), fail_hook=hook)
            out = sup.run(LT_DRILL_STEPS)
            written = sorted(os.listdir(d))
        by_step = {e["step"]: e["loss"] for e in sup.metrics_log}
        return out, [by_step[k] for k in sorted(by_step)], {
            "master": st["opt"]["master"], "written": written}
    ckpt.save, ckpt.restore = timed(save, "save_s"), timed(restore,
                                                           "restore_s")
    try:
        plain, plain_losses, plain_state = drill({})
        times = {"save_s": [], "restore_s": []}
        hit, hit_losses, hit_state = drill(dict(LT_DRILL_FAILS))
    finally:
        ckpt.save, ckpt.restore = save, restore
    rel = max(abs(a - b) / abs(b) for a, b in zip(hit_losses, plain_losses))
    master_diff = max(float((hit_state["master"][n]
                             - plain_state["master"][n]).abs().max())
                      for n in plain_state["master"])
    if hit["restarts"] != 2 or len(hit_losses) != LT_DRILL_STEPS or \
            rel > LT_DRILL_RTOL:
        fail(f"lm_train drill: {hit}, losses {hit_losses} against "
             f"{plain_losses}")
    emit("lm_train", part="drill", arch=LT_ARCH, dtype="float32",
         steps=LT_DRILL_STEPS, ckpt_every=LT_DRILL_EVERY, async_save=True,
         failures={str(k): v for k, v in LT_DRILL_FAILS.items()},
         restarts=hit["restarts"], final_loss=hit["final_loss"],
         uninterrupted_final_loss=plain["final_loss"],
         max_loss_rel_diff=rel, rtol=LT_DRILL_RTOL,
         final_master_max_abs_diff=master_diff,
         checkpoints=hit_state["written"], **times, nvidia_smi=smi)

    # ------------------------------------------------------- (4) the CLI
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             LT_ARCH, "--reduced", "--steps", "4", "--ckpt-dir", d],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        cli_s = time.perf_counter() - t0
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("loss: ")]
    if run.returncode != 0 or len(line) != 1 or "on cuda" not in run.stdout:
        fail(f"lm_train CLI: exit {run.returncode}, {run.stdout[-2000:]} "
             f"{run.stderr[-2000:]}")
    cli_loss = {kv.split("=")[0]: float(kv.split("=")[1])
                for kv in line[0].split()[1:]}
    if not all(np.isfinite(list(cli_loss.values()))):
        fail(f"lm_train CLI: {line[0]}")
    moved = [c.launches - n for c, n in zip(counters, launches0)]
    emit("lm_train", part="cli", command=f"python -m "
         f"repro_torch.launch.train --arch {LT_ARCH} --reduced --steps 4",
         loss=cli_loss, seconds=cli_s,
         kernel_launches_in_phase=dict(zip(
             ("stencil_pipeline", "conv2d", "swa_decode"), moved)),
         nvidia_smi=smi, phase_seconds=time.perf_counter() - t_phase)


def launch_phase(dev, kind: str) -> None:
    """Phase 15: the launch helpers, ``distributed/`` and the dry run on
    the card (``repro_torch.launch.shapes``, ``.mesh``, ``.dryrun``,
    ``repro_torch.distributed``, the training CLI's ``--distributed``,
    ``examples/train_lm_torch.py``). No hand-written kernel lies on this
    path."""
    import dataclasses
    import gc
    import shutil
    import subprocess
    import tempfile

    from repro_torch.configs import ALL_ARCHS
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.kernels import conv2d_stencil
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import compat_make_mesh, make_card_mesh, \
        mesh_scope
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import build_model, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (sp.stencil_pipeline, conv2d_stencil.conv2d, swa.swa_decode)
    launches0 = [c.launches for c in counters]
    t_phase = time.perf_counter()
    smi = card_info()["nvidia_smi"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "PYTHONIOENCODING": "utf-8"}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------------- (a) the dry run, every cell
    release()
    mesh = make_card_mesh(dev)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cells = {(a, s): dryrun.lower_cell(a, s, mesh, "card", verbose=False)
             for a in ALL_ARCHS for s in SHAPES}
    dry_s = time.perf_counter() - t0
    n_run = sum(r.status == "run" for r in cells.values())
    n_skip = sum(r.status.startswith("SKIP") for r in cells.values())
    if len(cells) != 40 or n_run != 33 or n_skip != 7:
        fail(f"launch dry run: {len(cells)} cells, {n_run} run, {n_skip} "
             f"skip: {[r.status for r in cells.values()]}")
    if any(cells[("mixtral-8x22b", s)].fits for s in SHAPES):
        fail("launch dry run: a mixtral-8x22b cell fits 80 GB")
    if torch.cuda.memory_allocated() != held:
        fail("launch dry run: it allocated card memory")
    emit("launch", part="dryrun", mesh=mesh.shape, device=str(mesh.device),
         run=n_run, skip=n_skip, seconds=dry_s, cells=[
             {"arch": r.arch, "shape": r.shape, "status": r.status}
             | ({"arg_bytes": r.arg_bytes, "out_bytes": r.out_bytes,
                 "fits": r.fits, "flops_per_dev": r.flops_per_dev,
                 "bytes_per_dev": r.bytes_per_dev,
                 "dominant": r.roofline["dominant"],
                 "compute_s": r.roofline["compute_s"],
                 "memory_s": r.roofline["memory_s"]}
                if r.status == "run" else {})
             for r in cells.values()])

    # --------------------- (b) gemma3-1b x decode_32k, for real, full size
    cell = cells[(LA_ARCH, LA_SHAPE)]
    cfg = get_config(LA_ARCH)
    b, s = SHAPES[LA_SHAPE]["batch"], SHAPES[LA_SHAPE]["seq"]
    release()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with mesh_scope(mesh), torch.no_grad():
        model = build_model(cfg, device=dev, generator=gen(LA_SEED))
        caches = model.decode_init(b, s)
        tokens = torch.randint(0, cfg.vocab, (b,), generator=gen(LA_SEED + 1),
                               device=dev, dtype=torch.int32)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - before
        rel = abs(alloc - cell.arg_bytes) / cell.arg_bytes
        if rel > LA_ALLOC_RTOL:
            fail(f"launch decode_32k: {alloc} bytes allocated against the "
                 f"dry run's {cell.arg_bytes} ({rel:.4f})")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(LA_WARM):
            logits, _ = model.decode_step(caches, tokens, pos)
        torch.cuda.synchronize()
        step_ms = []
        for _ in range(LA_TIMED):
            t0 = time.perf_counter()
            logits, _ = model.decode_step(caches, tokens, pos)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - before
        finite = bool(torch.isfinite(logits).all())
        dev_ms, top = traced_step_ms(
            lambda: model.decode_step(caches, tokens, pos))
    if not finite or tuple(logits.shape) != (b, cfg.vocab):
        fail(f"launch decode_32k: logits {tuple(logits.shape)}, finite "
             f"{finite}")
    emit("launch", part="decode_32k", arch=LA_ARCH, batch=b, seq=s,
         pos=s - 1, dtype=str(cfg.compute_dtype), arg_bytes=cell.arg_bytes,
         allocated_bytes=alloc, alloc_rel_diff=rel, rtol=LA_ALLOC_RTOL,
         peak_bytes=peak, peak_above_arg_bytes=peak - cell.arg_bytes,
         dry_run_out_bytes=cell.out_bytes, dry_run_temp_bytes=None,
         step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
         device_ms=dev_ms, top_kernels_ms=dict(sorted(
             top.items(), key=lambda kv: -kv[1])[:6]),
         roofline_memory_ms=cell.roofline["memory_s"] * 1e3,
         roofline_compute_ms=cell.roofline["compute_s"] * 1e3,
         bytes_per_dev=cell.bytes_per_dev, flops_per_dev=cell.flops_per_dev,
         logits_finite=finite, nvidia_smi=smi)
    del model, caches, logits, tokens, pos
    release()

    # -------------------------- (c) pipeline_forward at full width, fp32
    model = build_model(dataclasses.replace(cfg, dtype="float32"),
                        device=dev, generator=gen(LA_SEED + 2))
    seg = model.segments[0]
    width = len(seg.kinds)
    stages = [list(model.layers[i * width:(i + 1) * width])
              for i in range(seg.n)]
    toks = torch.randint(0, cfg.vocab, (LA_MICRO, 1, LA_MB_SEQ),
                         generator=gen(LA_SEED + 3), device=dev)
    pmesh = compat_make_mesh((seg.n,), ("stage",), device=dev)
    with torch.no_grad(), mesh_scope(pmesh):
        embedded = [model._embed_inputs({"tokens": toks[m]})
                    for m in range(LA_MICRO)]
        x_micro = torch.stack([e[0] for e in embedded])
        positions = embedded[0][1]

        def apply(blocks, x):
            return model._superblock(blocks, x, positions, None)[0]

        def sequential():
            out = torch.empty_like(x_micro)
            for m in range(LA_MICRO):
                x = x_micro[m]
                for blocks in stages:
                    x = apply(blocks, x)
                out[m] = x
            return out
        pipeline_forward(stages, x_micro, apply, pmesh)       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_forward(stages, x_micro, apply, pmesh)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        exp = sequential()
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - exp).abs().max())
        finite = bool(torch.isfinite(got).all())
    if not finite or err > LA_PIPE_TOL:
        fail(f"launch pipeline_forward: max error {err}, finite {finite}")
    emit("launch", part="pipeline", arch=LA_ARCH, stages=seg.n,
         kinds="".join(seg.kinds), d_model=cfg.d_model, dtype="float32",
         microbatches=LA_MICRO, microbatch=[1, LA_MB_SEQ],
         ticks=LA_MICRO + seg.n - 1, max_abs_err=err, tol=LA_PIPE_TOL,
         pipeline_ms=pipe_ms, sequential_ms=seq_ms)
    del model, stages, embedded, x_micro, got, exp
    release()

    # ----------------------------- (d) the training CLI, --distributed
    def cli(extra: list[str]) -> tuple[list, float, str]:
        with tempfile.TemporaryDirectory() as d:
            free = shutil.disk_usage(d).free
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", *LA_CLI,
                 *extra, "--ckpt-dir", d], capture_output=True, text=True,
                encoding="utf-8", timeout=900, env=env)
            secs = time.perf_counter() - t0
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("losses: ")]
        if run.returncode != 0 or len(line) != 1:
            fail(f"launch CLI {extra}: exit {run.returncode} (disk free "
                 f"{free}), {run.stdout[-2000:]} {run.stderr[-3000:]}")
        return json.loads(line[0][len("losses: "):]), secs, run.stdout
    dist_losses, dist_s, dist_out = cli(["--distributed"])
    plain_losses, plain_s, _ = cli([])
    tag = "in a process group (nccl, world size 1)"
    if tag not in dist_out:
        fail(f"launch CLI --distributed: no '{tag}' in {dist_out[-1000:]}")
    if dist_losses != plain_losses or len(dist_losses) != 3 or \
            not all(np.isfinite(dist_losses)):
        fail(f"launch CLI: --distributed losses {dist_losses}, plain "
             f"{plain_losses}")
    emit("launch", part="distributed_cli",
         command="python -m repro_torch.launch.train " + " ".join(LA_CLI)
         + " [--distributed]", backend="nccl", world_size=1,
         losses=dist_losses, plain_losses=plain_losses, bit_for_bit=True,
         seconds=dist_s, plain_seconds=plain_s)

    # ------------------------------------------- (e) the example's twin
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py"),
         "--full", "--steps", str(LA_EXAMPLE_STEPS)], capture_output=True,
        text=True, encoding="utf-8", timeout=900, env=env)
    ex_s = time.perf_counter() - t0
    final = [ln for ln in run.stdout.splitlines()
             if ln.startswith("final loss ")]
    if run.returncode != 0 or len(final) != 1 or "learning" not in final[0]:
        fail(f"launch example: exit {run.returncode}, {run.stdout[-2000:]} "
             f"{run.stderr[-3000:]}")
    words = final[0].replace("(", " ").replace(")", " ").split()
    moved = [c.launches - n for c, n in zip(counters, launches0)]
    emit("launch", part="example",
         command=f"python examples/train_lm_torch.py --full --steps "
                 f"{LA_EXAMPLE_STEPS}", final_loss=float(words[2]),
         start_loss=float(words[4]), seconds=ex_s,
         kernel_launches_in_phase=dict(zip(
             ("stencil_pipeline", "conv2d", "swa_decode"), moved)),
         nvidia_smi=smi, phase_seconds=time.perf_counter() - t_phase)


def examples_phase(dev, artifacts: dict) -> dict:
    """Phase 16: the twins of the examples and tools
    (``examples/*_torch.py``, ``tools/obs_report_torch.py``,
    ``tools/debug_memory_torch.py``) through their ``main(argv)`` at full
    width on the card, in a temporary directory: every frame a twin
    serves held at 0 ULP against the kernel's plain version, obs_report
    over this run's artifacts (``artifacts``: the storm's trace and
    telemetry snapshot, the perf reports, a memory trace, the burst's
    trace) and the twins' own. Returns the K1 launches of the phase by
    instantiation."""
    import contextlib
    import gc
    import importlib.util
    import io
    import tempfile

    from repro_torch.kernels import conv2d_stencil
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.obs import export
    from repro_torch.obs.memtrace import validate_memtrace

    kern = sp.stencil_pipeline
    others = (conv2d_stencil.conv2d, swa.swa_decode)
    others0 = [c.launches for c in others]
    label = f"cuda:{torch.cuda.current_device()} " \
            f"({torch.cuda.get_device_name()})"
    smi = card_info()["nvidia_smi"]
    total = dict.fromkeys(("spatial", "temporal", "prefetch"), 0)
    t_phase = time.perf_counter()

    def counts() -> tuple[int, int, int]:
        return (kern.launches, kern.prefetch_launches,
                kern.temporal_launches)

    def run(path: str, argv: list[str]):
        """(main's result, its stdout, seconds, K1 launches by
        instantiation) of one twin; any exception fails the smoke."""
        spec = importlib.util.spec_from_file_location(
            "twin_" + os.path.basename(path)[:-3], os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        before = counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                spec.loader.exec_module(mod)
                result = mod.main(argv)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported, then fatal
            fail(f"{path} {argv}: {type(e).__name__}: {e}\n"
                 f"{buf.getvalue()[-3000:]}")
        secs = time.perf_counter() - t0
        a, p, t = (x - y for x, y in zip(counts(), before))
        k1 = {"spatial": a - p - t, "temporal": t, "prefetch": p}
        for k in total:
            total[k] += k1[k]
        return result, buf.getvalue(), secs, k1

    def held(dag, x, got) -> tuple[float, float]:
        return ulp_err(got, sp.stencil_pipeline_plain(
            dag, {"in": torch.as_tensor(x, device=dev)}))

    def report(twin: str, out: str, secs: float, k1: dict, checks: list,
               **fields) -> None:
        if f"device: {label}" not in out:
            fail(f"{twin} did not print the device {label}: {out[:300]}")
        err = max((c[0] for c in checks), default=0.0)
        ulp = max((c[1] for c in checks), default=0.0)
        if ulp > TOLERANCE_ULP:
            fail(f"{twin}: a frame {ulp} ULP off the plain version")
        if checks and sum(k1.values()) == 0:
            fail(f"{twin} served frames without launching the kernel")
        emit("examples", twin=twin, seconds=secs, k1_launches=k1,
             max_abs_err=err, max_ulp=ulp, tolerance_ulp=TOLERANCE_ULP,
             **fields, last_line=out.strip().splitlines()[-1])

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            # ----------------------------------------------- quickstart
            r, out, secs, k1 = run("examples/quickstart_torch.py", EX_FULL)
            report("quickstart", out, secs, k1,
                   [held(r["dag"], r["img"], r["out"])], frames=1,
                   shape=list(r["img"].shape), verify_ok=r["report"].ok,
                   smem_bytes=r["smem_bytes"])

            # -------------------------------------------- stream_frames
            r, out, secs, k1 = run("examples/stream_frames_torch.py",
                                   EX_FULL)
            cache = r["cache"]
            dag = cache.dag_for("canny-m")
            checks = [held(dag, r["img"], r["r1"]),
                      held(dag, r["img"], r["r8"]),
                      held(dag, r["frame"], r["tiled"])]
            checks += [held(cache.dag_for(q.pipeline), q.frames["in"],
                            r["results"][q.rid]) for q in r["requests"]]
            report("stream_frames", out, secs, k1, checks,
                   frames=3 + len(r["requests"]),
                   shape=list(r["frame"].shape),
                   tiled=list(r["tiled"].shape))
            del r, cache

            # --------------------------------------------- stream_video
            r, out, secs, k1 = run("examples/stream_video_torch.py",
                                   EX_FULL)
            vid = torch.from_numpy(r["video"]).to(dev)
            checks = [ulp_err(r["hand"], plain_stream(r["dag"], vid))]
            for v, got in r["streams"].values():
                checks.append(ulp_err(got, plain_stream(
                    r["engine_dag"], torch.from_numpy(v).to(dev))))
            report("stream_video", out, secs, k1, checks,
                   frames=sum(len(v) for v, _ in r["streams"].values())
                   + len(r["video"]), shape=list(r["video"].shape[1:]))
            del r, vid

            # -------------------------------------------- overlap_depth
            r, out, secs, k1 = run("examples/overlap_depth_torch.py",
                                   EX_FULL)
            if not torch.equal(r["depth1"], r["deep"]):
                fail("overlap_depth: depth 2 differs from depth 1")
            report("overlap_depth", out, secs, k1,
                   [held(r["dag"], r["img"], r["depth1"]),
                    held(r["dag"], r["img"], r["deep"])], frames=2,
                   shape=list(r["img"].shape), depths=list(r["depths"]),
                   budget=r["budget"], best_depth=r["tuning"].best_depth,
                   depth_rows=r["tuning"].depth_candidates)

            # -------------------------------------------- tune_pipeline
            r, out, secs, k1 = run("examples/tune_pipeline_torch.py",
                                   EX_FULL)
            report("tune_pipeline", out, secs, k1,
                   [held(r["dag"], f, r["outputs"][i])
                    for i, f in enumerate(r["frames"])],
                   frames=len(r["frames"]), shape=list(r["frames"][0].shape),
                   best=r["tuning"].best.combo,
                   tune_s=r["tuning"].stats.tune_s)

            # ---------------------------------------- memtrace_pipeline
            r, out, secs, k1 = run("examples/memtrace_pipeline_torch.py",
                                   EX_FULL)
            with open("memtrace_unsharp.json") as f:
                errs = validate_memtrace(json.load(f))
            errs += export.validate_trace(
                export.load_trace("memtrace_pipeline.json"))
            if errs:
                fail(f"memtrace_pipeline wrote invalid files: {errs[:3]}")
            report("memtrace_pipeline", out, secs, k1,
                   [held(r["dag"], q.frames["in"], r["results"][q.rid])
                    for q in r["requests"]], frames=len(r["requests"]),
                   smem_ring_bytes=r["memtrace"]["summary"][
                       "smem_ring_bytes"],
                   waste_frac=r["memtrace"]["summary"]["waste_frac"],
                   tuned_waste_frac=r["memtrace_tuned"]["summary"][
                       "waste_frac"])

            # -------------------------------------------- trace_serving
            r, out, secs, k1 = run("examples/trace_serving_torch.py",
                                   EX_FULL)
            errs = export.validate_trace(
                export.load_trace("trace_serving.json"))
            if errs or not r["excerpt"]:
                fail(f"trace_serving: trace errors {errs[:3]}, excerpt "
                     f"{r['excerpt']}")
            report("trace_serving", out, secs, k1,
                   [held(r["dag"], q.frames["in"], r["results"][q.rid])
                    for q in r["requests"]], frames=len(r["requests"]),
                   spans=sum(1 for e in r["trace"]["traceEvents"]
                             if e["ph"] == "X"))

            # ----------------------------------------------- imagen_dse
            r, out, secs, k1 = run("examples/imagen_dse_torch.py", EX_FULL)
            if sum(k1.values()):
                fail(f"imagen_dse launched the kernel: {k1}")
            report("imagen_dse", out, secs, k1, [], frames=0,
                   designs={n: len(p) for n, p in r["sweeps"].items()},
                   pareto={n: sum(x.pareto for x in p)
                           for n, p in r["sweeps"].items()},
                   plot=r["plot"])

            # ------------------------------------------------- serve_lm
            r, out, secs, k1 = run("examples/serve_lm_torch.py", EX_FULL)
            toks, reqs = r["results"], r["requests"]
            vocab = r["cfg"].vocab
            if sorted(toks) != sorted(q.rid for q in reqs) or any(
                    len(toks[q.rid]) != q.max_new
                    or not all(0 <= x < vocab for x in toks[q.rid])
                    for q in reqs):
                fail(f"serve_lm: tokens {toks}")
            n_tok = sum(map(len, toks.values()))
            report("serve_lm", out, secs, k1, [], tokens=n_tok,
                   tokens_per_s=n_tok / r["seconds"], arch=r["cfg"].name,
                   dtype=r["cfg"].dtype, slots=r["n_slots"],
                   max_len=r["max_len"],
                   kv_bytes_per_seq=r["kv_plan"].bytes_per_seq)
            del r
            gc.collect()
            torch.cuda.empty_cache()

            # ----------------------------------------------- obs_report
            files = {}
            for name, data in artifacts.items():
                files[name] = f"{name}.json"
                with open(files[name], "w") as f:
                    json.dump(data, f)
            files.update(trace_serving="trace_serving.json",
                         memtrace_unsharp="memtrace_unsharp.json",
                         memtrace_pipeline="memtrace_pipeline.json")
            firing = any(a["firing"]
                         for a in artifacts["storm_telemetry"]["alerts"])
            runs = [([files[n], "--validate"], 0) for n in files
                    if n != "storm_telemetry"]
            runs += [([files["storm_trace"]], 0),
                     ([files["storm_trace"], "--slo"], 0),
                     ([files["trace_serving"], "--top", "5"], 0),
                     ([files["burst_trace"], "--out", "clean.json"], 0),
                     ([files["perf_report_d1"]], 0),
                     ([files["perf_report_d2"], "--perf"], 0),
                     (["--diff", files["perf_report_d1"],
                       files["perf_report_d2"]], 0),
                     ([files["memtrace_canny"], "--memtrace"], 0),
                     ([files["memtrace_unsharp"]], 0),
                     ([files["storm_telemetry"], "--alerts"], int(firing))]
            rcs, secs, lines = [], 0.0, 0
            k1 = dict.fromkeys(total, 0)
            for argv, want in runs:
                rc, out, s_, k1_ = run("tools/obs_report_torch.py", argv)
                secs += s_
                k1 = {k: k1[k] + k1_[k] for k in k1}
                lines += len(out.splitlines())
                rcs.append(rc)
                if rc != want:
                    fail(f"obs_report_torch {argv}: exit {rc}, not {want}: "
                         f"{out[-2000:]}")
            emit("examples", twin="obs_report", seconds=secs, runs=len(runs),
                 k1_launches=k1, exit_codes=rcs, alerts_firing=firing,
                 lines=lines, artifacts=sorted(files))

            # --------------------------------------------- debug_memory
            rows, out, secs, k1 = run("tools/debug_memory_torch.py",
                                      EX_DEBUG)
            if len(rows) != 10 or "temp GiB: not known" not in out \
                    or f"on {label}" not in out:
                fail(f"debug_memory: {out[-2000:]}")
            emit("examples", twin="debug_memory", seconds=secs,
                 k1_launches=k1, command=" ".join(EX_DEBUG), top=[
                     {"bytes": b, "dtype": dt, "shape": list(sh), "op": op,
                      "module": m} for b, dt, sh, op, m in rows[:3]],
                 last_line=out.strip().splitlines()[-1])
        finally:
            os.chdir(cwd)
    emit("examples", part="total", k1_launches=total,
         kernel_launches_in_phase=dict(zip(
             ("conv2d", "swa_decode"),
             [c.launches - n for c, n in zip(others, others0)])),
         nvidia_smi=smi, phase_seconds=time.perf_counter() - t_phase)
    return total


def user_pipeline(temporal: bool = False):
    """A pipeline of plain torch stage functions, as a user of the DSL
    writes one (no built-in payload): a gradient magnitude, a peak test
    with a clamp and a 3x3 box mean of the peaks (a peak density, held to
    EXPR_BOUND_ULP: the card's eager mean sums in its own order); the
    temporal form first takes a pixel's rise above the darkest of its
    last three frames (a slice of the time axis), kept above 0.05."""
    from repro_torch.core.dsl import Pipeline

    def grad(w):
        win = w[next(iter(w))]
        gx = win[..., 1, 2] - win[..., 1, 0]
        gy = win[..., 2, 1] - win[..., 0, 1]
        return torch.sqrt(gx * gx + gy * gy + 1e-6)

    def peak(w):
        win = w["grad"]
        c = win[..., 1, 1]
        return torch.where(c >= win.amax((-2, -1)), torch.clamp(c, 0.0, 1.0),
                           0.0)

    def density(w):
        return w["peak"].mean((-2, -1))

    def motion(w):
        win = w["in"]
        d = win[..., -1, 0, 0] - win[..., :3, 0, 0].amin(-1)
        return torch.where(d > 0.05, d, 0.0)

    p = Pipeline("user-t" if temporal else "user")
    x = p.input("in")
    src = p.stage("motion", [(x, 4, 1, 1)], motion) if temporal else x
    g = p.stage("grad", [(src, 3, 3)], grad)
    k = p.stage("peak", [(g, 3, 3)], peak)
    d = p.stage("density", [(k, 3, 3)], density)
    p.output("out", [(d, 1, 1)])
    return p.build()


OPS_KINDS = ("exact", "transcendental", "sums", "divide", "rounding")


def rounding_ops(win) -> dict:
    """The "rounding" kind's ops (exact: 0 ULP) over a 3x3 window whose
    last element is the pixel: rounding to integers, fmod and remainder,
    float-to-int casts and window indices (ties from a clamp at 0.5)."""
    x = win[..., 2, 2] * 8.0 - 4.0                  # values in [-4, 4)
    d = win[..., 0, 0] + 0.25
    return {"floor": torch.floor(x), "ceil": torch.ceil(x),
            "trunc": torch.trunc(x),
            "round": torch.round(torch.floor(x * 4.0) / 2.0),
            "frac": torch.frac(x), "sign": torch.sign(x),
            "fmod": torch.fmod(x, d),
            "remainder": torch.remainder(x, -d) + x % 1.5,
            "int32": x.int().float(),
            "int64": (x * 1000.0).long().float(),
            "argmax": win.argmax(-1).float()[..., 1]
            + 3.0 * win.clamp(min=0.5).flatten(-2).argmax(-1),
            "argmin": win.argmin(-2).float()[..., 0]
            + 3.0 * win.clamp(max=0.5).flatten(-2).argmin(-1)}


def transcendental_ops(a) -> dict:
    """The "transcendental" kind's ops (the libraries': within
    EXPR_BOUND_ULP) of the pixel ``a`` in [0, 1): sin and cos over [-8,
    8) and [-8192, 8192) (power-of-two scales: the same argument on every
    device)."""
    x, pos = a * 8.0 - 4.0, a + 0.25
    return {"exp": torch.exp(x), "log": torch.log(pos),
            "tanh": torch.tanh(x), "rsqrt": torch.rsqrt(pos),
            "sigmoid": torch.sigmoid(x), "erf": torch.erf(x),
            "sin": torch.sin(a * 16.0 - 8.0),
            "cos": torch.cos(a * 16.0 - 8.0),
            "sin_large": torch.sin(a * 16384.0 - 8192.0),
            "cos_large": torch.cos(a * 16384.0 - 8192.0),
            "pow": pos ** 1.7, "pow_tensor": torch.pow(pos, a),
            "pow_scalar": 2.0 ** x}


SELECTED_OPS = {"rounding": tuple(rounding_ops(torch.zeros(1, 3, 3))),
                "transcendental": tuple(transcendental_ops(torch.zeros(1)))}


def select_op(ops: dict, left):
    """Op i of ``ops`` at a pixel whose left neighbour ``left`` (in [0,
    1)) has floor(n * left) == i."""
    vals = list(ops.values())
    k = torch.floor(left * float(len(vals)))
    out = vals[-1]
    for i in reversed(range(len(vals) - 1)):
        out = torch.where(k == float(i), vals[i], out)
    return out


def op_classes(x, n: int):
    """The op index each pixel of frames ``x`` takes in :func:`select_op`
    (its left neighbour, 0 at column 0, times ``n``, floored)."""
    left = torch.zeros_like(x)
    left[..., 1:] = x[..., :-1]
    return torch.floor(left * float(n))


def ops_pipeline(kind: str = "exact"):
    """With the user pipelines, every instruction of the expression body,
    one kind of rounding a pipeline: producers "a" (the pixel) and "b" (a
    neighbour), then ``exact``: a quotient of two pixels, products,
    comparisons, logic, where, abs, max, min, negation and a constant
    stage (a copy), equal to eager PyTorch on the card bit for bit;
    ``rounding``: :func:`rounding_ops`, one a pixel picked by its left
    neighbour (:func:`select_op`), bit for bit; or, held to
    EXPR_BOUND_ULP, ``transcendental``: :func:`transcendental_ops` (exp,
    log, tanh, rsqrt, sigmoid, erf, sin, cos, powf) picked likewise;
    ``sums``: a sum and a mean over a 3x3 window; ``divide``: a division
    by a Python scalar (eager CUDA multiplies by its reciprocal)."""
    from repro_torch.core.dsl import Pipeline

    def first(w):
        return w["in"][..., 0, 0]

    def exact(w):
        u, v = w["a"][..., 0, 0], w["b"][..., 0, 0]
        keep = ((u < v) & (u <= 0.75)) | ~(u == v) & (v != 0.5) \
            | (u * v > 0.25) & (u >= 0.5)
        return torch.where(keep, -(u / (v + 1.0)), torch.abs(u - v)) \
            + torch.maximum(u, v) - torch.minimum(u, v)

    def transcendental(w):
        return select_op(transcendental_ops(w["a"][..., 0, 0]),
                         w["b"][..., 0, 0])

    def rounding(w):
        return select_op(rounding_ops(w["a"]), w["b"][..., 0, 0])

    def sums(w):
        win = w["a"]
        return win.sum((-2, -1)) - win.mean((-2, -1))

    def divide(w):
        return w["a"][..., 0, 0] / 7.0

    p = Pipeline(f"ops-{kind}")
    x = p.input("in")
    a = p.stage("a", [(x, 1, 1)], first)
    fn = {"exact": exact, "transcendental": transcendental, "sums": sums,
          "divide": divide, "rounding": rounding}[kind]
    if kind in ("sums", "divide"):
        out = p.stage("s", [(a, 3, 3) if kind == "sums" else (a, 1, 1)], fn)
    else:
        b = p.stage("b", [(x, 1, 2)], first)
        out = p.stage("s", [(a, 3, 3) if kind == "rounding" else (a, 1, 1),
                            (b, 1, 1)], fn)
    if kind == "exact":
        k = p.stage("k", [(x, 1, 1)],
                    lambda w: torch.full_like(w["in"][..., 0, 0], 0.25))
        out = p.stage("o", [(out, 1, 1), (k, 1, 1)],
                      lambda w: w["s"][..., 0, 0] + w["k"][..., 0, 0])
    p.output("out", [(out, 1, 1)])
    return p.build()


def expr_phase(dev, mem_rate: float, flop_rate: float, sms: int) -> dict:
    """Phase 17: user-written stage functions through K1's expression
    body (each program's generated bodies in a library of its own).
    Returns the kernels-line entry."""
    from repro_torch.core import algorithms, expr, fuzz
    from repro_torch.core.codegen import compile_pipeline
    from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
    from repro_torch.kernels import _build
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.resilience import ResilienceConfig, RetryPolicy
    from repro_torch.video import VideoEngine, VideoFrame
    t_phase = time.perf_counter()
    kern = sp.stencil_pipeline
    names = sorted(algorithms.ALGORITHMS)
    vnames = sorted(algorithms.VIDEO_ALGORITHMS)
    max_err, max_ulp, cases = 0.0, 0.0, 0
    bounded = {}                     # where -> ULP, the checks held to a bound
    xops = set()                     # the instructions the phase ran
    rng = np.random.RandomState(SEED + 17)

    def check(got, exp, where, bound=TOLERANCE_ULP):
        nonlocal max_err, max_ulp, cases
        err, ulp = ulp_err(got, exp)
        if ulp > bound:
            fail(f"expr {where}: differs by {ulp} ULP (abs {err}; "
                 f"bound {bound})")
        max_err = max(max_err, err)
        if bound == TOLERANCE_ULP:
            max_ulp = max(max_ulp, ulp)
        else:
            bounded[where] = ulp
        cases += 1

    def program(dag, n, depth=1, plan=None):
        return sp.build_program(dag, SERVE_H, SERVE_W, SERVE_R, frames=n,
                                prefetch_depth=depth,
                                poison_prefetch=depth > 1,
                                alloc_buffers=plan.alloc.buffers
                                if plan else None)

    def launch(dag, x, states, depth=1, plan=None):
        """(program, output, plain output) of ``dag`` over ``x``."""
        prog = program(dag, x.shape[0], depth, plan)
        for ex in prog.exprs.values():
            xops.update(expr.XOPS[int(word) & 255] for word in ex.code[:, 0])
        before = kern.expr_launches
        got = kern(prog, [x], states)
        torch.cuda.synchronize()
        if bool(prog.exprs) != (kern.expr_launches == before + 1):
            fail(f"expr {dag.name}: the expression instantiation launched "
                 f"{kern.expr_launches - before} times")
        inputs = {"in": x}
        exp, _ = sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs,
                                     dict(zip(prog.states, states)),
                                     x.shape[0])})
        return prog, got, exp

    def states_for(dag):
        depths = dag.temporal_depths()
        return [torch.from_numpy(rng.rand(depths[p] - 1, SERVE_H, SERVE_W)
                                 .astype(np.float32)).to(dev)
                for p in sorted(depths, key=dag.topo_order.index)]

    pipelines = {}
    for name in names + vnames:
        dag = (algorithms.ALGORITHMS.get(name)
               or algorithms.VIDEO_ALGORITHMS[name])()
        pipelines[name] = (dag, expr.bare_pipeline(dag),
                           compile_pipeline(dag, SERVE_W))
    fuzz_dags = [fuzz.random_pipeline(seed, conv, temporal=temporal)
                 for seed in range(8)
                 for conv in (algorithms.conv_fn, fuzz.bare_conv)
                 for temporal in (False, True)]
    spatial, temporal = user_pipeline(), user_pipeline(temporal=True)

    # (0) every library the phase launches from, built in one wave before
    # the checks: one per program with an expression stage (its generated
    # bodies, the one instantiation it launches). The user pipelines' are
    # left to the main path, which meets them unbuilt as a user does.
    wave = [program(bare, SERVE_B, d, plan)
            for _, bare, plan in pipelines.values() for d in (1, 2)]
    wave += [program(g, SERVE_B) for g in fuzz_dags]
    wave += [program(ops_pipeline(k), SERVE_B, d) for k in OPS_KINDS
             for d in (1, 2)]
    t0 = time.perf_counter()
    built = sp.build_libraries(wave)
    build_s = time.perf_counter() - t0
    # library -> its entry's registers and local memory, read from the
    # loaded library in this run whether nvcc built it now or earlier
    generated = {prog.library_spec.name: sp.kernel_attributes(prog)
                 for prog in wave if prog.exprs}
    emit("expr", part="build", libraries=len(generated), built=len(built),
         wall_s=build_s, nvcc_s=sum(built.values()),
         nvcc_s_max=max(built.values(), default=None),
         seconds=built, ptxas={n: _build.ptxas(n) for n in built},
         attributes=generated)
    wave_libraries = len(generated)

    # (a) the bare forms: the 7 spatial pipelines at depths 1 and 2 and
    # the 4 video pipelines in chunks of 4 over random frame-ring states,
    # each equal to the payload form and the plain version
    progs = {}
    for name, (dag, bare, plan) in pipelines.items():
        x = torch.from_numpy(frames(17000 + cases, SERVE_B, SERVE_H,
                                    SERVE_W)).to(dev)
        states = states_for(dag)
        for depth in (1, 2):
            pp, got_p, _ = launch(dag, x, states, depth, plan)
            bp, got_b, exp = launch(bare, x, states, depth, plan)
            where = f"{name} depth {depth}"
            check(got_b, exp, where + " bare vs plain")
            check(got_b, got_p, where + " bare vs payload")
            if depth == 1:
                progs[name] = (pp, bp, x, states)

    # (b) the fuzz DAGs, seeds 0-7: convolutions as payloads and lowered,
    # spatial and temporal
    for i, dag in enumerate(fuzz_dags):
        x = torch.from_numpy(frames(17500 + i // 4, SERVE_B, SERVE_H,
                                    SERVE_W)).to(dev)
        conv = "bare_conv" if i % 4 >= 2 else "conv_fn"
        _, got, exp = launch(dag, x, states_for(dag))
        check(got, exp, f"{dag.name} ({conv})")

    # (c) every instruction of the expression body: the ops pipelines at
    # depths 1 and 2 (the user pipelines below take sqrt and the rest)
    x = torch.from_numpy(frames(17800, SERVE_B, SERVE_H, SERVE_W)).to(dev)
    op_ulp = {k: {} for k in SELECTED_OPS}       # kind -> op -> worst ULP
    for kind in OPS_KINDS:
        dag = ops_pipeline(kind)
        bound = TOLERANCE_ULP if kind in ("exact", "rounding") \
            else EXPR_BOUND_ULP
        for depth in (1, 2):
            _, got, exp = launch(dag, x, [], depth)
            check(got, exp, f"{dag.name} depth {depth}", bound)
            if kind not in SELECTED_OPS:
                continue
            cls = op_classes(x, len(SELECTED_OPS[kind]))
            for i, op in enumerate(SELECTED_OPS[kind]):
                at = cls == i
                if not bool(at.any()):
                    fail(f"expr {dag.name}: no pixel takes {op}")
                _, ulp = ulp_err(got[at], exp[at])
                if ulp > bound:
                    fail(f"expr {dag.name} depth {depth}: {op} differs by "
                         f"{ulp} ULP (bound {bound})")
                op_ulp[kind][op] = max(op_ulp[kind].get(op, 0.0), ulp)
    emit("expr", part="ops", worst_ulp=op_ulp,
         bounds={"rounding": TOLERANCE_ULP,
                 "transcendental": EXPR_BOUND_ULP},
         arguments={"sin, cos": [-8.0, 8.0],
                    "sin_large, cos_large": [-8192.0, 8192.0],
                    "exp, tanh, sigmoid, erf": [-4.0, 4.0],
                    "log, rsqrt, pow, pow_tensor": [0.25, 1.25],
                    "pow_scalar": "2 ** [-4, 4)"},
         ulp_at="each op's pixels' scale")

    # (d) the main path: a user pipeline through a resilient FrameEngine
    # (fault free) and its temporal form through a resilient VideoEngine,
    # the kernel's counts set to 0 just before and read just after. Their
    # libraries are not built yet and an attempt times out long before
    # an nvcc build ends, so the first frame is served on the primary
    # rung only if the builds ran at admission, outside the ladder.
    users = {sp.build_program(dag, SERVE_H, SERVE_W, SERVE_R,
                              prefetch_depth=d).library_spec.name
             for dag in (spatial, temporal) for d in (1, 2)}
    for dag in (spatial, temporal):
        for ex in sp.build_program(dag, SERVE_H, SERVE_W, SERVE_R
                                   ).exprs.values():
            xops.update(expr.XOPS[int(word) & 255] for word in ex.code[:, 0])
    if xops != set(expr.XOPS):
        fail(f"expr: the phase runs no {sorted(set(expr.XOPS) - xops)}")
    cache = PlanCache(pipelines={spatial.name: lambda: spatial,
                                 temporal.name: lambda: temporal},
                      device=dev)
    resilience = ResilienceConfig(retry=RetryPolicy(
        max_attempts=1, timeout_s=ATTEMPT_TIMEOUT_S))
    feng = FrameEngine(cache=cache, max_batch=SERVE_B,
                       rows_per_step=SERVE_R, tile_shape=(SERVE_H, SERVE_W),
                       resilience=resilience)
    veng = VideoEngine(cache=cache, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
                       resilience=resilience, device=dev)
    frame_in = list(frames(17900, 2 * SERVE_B, SERVE_H, SERVE_W))
    streams = {j: frames(17950 + j, STREAM_FRAMES, SERVE_H, SERVE_W)
               for j in range(STREAMS_PER_PIPELINE)}
    kern.launches = kern.prefetch_launches = kern.temporal_launches = 0
    kern.expr_launches = 0
    unbuilt = {n for n in users if n not in _build._LIBS
               and not (_build.BUILD_DIR / f"lib{n}.so").exists()}
    t0 = time.perf_counter()
    for i, f in enumerate(frame_in):
        if feng.submit(FrameRequest(rid=i, pipeline=spatial.name,
                                    frames={"in": f})) is not True:
            fail(f"expr: request {i} refused")
    admit_s = time.perf_counter() - t0
    served = {c.rid: c for c in feng.step()}
    first_frame_s = time.perf_counter() - t0
    served.update((c.rid, c) for c in drain(feng))
    t1 = time.perf_counter()
    sids = {veng.open_stream(temporal.name, SERVE_H, SERVE_W): j
            for j in streams}
    open_s = time.perf_counter() - t1
    vdone = {j: [] for j in streams}
    first_chunk_s = None
    for t in range(0, STREAM_FRAMES, VIDEO_CHUNK):
        for sid, j in sids.items():
            for f in streams[j][t:t + VIDEO_CHUNK]:
                if veng.submit(VideoFrame(sid, {"in": f})) is not True:
                    fail(f"expr: stream {sid} refused a frame")
        for c in drain(veng):
            vdone[sids[c.stream]].append(c)
        if first_chunk_s is None:
            first_chunk_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    user_built = {n: s for n, s in _build.BUILD_LOG.items() if n in users}
    generated.update({p.library_spec.name: sp.kernel_attributes(p)
                      for p in (program(spatial, SERVE_B),
                                program(temporal, VIDEO_CHUNK))})
    emit("expr", part="admission", unbuilt_before=len(unbuilt),
         built=len(user_built), attempt_timeout_s=ATTEMPT_TIMEOUT_S,
         frame_admit_s=admit_s, first_frame_s=first_frame_s,
         stream_open_s=open_s, first_chunk_s=first_chunk_s,
         ptxas={n: _build.ptxas(n) for n in user_built})
    main_launches = {"expr": kern.expr_launches, "total": kern.launches,
                     "temporal": kern.temporal_launches}
    if kern.expr_launches == 0 or kern.expr_launches != kern.launches:
        fail(f"expr: the main path launched the expression instantiation "
             f"{kern.expr_launches} of {kern.launches} times")
    rungs = {c.rung for c in served.values()} | {
        c.rung for cs in vdone.values() for c in cs}
    if sorted(served) != list(range(len(frame_in))) or rungs != {"default"} \
            or feng.metrics.fallback_frames or veng.metrics.fallback_frames \
            or feng.metrics.executor_retries or veng.metrics.executor_retries:
        fail(f"expr: fault-free user pipelines served rungs {sorted(rungs)}")
    for i, f in enumerate(frame_in):
        x = torch.from_numpy(f).to(dev)
        check(served[i].output, sp.stencil_pipeline_plain(spatial, {"in": x}),
              f"served user frame {i}", EXPR_BOUND_ULP)
    for j, cs in vdone.items():
        if [c.index for c in cs] != list(range(STREAM_FRAMES)):
            fail(f"expr: stream {j} delivered {[c.index for c in cs]}")
        want = plain_stream(temporal, torch.from_numpy(streams[j]).to(dev))
        check(torch.stack([c.output for c in cs]), want,
              f"user stream {j}", EXPR_BOUND_ULP)

    # (e) times: the expression form beside the payload form, per
    # pipeline, at depth 1 (the 7 at B=4, the 4 in chunks of 4)
    per = {}
    for name, (pp, bp, x, states) in progs.items():
        def run_p():
            kern(pp, [x], states)

        def run_b():
            kern(bp, [x], states)
        nbytes, ops = sp.launch_work(bp, SERVE_B)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / flop_rate * 1e3
        bare = expr.bare_pipeline(pp.dag)
        per[name] = {
            "ms": cuda_ms(run_b, iters=10),
            "device_ms": device_ms(run_b, 10)[0],
            "payload_ms": cuda_ms(run_p, iters=10),
            "payload_device_ms": device_ms(run_p, 10)[0],
            "plain_ms": cuda_ms(lambda: sp.video_pipeline_plain(bare, {
                "in": x, **sp.tap_feeds(bare, {"in": x},
                                        dict(zip(bp.states, states)),
                                        SERVE_B)}), iters=3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "instructions": sum(len(e.code) for e in bp.exprs.values()),
            "live_values": max(e.n_regs for e in bp.exprs.values()),
            **generated[bp.library_spec.name],
            **k1_resources(bp, SERVE_B, sms),
            "payload_blocks_per_sm": sp.blocks_per_sm(pp)}
        per[name]["ratio"] = per[name]["device_ms"] \
            / per[name]["payload_device_ms"]
    payload_attrs = {
        k + ("_prefetch" if d > 1 else ""): sp.kernel_attributes(program(
            pipelines[n][0], SERVE_B, d, pipelines[n][2]))
        for k, n in (("spatial", names[0]), ("temporal", vnames[0]))
        for d in (1, 2)}
    sums = {k: sum(per[n][k] for n in names)
            for k in ("ms", "device_ms", "payload_ms", "payload_device_ms",
                      "plain_ms", "bound_ms")}
    vsums = {k: sum(per[n][k] for n in vnames)
             for k in ("ms", "device_ms", "payload_ms", "payload_device_ms",
                       "plain_ms", "bound_ms")}
    emit("expr", kernel="stencil_pipeline (expression)", cases=cases,
         shape=[SERVE_H, SERVE_W], batch=SERVE_B, rows_per_step=SERVE_R,
         chunk=VIDEO_CHUNK, depths=[1, 2], fuzz_seeds=list(range(8)),
         main_path_launches=main_launches, serve_s=serve_s,
         user_frames=len(frame_in),
         user_stream_frames=STREAM_FRAMES * len(streams),
         max_abs_err=max_err, max_ulp=max_ulp, tolerance_ulp=TOLERANCE_ULP,
         bounded_max_ulp=max(bounded.values()), bound_ulp=EXPR_BOUND_ULP,
         bounded_ulp=bounded, instructions=sorted(xops),
         payload_attributes=payload_attrs, spatial=sums, video=vsums, per_pipeline=per,
         engine_exec_compile_s=cache.stats.exec_compile_s,
         first_frame_s=first_frame_s, first_chunk_s=first_chunk_s,
         phase_seconds=time.perf_counter() - t_phase)
    return {"launches": main_launches["expr"], "max_abs_err": max_err,
            "max_ulp": max_ulp, "bounded_max_ulp": max(bounded.values()),
            "bound_ulp": EXPR_BOUND_ULP, **sums,
            "video": vsums,
            "build_s": build_s, "build_libraries": wave_libraries,
            "nvcc_s_max": max(built.values(), default=None),
            "registers": {n: per[n]["registers"] for n in names + vnames},
            "measured_libraries": len(generated),
            "max_registers": max(a["registers"]
                                 for a in generated.values()),
            "max_local_bytes": max(a["local_bytes"]
                                   for a in generated.values()),
            "payload_attributes": payload_attrs,
            "first_frame_s": first_frame_s,
            "first_chunk_s": first_chunk_s,
            "admission_libraries_built": len(user_built),
            "blocks_per_sm": {n: per[n]["blocks_per_sm"]
                              for n in names + vnames},
            "payload_blocks_per_sm": {n: per[n]["payload_blocks_per_sm"]
                                      for n in names + vnames},
            "bound_by": "bytes" if all(per[n]["bound_by"] == "bytes"
                                       for n in names) else "operations"}

def _registers(lib: str, pattern: str) -> dict | None:
    """ptxas's registers and spill bytes of the one entry function of
    library ``lib`` whose mangled name holds ``pattern``."""
    from repro_torch.kernels import _build
    hits = [v for k, v in _build.ptxas(lib).items() if pattern in k]
    return hits[0] if len(hits) == 1 else None


# the shared library's instantiations: <kTemporal, kPrefetch> (a program
# with an expression stage has its own library of one)
K1_INSTANCES = {"spatial": "ILb0ELb0EE", "temporal": "ILb1ELb0EE",
                "spatial_prefetch": "ILb0ELb1EE",
                "temporal_prefetch": "ILb1ELb1EE"}


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


def unorm8_phase(dev, mem_rate: float) -> dict:
    """Phase 4b: the unorm8 decode on its main path and alone. Returns
    the kernels-line entry."""
    from repro_torch.core import algorithms
    from repro_torch.imaging import FrameEngine, FrameRequest
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import unorm8
    from repro_torch.obs import trace
    names = sorted(algorithms.ALGORITHMS)
    rng = np.random.default_rng(SEED + 48)
    pool = rng.integers(0, 256, (U8_POOL, U8_H, U8_W), dtype=np.uint8)
    eng = FrameEngine(device=dev, max_batch=SERVE_B, rows_per_step=SERVE_R,
                      tile_shape=(U8_H, U8_W), pixels="unorm8")
    reqs = [FrameRequest(rid=i, pipeline=names[i % len(names)],
                         frames={"in": pool[i % U8_POOL]})
            for i in range(SERVE_B * len(names))]
    eng.run(reqs)                      # plans, executors, the library
    torch.cuda.synchronize()

    unorm8.decode.launches = 0
    trace.clear()
    trace.enable()
    try:
        t0 = time.perf_counter()
        served = {(k, rid): out for k in range(U8_ROUNDS)
                  for rid, out in eng.run(reqs).items()}
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        events = trace.events()
    finally:
        trace.disable()
        trace.clear()
    launches = unorm8.decode.launches
    asm = [e for e in events if e.name == "engine.assemble"]
    dec = [e for e in events if e.name == "engine.unorm8"]
    if launches != len(asm) or len(dec) != launches:
        fail(f"unorm8: {launches} decode launches for {len(asm)} "
             f"hand-overs and {len(dec)} engine.unorm8 spans")
    if any(e.parent != "engine.assemble" for e in dec):
        fail("unorm8: a decode ran outside engine.assemble")
    n_frames = U8_ROUNDS * len(reqs)
    h2d = sum(int(e.attrs.get("h2d_bytes", 0)) for e in asm)
    if h2d != n_frames * U8_H * U8_W:
        fail(f"unorm8: h2d_bytes {h2d} for {n_frames} frames")
    max_ulp = 0.0
    for (k, rid), out in served.items():
        r = reqs[rid]
        if not isinstance(out, torch.Tensor):
            fail(f"unorm8: request {rid} not served: {out!r}")
        x = unorm8.decode_plain(torch.from_numpy(r.frames["in"]).to(dev))
        exp = sp.stencil_pipeline_plain(eng.cache.dag_for(r.pipeline),
                                        {"in": x})
        _, ulp = ulp_err(out, exp)
        if ulp > TOLERANCE_ULP:
            fail(f"unorm8: served frame {rid} ({r.pipeline}) differs from "
                 f"plain by {ulp} ULP")
        max_ulp = max(max_ulp, ulp)

    values = torch.arange(256, dtype=torch.int32, device=dev) \
        .to(torch.uint8)
    raw = torch.from_numpy(pool[:SERVE_B]).to(dev)
    odd = torch.from_numpy(pool[:3, :37, :53].copy()).to(dev)
    cases = [values, raw, odd, odd.flatten()[1:]]     # the last misaligned
    for x in cases:
        if not torch.equal(unorm8.decode(x), unorm8.decode_plain(x)):
            fail(f"unorm8: the kernel differs from decode_plain on "
                 f"{tuple(x.shape)}")
    lib_values = torch.div(values, 255.0)
    mismatched = int((lib_values != unorm8.decode_plain(values)).sum())
    out = torch.empty(raw.shape, dtype=torch.float32, device=dev)
    nbytes = 5 * raw.numel()           # a byte read, four written a pixel

    def kernel():
        unorm8.decode(raw, out)

    def library():
        torch.div(raw, 255.0)
    entry = {"launches": launches, "max_abs_err": 0.0, "max_ulp": max_ulp,
             "ms": cuda_ms(kernel, iters=200),
             "device_ms": device_ms(kernel, 50)[0],
             "plain_ms": cuda_ms(lambda: unorm8.decode_plain(raw), iters=20),
             "bound_ms": nbytes / mem_rate * 1e3, "bound_by": "bytes",
             "library_ms": cuda_ms(library, iters=200),
             "library_device_ms": device_ms(library, 50)[0],
             "library_values_off": mismatched}
    emit("unorm8", kernel=unorm8.decode.name, shape=[U8_H, U8_W],
         frames=n_frames, batch=SERVE_B, pipelines=names,
         hand_overs=len(asm),
         staged=sum(1 for e in asm if e.attrs.get("pinned_bytes")),
         ahead_bytes=sum(int(e.attrs.get("ahead_bytes", 0)) for e in asm),
         h2d_bytes=h2d, serve_s=serve_s, fps=n_frames / serve_s,
         checked_frames=len(served), decode_cases=[list(x.shape)
                                                   for x in cases],
         bytes=nbytes, **entry)
    unorm8_video(dev)
    return entry


def unorm8_video(dev) -> None:
    """Phase 4b's video part: ``VideoEngine(pixels="unorm8")`` serving one
    3840x2160 uint8 stream a video pipeline, a chunk of 4 frames, then
    frames one at a time, traced: one decode launch and one
    ``engine.unorm8`` span inside each ``engine.assemble``, a byte a
    pixel across, every output against the plain version over the
    table-decoded stream."""
    from repro_torch.core import algorithms
    from repro_torch.kernels import stencil_pipeline as sp
    from repro_torch.kernels import unorm8
    from repro_torch.obs import trace
    from repro_torch.video import CompletedVideoFrame, VideoEngine, \
        VideoFrame
    names = sorted(algorithms.VIDEO_ALGORITHMS)
    n = 2 * VIDEO_CHUNK
    eng = VideoEngine(device=dev, chunk=VIDEO_CHUNK, rows_per_step=SERVE_R,
                      pixels="unorm8")
    rng = np.random.default_rng(SEED + 49)
    streams = {eng.open_stream(name, U8_H, U8_W): (name, rng.integers(
        0, 256, (n, U8_H, U8_W), dtype=np.uint8)) for name in names}
    done = {sid: [] for sid in streams}
    # the first chunk builds the executors; the frames after it go one at
    # a time, so both paths serve
    groups = [VIDEO_CHUNK] + [1] * (n - VIDEO_CHUNK)
    launches = unorm8.decode.launches
    trace.clear()
    trace.enable()
    try:
        t0 = time.perf_counter()
        t = 0
        for g in groups:
            for sid, (_, vid) in streams.items():
                for f in vid[t:t + g]:
                    if eng.submit(VideoFrame(sid, {"in": f})) is not True:
                        fail(f"unorm8 video: stream {sid} refused a frame")
            while eng.pending:
                for c in eng.step():
                    if not isinstance(c, CompletedVideoFrame):
                        fail(f"unorm8 video: stream {c.stream}: {c!r}")
                    done[c.stream].append(c.output)
            t += g
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        events = trace.events()
    finally:
        trace.disable()
        trace.clear()
    launches = unorm8.decode.launches - launches
    asm = [e for e in events if e.name == "engine.assemble"]
    dec = [e for e in events if e.name == "engine.unorm8"]
    if not launches == len(asm) == len(dec) == len(streams) * len(groups):
        fail(f"unorm8 video: {launches} decode launches, {len(asm)} "
             f"hand-overs, {len(dec)} engine.unorm8 spans")
    if any(e.parent != "engine.assemble" for e in dec):
        fail("unorm8 video: a decode ran outside engine.assemble")
    h2d = sum(int(e.attrs.get("h2d_bytes", 0)) for e in asm)
    if h2d != len(streams) * n * U8_H * U8_W:
        fail(f"unorm8 video: h2d_bytes {h2d}")
    max_ulp = 0.0
    for sid, (name, vid) in streams.items():
        if len(done[sid]) != n:
            fail(f"unorm8 video: stream {sid} delivered {len(done[sid])}")
        x = unorm8.decode_plain(torch.from_numpy(vid).to(dev))
        _, ulp = ulp_err(torch.stack(done[sid]),
                         plain_stream(eng.cache.dag_for(name), x))
        if ulp > TOLERANCE_ULP:
            fail(f"unorm8 video: stream {sid} ({name}) differs from plain "
                 f"by {ulp} ULP")
        max_ulp = max(max_ulp, ulp)
    rolls = [e for e in events if e.name == "executor.roll"]
    emit("unorm8", part="video", shape=[U8_H, U8_W], pipelines=names,
         frames=len(streams) * n, chunk=VIDEO_CHUNK, hand_overs=len(asm),
         decode_launches=launches, h2d_bytes=h2d,
         roll_bytes=sum(int(e.attrs.get("roll_bytes", 0)) for e in rolls),
         serve_s=serve_s, max_ulp=max_ulp)


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
    smi = card_info()["nvidia_smi"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", kind=kind, capability=list(cap), sms=sms,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    sheet = datasheet_peaks(kind)
    mem_rate, flop_rate = sheet.hbm_bytes_per_s, sheet.flops_per_s

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

    nan_cases = nan_frames_check(dev)

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

    # --------------------------------------------- 4b. 8-bit frames
    ku8 = unorm8_phase(dev, mem_rate)

    # ------------------------------------------- 5-7. the video path
    k1c_err, k1c_ulp = video_kernel_phase(dev)
    k1c = video_serve_phase(dev, mem_rate, flop_rate, sms)
    tuned_phase(dev)

    # ------------------------------------- 8-10. depth, conv2d, swa_decode
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    k1d = depth_phase(dev, mem_rate, flop_rate, sms)
    k2 = conv2d_phase(dev, mem_rate, flop_rate)
    k3 = swa_phase(dev, mem_rate, flop_rate)

    # ---------------------------------------------------- 11. resilience
    res = resilience_phase(dev)

    # ---------------------------------------------- 12. perf and memtrace
    perf = perf_phase(dev, kind)

    # ---------------------------------------- 13. the LM serving stack
    lm_serve_phase(dev, kind)

    # ------------------------------------------------- 14. LM training
    lm_train_phase(dev, kind)

    # ----------------------- 15. launch helpers, distributed/, dry run
    launch_phase(dev, kind)

    # ------------------------------------- 16. the examples' and tools' twins
    ex = examples_phase(dev, {**res["artifacts"], **perf["artifacts"]})

    # ------------------------- 17. user stage functions (expression body)
    kx = expr_phase(dev, mem_rate, flop_rate, sms)

    # --------------------------------------------------- 18. kernels line
    share: dict[str, float] = {}
    for p in per.values():
        share[p["bound_by"]] = share.get(p["bound_by"], 0.0) + p["bound_ms"]
    print(json.dumps({"kernels": [{
        "name": sp.stencil_pipeline.name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "launches": launches, "launches_resilience": res["spatial"],
        "launches_perf": perf["spatial"],
        "launches_examples": ex["spatial"],
        "max_abs_err": max_err, "max_ulp": max_ulp,
        "nan_frame_cases": nan_cases,
        "max_form": "PTX max.NaN.f32 / min.NaN.f32 (nms, denoise_comb)",
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
        "launches_resilience": res["temporal"],
        "launches_perf": perf["temporal"],
        "launches_examples": ex["temporal"],
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
        "launches": k1d["launches"],
        "launches_resilience": res["prefetch"],
        "launches_perf": perf["prefetch"],
        "launches_examples": ex["prefetch"],
        "max_abs_err": k1d["max_abs_err"],
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
        "name": f"{sp.stencil_pipeline.name} (expression)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": "src/repro/kernels/stencil_pipeline.py:423",
        "replaces_part": "a stage's fn traced into the kernel (:267)",
        "launches": kx["launches"], "max_abs_err": kx["max_abs_err"],
        "max_ulp": kx["max_ulp"], "bounded_max_ulp": kx["bounded_max_ulp"],
        "bound_ulp": kx["bound_ulp"],
        **{k: kx[k] for k in ("ms", "device_ms", "payload_ms",
                              "payload_device_ms", "plain_ms", "bound_ms",
                              "bound_by", "video", "build_s",
                              "build_libraries", "nvcc_s_max",
                              "registers", "measured_libraries",
                              "max_registers", "max_local_bytes",
                              "payload_attributes", "first_frame_s",
                              "first_chunk_s", "admission_libraries_built",
                              "blocks_per_sm", "payload_blocks_per_sm")},
        "library_ms": None,
        "timed_on": f"one B={SERVE_B} {SERVE_H}x{SERVE_W} R={SERVE_R} "
                    f"batch of the bare form of each of the {len(names)} "
                    f"pipelines at depth 1 (payload_*: the same batch "
                    f"through the payload bodies; video: one "
                    f"chunk-{VIDEO_CHUNK} launch of each of the 4 video "
                    f"pipelines); launches: the user pipelines' main path",
    }, {
        "name": "unorm8_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stencil_pipeline.cu",
        "replaces": None,
        "replaces_part": "no TPU kernel: the JAX package takes float frames "
                         "only; the decode of 8-bit frames on the card",
        **{key: ku8[key] for key in ("launches", "max_abs_err", "max_ulp",
                                    "ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms",
                                    "library_values_off")},
        "library": "torch.div(uint8 batch, 255.0)",
        "timed_on": f"a batch of {SERVE_B} {U8_H}x{U8_W} uint8 frames",
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
