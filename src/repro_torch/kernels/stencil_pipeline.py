"""Fused line-buffered stencil pipeline — the paper's accelerator on Hopper.

One CUDA kernel (``csrc/stencil_pipeline.cu``) executes the *entire*
pipeline DAG over a batch of frames: every stage computes its rows in
row groups of ``rows_per_step`` (R), reading its producers' rows from
shared-memory ring line buffers and writing its own ring, so only input
and output pixels touch device memory. One CTA owns one (frame, column
strip, row band) and recomputes the strip's and band's halo from real
input (see the source note there).

This module holds, beside the kernel:

  * :func:`build_program` — the per-plan stage table the kernel walks
    (op codes, rings, operand order, float32 constants), and the launch
    geometry and shared-memory bill;
  * :func:`stencil_pipeline_plain` — the kernel's plain PyTorch version:
    whole-frame, stage by stage, through the same payloads. The CPU
    tests use it, and ``chip_smoke.py`` holds the kernel against it;
  * :data:`stencil_pipeline` — the wrapper. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises;
  * :class:`StencilExecutor` and :func:`make_executor` — the
    serving-side artifact over one (h, w, batch) shape.

Only spatial pipelines at ``prefetch_depth == 1`` run here; temporal
pipelines and deeper prefetch are refused with an error.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.algorithms import Payload, execute_reference
from repro_torch.core.codegen import PipelinePlan
from repro_torch.core.dag import PipelineDAG, window_keys
from repro_torch.obs import trace

from . import _build

# op codes, in the order of ``enum Op`` in csrc/stencil_pipeline.cu
OPS = ("input", "relay", "conv", "square", "identity", "mag", "prod",
       "nms", "thresh", "unsharp", "xcorr", "denoise_comb", "harris_resp")
# operands each payload op reads, and the float32 scalars it takes
_ARITY = {"conv": 1, "square": 1, "identity": 1, "mag": 2, "prod": 2,
          "nms": 1, "thresh": 1, "unsharp": 2, "xcorr": 2,
          "denoise_comb": 3, "harris_resp": 1}
_CONSTS = {"mag": 1, "thresh": 1, "unsharp": 1, "harris_resp": 1}

# table layout, as in csrc/stencil_pipeline.cu
HDR, MAX_STAGES, STAGE_INTS, MAX_RINGS = 16, 24, 16, 24
MAX_WTS, MAX_FEEDS, MAX_SRC = 256, 4, 3
TABLE_INTS = HDR + MAX_STAGES * STAGE_INTS + MAX_RINGS * 2
(H_NSTAGES, H_R, H_H, H_W, H_STRIP_W, H_HALO_LEFT, H_NCOLS, H_BAND_H,
 H_HALO_UP, H_SMEM_BYTES) = range(10)
S_OP, S_RING, S_FINAL, S_FEED, S_NSRC, S_SRC, S_SH, S_SW, S_WOFF = \
    0, 1, 2, 3, 4, 5, 8, 11, 14

# Launch geometry from perf/geometry_sweep.py at 1080p, R=8: faster than
# every 128-column cell for all seven pipelines, at one frame and at four
# (PERF.md).
STRIP_W = 64           # output columns per CTA
SMEM_LIMIT = 232_448   # shared memory one H100 block may reserve (227 KB)
TARGET_CTAS = 2112     # sixteen CTAs for each of an H100's 132 SMs


def smem_rings(dag: PipelineDAG, alloc_buffers: Mapping | None,
               rows_per_step: int) -> dict[str, int]:
    """Shared-memory ring rows per producer for row-group execution.

    A consumer reading an (sh, sw) window needs its producer's last
    ``R + sh - 1`` rows live at once, so each ring holds that many rows
    over its consumers, or the plan's physical line count when that is
    larger (the ring is the plan's line buffer). Unlike the TPU rings
    there is no rounding: a CUDA thread writes any slot, so a ring may
    wrap mid-group.
    """
    if rows_per_step < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
    rings: dict[str, int] = {}
    for p in dag.topo_order:
        shs = [e.sh for e in dag.out_edges(p)
               if not dag.stages[e.consumer].is_output]
        if not shs:
            continue
        need = rows_per_step + max(shs) - 1
        if alloc_buffers and p in alloc_buffers:
            need = max(need, alloc_buffers[p].n_lines_phys)
        rings[p] = need
    return rings


@dataclasses.dataclass(frozen=True, eq=False)
class StencilProgram:
    """One pipeline at one frame shape, ready to launch.

    ``table`` / ``wts`` are the kernel's stage table and float32 constant
    table; ``grid_x`` column strips of ``strip_w`` by ``grid_y`` row bands
    of ``band_h`` make one frame's CTAs. ``smem_bytes`` is the dynamic
    shared memory each CTA reserves — the port's on-chip bill.
    """
    dag: PipelineDAG
    h: int
    w: int
    rows_per_step: int
    feeds: tuple[str, ...]
    table: np.ndarray
    wts: np.ndarray
    strip_w: int
    band_h: int
    grid_x: int
    grid_y: int
    smem_bytes: int


def _band_height(h: int, strips: int, frames: int, halo_up: int,
                 rows_per_step: int, target_ctas: int) -> int:
    """Rows per band: enough bands to give ~target_ctas CTAs per launch,
    but no band shorter than four top halos (recompute <= 25%)."""
    min_band = max(rows_per_step, 4 * halo_up, 16)
    want = -(-target_ctas // (strips * frames))
    n_bands = max(1, min(want, h // min_band))
    return -(-h // n_bands)


def build_program(dag: PipelineDAG, h: int, w: int, rows_per_step: int,
                  frames: int = 1,
                  alloc_buffers: Mapping | None = None, *,
                  strip_w: int = STRIP_W,
                  target_ctas: int = TARGET_CTAS) -> StencilProgram:
    """Resolve ``dag`` into the kernel's stage table for (h, w) frames.

    Operand order is resolved here, once: each payload maps its in-edges
    (window-key order) to its op's operands. ``frames`` is the batch the
    launch geometry is sized for; ``strip_w`` and ``target_ctas`` set
    that geometry (the defaults are what the executors use; other values
    serve the geometry sweep). Raises ValueError for a DAG the kernel
    cannot run (unknown payload, table overflow, shared memory over the
    block limit).
    """
    if h < 1 or w < 1:
        raise ValueError(f"frame shape must be positive, got ({h}, {w})")
    r = rows_per_step
    up, left = dag.cumulative_extent()
    strip_w = min(strip_w, w)
    ncols = strip_w + left
    rings = smem_rings(dag, alloc_buffers, r)
    ring_idx = {p: i for i, p in enumerate(rings)}
    feeds = tuple(dag.input_stages())
    out_stage = dag.output_stages()[0]
    final = dag.in_edges(out_stage)[0].producer
    stages = [n for n in dag.topo_order if not dag.stages[n].is_output]
    if len(stages) > MAX_STAGES or len(rings) > MAX_RINGS \
            or len(feeds) > MAX_FEEDS:
        raise ValueError(f"{dag.name}: {len(stages)} stages / {len(rings)} "
                         f"rings / {len(feeds)} inputs exceed the kernel's "
                         f"{MAX_STAGES} / {MAX_RINGS} / {MAX_FEEDS}")
    smem = sum(rings.values()) * ncols * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"{dag.name}: rings need {smem} bytes of shared "
                         f"memory at R={r}, over the {SMEM_LIMIT}-byte "
                         f"block limit")

    table = np.zeros(TABLE_INTS, np.int32)
    wts: list[float] = []
    for s, name in enumerate(stages):
        st = dag.stages[name]
        row = table[HDR + s * STAGE_INTS: HDR + (s + 1) * STAGE_INTS]
        row[S_RING] = ring_idx.get(name, -1)
        row[S_FINAL] = int(name == final)
        row[S_WOFF] = len(wts)
        ins = dag.in_edges(name)
        if st.is_input:
            row[S_OP] = OPS.index("input")
            row[S_FEED] = feeds.index(name)
            continue
        if st.fn is None:      # relay: identity on the producer's pixel
            op, srcs = "relay", [(ins[0].producer, 1, 1)]
        else:
            op, srcs = _payload_operands(dag.name, name, st.fn, ins, wts)
        row[S_OP] = OPS.index(op)
        row[S_NSRC] = len(srcs)
        for j, (p, sh, sw) in enumerate(srcs):
            row[S_SRC + j], row[S_SH + j], row[S_SW + j] = \
                ring_idx[p], sh, sw
    if len(wts) > MAX_WTS:
        raise ValueError(f"{dag.name}: {len(wts)} constants exceed the "
                         f"kernel's {MAX_WTS}")
    off = 0
    base = HDR + MAX_STAGES * STAGE_INTS
    for i, rows in enumerate(rings.values()):
        table[base + 2 * i: base + 2 * i + 2] = (off, rows)
        off += rows * ncols
    grid_x = -(-w // strip_w)
    band_h = _band_height(h, grid_x, frames, up, r, target_ctas)
    table[:H_SMEM_BYTES + 1] = (len(stages), r, h, w, strip_w, left, ncols,
                                band_h, up, smem)
    wt = np.zeros(MAX_WTS, np.float32)
    wt[:len(wts)] = wts
    return StencilProgram(dag=dag, h=h, w=w, rows_per_step=r, feeds=feeds,
                          table=table, wts=wt, strip_w=strip_w,
                          band_h=band_h, grid_x=grid_x,
                          grid_y=-(-h // band_h), smem_bytes=smem)


def _payload_operands(pipeline: str, name: str, fn, ins, wts: list
                      ) -> tuple[str, list[tuple[str, int, int]]]:
    """(op, [(producer, sh, sw)] in operand order) for a payload stage;
    appends the stage's weights and scalars to ``wts``."""
    where = f"{pipeline}/{name}"
    if not isinstance(fn, Payload) or fn.op not in _ARITY:
        raise ValueError(f"{where}: payload {fn!r} has no kernel op")
    if len(ins) > MAX_SRC:
        raise ValueError(f"{where}: {len(ins)} inputs exceed {MAX_SRC}")
    order = fn.operands(window_keys(ins), ins)
    srcs = [(ins[i].producer, ins[i].sh, ins[i].sw) for i in order]
    if len(srcs) != _ARITY[fn.op] or len(ins) != len(srcs):
        raise ValueError(f"{where}: {fn.op} reads {_ARITY[fn.op]} "
                         f"windows, the stage has {len(ins)}")
    if len(fn.consts) != _CONSTS.get(fn.op, 0):
        raise ValueError(f"{where}: {fn.op} takes {_CONSTS.get(fn.op, 0)} "
                         f"constants, got {len(fn.consts)}")
    _, sh, sw = srcs[0]
    if fn.op == "conv" and fn.weights.shape != (sh, sw):
        raise ValueError(f"{where}: {fn.weights.shape} weights on a "
                         f"{sh}x{sw} window")
    if fn.op == "xcorr" and fn.weights.shape != (sh, 1):
        raise ValueError(f"{where}: {fn.weights.shape} taps on a "
                         f"{sh}x{sw} window")
    if fn.op == "nms" and sw >= 2 and sh < 2:
        raise ValueError(f"{where}: nms centre [-2, -2] needs sh >= 2")
    if fn.weights is not None:
        wts.extend(float(v) for v in fn.weights.ravel())
    wts.extend(fn.consts)
    return fn.op, srcs


def _ops_per_pixel(op: str, sh: int, sw: int) -> int:
    """float32 operations per output pixel of one stage: a k-tap sum is
    k products and k - 1 sums; mag is two products, two sums and a root;
    nms is k - 1 maxima and a compare."""
    k = sh * sw
    return {"conv": 2 * k - 1, "xcorr": 2 * sh, "nms": k, "mag": 5,
            "denoise_comb": 7, "unsharp": 3, "harris_resp": 3,
            "square": 1, "prod": 1, "thresh": 1}.get(op, 0)


def launch_work(program: StencilProgram, frames: int) -> tuple[int, int]:
    """(bytes, float32 operations) a launch over ``frames`` frames needs
    at least: each input and output pixel moved once, each stage's
    arithmetic done once per pixel (no halo recompute)."""
    pixels = frames * program.h * program.w
    n_stages = int(program.table[H_NSTAGES])
    ops = 0
    for s in range(n_stages):
        row = program.table[HDR + s * STAGE_INTS:]
        ops += _ops_per_pixel(OPS[row[S_OP]], int(row[S_SH]),
                              int(row[S_SW]))
    return (len(program.feeds) + 1) * pixels * 4, ops * pixels


def stencil_pipeline_plain(dag: PipelineDAG,
                           feeds: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's plain PyTorch version: whole frames (any leading batch
    dims), stage by stage, through the same payloads. The row-group walk
    does not change the math, so it equals the kernel at every R."""
    return execute_reference(dag, feeds)[dag.output_stages()[0]]


def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_pipeline")
    fn = lib.stencil_pipeline_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stencil_pipeline_error_string.argtypes = [ctypes.c_int]
        lib.stencil_pipeline_error_string.restype = ctypes.c_char_p
        lib.stencil_pipeline_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.stencil_pipeline_error_string(rc).decode()
        raise RuntimeError(f"stencil_pipeline {what} failed: {msg}")


def blocks_per_sm(program: StencilProgram) -> int:
    """CTAs of the kernel resident on one SM at ``program``'s shared
    memory (the CUDA occupancy calculator; needs the card)."""
    lib = _lib()
    n = ctypes.c_int(0)
    _check(lib, lib.stencil_pipeline_blocks_per_sm(program.smem_bytes,
                                                   ctypes.byref(n)),
           "occupancy query")
    return n.value


class StencilPipelineKernel:
    """Wrapper of the fused stencil kernel.

    ``self(program, feeds)`` runs ``program`` over ``feeds`` — one
    (B, h, w) float32 contiguous tensor per input stage, all on one
    device — and returns the (B, h, w) output. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, and
    ``launches`` counts those launches.
    """
    name = "stencil_pipeline"

    def __init__(self):
        self.launches = 0

    def __call__(self, program: StencilProgram,
                 feeds: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(feeds) != len(program.feeds):
            raise ValueError(f"{program.dag.name} takes {len(program.feeds)}"
                             f" inputs {program.feeds}, got {len(feeds)}")
        devices = {t.device for t in feeds}
        if len(devices) != 1:
            raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
        dev = devices.pop()
        b = feeds[0].shape[0]
        want = (b, program.h, program.w)
        for t in feeds:
            if t.dtype != torch.float32:
                raise TypeError(f"inputs must be float32, got {t.dtype}")
            if tuple(t.shape) != want or b < 1:
                raise ValueError(f"inputs must be {want}, got "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError("inputs must be contiguous")
        if dev.type == "cpu":
            return stencil_pipeline_plain(program.dag,
                                          dict(zip(program.feeds, feeds)))
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if b > 65535:
            raise ValueError(f"batch {b} exceeds the grid's 65535 frames")
        lib = _lib()
        out = torch.empty(want, dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * MAX_FEEDS)(*[t.data_ptr() for t in feeds])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.stencil_pipeline_launch(
                program.table.ctypes.data, program.wts.ctypes.data, ptrs,
                out.data_ptr(), program.grid_x, program.grid_y, b, stream)
        _check(lib, rc, "launch")
        self.launches += 1
        return out


stencil_pipeline = StencilPipelineKernel()


def _resolve_rows(rows_per_step: int | None,
                  plan: PipelinePlan | None) -> int:
    if rows_per_step is not None:
        return rows_per_step
    return plan.rows_per_step if plan is not None else 1


def _resolve_depth(prefetch_depth: int | None,
                   plan: PipelinePlan | None) -> int:
    if prefetch_depth is not None:
        return prefetch_depth
    return plan.prefetch_depth if plan is not None else 1


@dataclasses.dataclass(frozen=True)
class StencilExecutor:
    """A compiled, reusable frame executor — the serving-side artifact.

    ``batch=None`` maps {input: (h, w)} -> (h, w); an integer batch maps
    {input: (B, h, w)} -> (B, h, w). Inputs may be numpy arrays or
    tensors; they are moved to ``device`` as float32, and the output
    stays there. ``smem_bytes`` is the shared memory each CTA of the
    kernel reserves.
    """
    dag: PipelineDAG
    h: int
    w: int
    batch: int | None
    rows_per_step: int
    prefetch_depth: int
    smem_bytes: int
    device: torch.device
    # the ImaGen plan this executor embodies (None for plan-less builds)
    plan: PipelinePlan | None = dataclasses.field(repr=False, default=None)
    program: StencilProgram = dataclasses.field(repr=False, kw_only=True)

    def _feed(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        want = (self.h, self.w) if self.batch is None \
            else (self.batch, self.h, self.w)
        if tuple(t.shape) != want:
            raise ValueError(f"{self.dag.name}: input of shape "
                             f"{tuple(t.shape)}, executor takes {want}")
        return t.reshape(-1, self.h, self.w).contiguous()

    def __call__(self, images: Mapping) -> torch.Tensor:
        with trace.span("executor.call", profile=True,
                        pipeline=self.dag.name, batch=self.batch,
                        rows_per_step=self.rows_per_step):
            feeds = [self._feed(images[n]) for n in self.program.feeds]
            out = stencil_pipeline(self.program, feeds)
            return out if self.batch is not None else out[0]

    @property
    def frame_shape(self) -> tuple[int, int]:
        return (self.h, self.w)


def make_executor(dag: PipelineDAG, h: int, w: int,
                  batch: int | None = None,
                  plan: PipelinePlan | None = None,
                  rows_per_step: int | None = None,
                  prefetch_depth: int | None = None,
                  device: str | torch.device = "cuda") -> StencilExecutor:
    """Executor factory: DAG + shape (+ optional plan) -> StencilExecutor.

    ``rows_per_step`` and ``prefetch_depth`` default to the plan's fields
    (1 when no plan). Runs on the GPU unless ``device="cpu"``.
    """
    if dag.is_temporal():
        raise ValueError(f"{dag.name} reads frame history; the video "
                         f"executor is not ported yet")
    r = _resolve_rows(rows_per_step, plan)
    d = _resolve_depth(prefetch_depth, plan)
    if d != 1:
        raise ValueError(f"prefetch_depth={d}: only depth 1 is ported")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = resolve_device(device)
    prog = build_program(dag, h, w, r, frames=batch or 1,
                         alloc_buffers=plan.alloc.buffers if plan else None)
    return StencilExecutor(dag=dag, h=h, w=w, batch=batch, rows_per_step=r,
                           prefetch_depth=d, smem_bytes=prog.smem_bytes,
                           device=dev, plan=plan, program=prog)
