"""Fused line-buffered stencil pipeline — the paper's accelerator on Hopper.

One CUDA kernel (``csrc/stencil_pipeline.cu``) executes the *entire*
pipeline DAG over a batch of frames: every stage computes its rows in
row groups of ``rows_per_step`` (R), reading its producers' rows from
shared-memory ring line buffers and writing its own ring, so only input
and output pixels touch device memory. One CTA owns one (frame, column
strip, row band) and recomputes the strip's and band's halo from real
input (see the source note there). Temporal pipelines add history taps
— pseudo-inputs with their own rings, read from the caller's frame-ring
state or from earlier frames of the same launch — and frame outputs for
internal temporal producers. At ``prefetch_depth`` d >= 2 every feed
(input or history tap) is copied asynchronously straight into its line
ring d - 1 row groups ahead of compute, the ring grown by (d - 1) * R
rows to hold them; the pixels are the same as at depth 1, bit for bit.

This module holds, beside the kernel:

  * :func:`build_program` — the per-plan stage table the kernel walks
    (op codes, rings, operand order, float32 constants), and the launch
    geometry and shared-memory bill. A stage whose function is a built-in
    :class:`~repro_torch.core.algorithms.Payload` takes its op code; any
    other torch window function is traced and lowered
    (:mod:`repro_torch.core.expr`) and written out as a CUDA function
    (:mod:`repro_torch.kernels.expr_codegen`) that the program's own
    library of the kernel holds (:func:`library`; :func:`prebuild`
    builds a DAG's libraries ahead of its first program);
  * :func:`stencil_pipeline_plain` and :func:`video_pipeline_plain` —
    the kernel's plain PyTorch versions: whole-frame, stage by stage,
    through the same payloads (an expression stage's plain version is
    the user's own function). The CPU tests use them, and
    ``chip_smoke.py`` holds the kernel against them;
  * :data:`stencil_pipeline` — the wrapper. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises;
  * :class:`StencilExecutor` / :func:`make_executor` (spatial frames)
    and :class:`VideoExecutor` / :func:`make_video_executor` (frame
    streams with explicit frame-ring state) — the serving-side
    artifacts over one shape.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch._device import h2d_span, resolve_device
from repro_torch.core.algorithms import (Payload, execute_reference,
                                        run_stages)
from repro_torch.core.codegen import (PipelinePlan, frame_outputs, tap_name,
                                      temporal_taps)
from repro_torch.core.dag import PipelineDAG, window_keys
from repro_torch.core.expr import StageExpr, lower_stage
from repro_torch.obs import trace

from . import _build, expr_codegen

# op codes, in the order of ``enum Op`` in csrc/stencil_pipeline.cu
OPS = ("input", "relay", "conv", "square", "identity", "mag", "prod",
       "nms", "thresh", "unsharp", "xcorr", "denoise_comb", "harris_resp",
       "tap", "stmean", "frame_diff", "bg_subtract", "expr")
# operands each payload op reads, and the float32 scalars it takes
_ARITY = {"conv": 1, "square": 1, "identity": 1, "mag": 2, "prod": 2,
          "nms": 1, "thresh": 1, "unsharp": 2, "xcorr": 2,
          "denoise_comb": 3, "harris_resp": 1, "stmean": 1,
          "frame_diff": 1, "bg_subtract": 2}
_CONSTS = {"mag": 1, "thresh": 1, "unsharp": 1, "harris_resp": 1,
           "stmean": 1, "bg_subtract": 1}
# ops whose operand is a temporal window; every other op reads st == 1
_TEMPORAL_OPS = ("stmean", "frame_diff")

# table layout, as in csrc/stencil_pipeline.cu
HDR, MAX_STAGES, STAGE_INTS, MAX_RINGS = 24, 24, 24, 24
MAX_WTS, MAX_FEEDS, MAX_OUTS, MAX_SRC = 256, 8, 4, 3
TABLE_INTS = HDR + MAX_STAGES * STAGE_INTS + MAX_RINGS * 2
(H_NSTAGES, H_R, H_H, H_W, H_STRIP_W, H_HALO_LEFT, H_NCOLS, H_BAND_H,
 H_HALO_UP, H_SMEM_BYTES, H_TEMPORAL, H_DEPTH, H_POISON, H_PAD, H_PITCH,
 H_OSTAGE, H_SLOTS, H_NRINGS, H_VEC, H_THREADS, H_OSYNC, H_EXPR) = range(22)
(S_OP, S_RING, S_FINAL, S_FEED, S_NSRC, S_WOFF, S_FOUT, S_STATE,
 S_TAPJ) = range(9)
S_SRC, S_ST, S_SH, S_SW, S_LEAD, S_KIND, S_SYNC = 9, 12, 15, 18, 21, 22, 23
# an expression stage's generated body (expr_codegen.stage_id), in a field
# only feeds use otherwise
S_XID = S_FEED

# stage bodies, in the order of ``enum Kind`` in csrc/stencil_pipeline.cu:
# a feed (input or history tap), a pointwise op on 1x1 operands, and the
# window shapes the registered pipelines use, unrolled; any other payload
# takes the generic body, a lowered stage function its generated body
KINDS = ("generic", "feed", "point", "conv1x5", "conv5x1", "conv1x3",
         "conv3x1", "conv3x3", "nms3x3", "xcorr18", "stmean4", "stmean8",
         "stmean333", "expr")
_POINT_OPS = ("relay", "identity", "square", "mag", "prod", "thresh",
              "unsharp", "denoise_comb", "harris_resp", "bg_subtract",
              "frame_diff")

# Launch geometry from tools/geometry_sweep.py at 1080p, R=8 (PERF.md).
STRIP_W = 240          # output columns per CTA
THREADS = 256          # threads per CTA at most (one per ring column)
SMEM_LIMIT = 232_448   # shared memory one H100 block may reserve (227 KB)
TARGET_CTAS = 1056     # CTAs a launch aims for
# CTAs per SM: an H100 SM holds 228 KB of shared memory and reserves 1 KB
# of it per CTA; registers cap CTAs of THREADS threads at 3 (THREADS and
# MIN_BLOCKS are the kernel's kThreads and kMinBlocks, its launch bounds)
SM_SMEM, SMEM_RESERVE, MIN_BLOCKS = 233_472, 1024, 3


def stage_kind(op: str, srcs: Sequence[tuple[str, int, int, int]]) -> str:
    """The kernel body that runs a stage of ``op`` over operand windows
    ``srcs`` [(producer, st, sh, sw)]: the expression body for a lowered
    stage function, an unrolled one for the shapes the registered
    pipelines use, else ``generic``."""
    if op == "expr":
        return "expr"
    shapes = [(t, sh, sw) for _, t, sh, sw in srcs]
    if op in _POINT_OPS and all(s[1:] == (1, 1) for s in shapes) and (
            op == "frame_diff" or all(s[0] == 1 for s in shapes)):
        return "point"
    one = shapes[0] if len(shapes) == 1 else None
    if op == "conv" and one and one[0] == 1:
        name = f"conv{one[1]}x{one[2]}"
        return name if name in KINDS else "generic"
    if op == "nms" and one == (1, 3, 3):
        return "nms3x3"
    if op == "xcorr" and shapes == [(1, 18, 1), (1, 1, 1)]:
        return "xcorr18"
    if op == "stmean" and one in ((4, 1, 1), (8, 1, 1)):
        return f"stmean{one[0]}"
    if op == "stmean" and one == (3, 3, 3):
        return "stmean333"
    return "generic"


def smem_rings(dag: PipelineDAG, alloc_buffers: Mapping | None,
               rows_per_step: int, prefetch_depth: int = 1
               ) -> dict[str, int]:
    """Shared-memory ring rows per producer for row-group execution.

    A consumer reading an (sh, sw) window needs its producer's last
    ``R + sh - 1`` rows live at once, so each ring holds that many rows
    over its consumers, or the plan's physical line count when that is
    larger (the ring is the plan's line buffer). Unlike the TPU rings
    there is no rounding: a CUDA thread writes any slot, so a ring may
    wrap mid-group. At ``prefetch_depth`` d >= 2 an input's ring also
    holds the d - 1 row groups copied ahead: max(d * R + sh - 1, the
    plan's lines) rows (the max, not the sum: the ring needs d * R + sh
    - 1 rows, and the plan's lines, where more, hold them), and an input
    that only the output reads gets a ring of d * R rows to land in.
    """
    if rows_per_step < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
    rings: dict[str, int] = {}
    for p in dag.topo_order:
        read = any(not dag.stages[e.consumer].is_output
                   for e in dag.out_edges(p))
        feed = dag.stages[p].is_input and prefetch_depth > 1
        if not read and not feed:
            continue
        need = (prefetch_depth if feed else 1) * rows_per_step \
            + _reach(dag, p) - 1
        if alloc_buffers and p in alloc_buffers:
            need = max(need, alloc_buffers[p].n_lines_phys)
        rings[p] = need
    return rings


def _reach(dag: PipelineDAG, p: str) -> int:
    """The tallest window (sh) that a stage other than the output reads
    from producer ``p``'s live ring; 1 when none does."""
    return max((e.sh for e in dag.out_edges(p)
                if not dag.stages[e.consumer].is_output), default=1)


def tap_reach(dag: PipelineDAG) -> dict[tuple[str, int], int]:
    """The tallest window (sh) that reads each temporal tap (producer, j
    frames back): the edges from the producer with st > j."""
    return {(p, j): max(e.sh for e in dag.out_edges(p) if e.st > j)
            for (p, j) in temporal_taps(dag)}


def smem_tap_rings(dag: PipelineDAG, rows_per_step: int,
                   prefetch_depth: int = 1) -> dict[tuple[str, int], int]:
    """Shared-memory ring rows per temporal tap (producer, j frames
    back): one read slab, ``R + sh - 1`` rows over the edges from the
    producer with st > j (no plan to grow from: history frames stream
    from device memory), and at ``prefetch_depth`` d >= 2 the d - 1 row
    groups copied ahead, ``d * R + sh - 1``."""
    return {tap: prefetch_depth * rows_per_step + sh - 1
            for tap, sh in tap_reach(dag).items()}


@dataclasses.dataclass(frozen=True, eq=False)
class StencilProgram:
    """One pipeline at one frame shape, ready to launch.

    ``table`` / ``wts`` are the kernel's stage table and float32 constant
    table; ``grid_x`` column strips of ``strip_w`` by ``grid_y`` row bands
    of ``band_h`` make one frame's CTAs. ``smem_bytes`` is the dynamic
    shared memory each CTA reserves — the port's on-chip bill.
    ``feeds`` are the input stages, ``states`` the temporal producers
    whose frame rings the launch reads, ``frame_outs`` the internal
    temporal producers whose frames it writes beside the output.
    ``prefetch_bytes`` is the part of ``smem_bytes`` that the feed rings'
    grown rows take at ``prefetch_depth`` >= 2 (0 at depth 1).
    ``rings`` names the table's rings in order: a producer's live ring,
    or ``(producer, j)`` for its history tap j frames back. ``exprs``
    holds each expression stage's lowered function, in table order, and
    ``source`` their generated CUDA fragment
    (:func:`~repro_torch.kernels.expr_codegen.expr_source`; "" for a
    payload program), which the program's own library is built from
    (:func:`library`).
    """
    dag: PipelineDAG
    h: int
    w: int
    rows_per_step: int
    feeds: tuple[str, ...]
    states: tuple[str, ...]
    frame_outs: tuple[str, ...]
    table: np.ndarray
    wts: np.ndarray
    strip_w: int
    band_h: int
    grid_x: int
    grid_y: int
    smem_bytes: int
    prefetch_depth: int = 1
    prefetch_bytes: int = 0
    rings: tuple = ()
    exprs: Mapping[str, StageExpr] = dataclasses.field(default_factory=dict)
    source: str = dataclasses.field(default="", repr=False)

    @functools.cached_property
    def library_spec(self) -> _build.Library:
        """The library that runs this program (:func:`library`): the
        shared one of the four payload instantiations, or, with an
        expression stage, its own."""
        return _library_spec(self.source, bool(self.table[H_TEMPORAL]),
                             self.prefetch_depth > 1)


def _resident(smem: int) -> int:
    """CTAs per SM that ``smem`` bytes of shared memory each allow, at
    most the MIN_BLOCKS that registers allow."""
    return min(SM_SMEM // (smem + SMEM_RESERVE), MIN_BLOCKS)


def _lead(rows: int, reach: int) -> int:
    """Rows of a feed ring that copies fill before any read at depth >=
    2: all but the reach - 1 slots standing for the rows above the band,
    which stay zero until the first row group has read them."""
    return rows - (reach - 1)


def _band_height(h: int, strips: int, frames: int, halo_up: int,
                 rows_per_step: int, target_ctas: int) -> int:
    """Rows per band: enough bands to give ~target_ctas CTAs per launch,
    but no band shorter than four top halos (recompute <= 25%), grown so
    that an inner band and its top halo fill whole row groups (no CTA
    computes rows past its band)."""
    min_band = max(rows_per_step, 4 * halo_up, 16)
    want = -(-target_ctas // (strips * frames))
    n_bands = max(1, min(want, h // min_band))
    band = -(-h // n_bands)
    if band < h:
        r = rows_per_step
        band = -(-(band + halo_up) // r) * r - halo_up
    return band


def _levels(dag: PipelineDAG, stages: Sequence) -> dict:
    """DAG level of each kernel stage: 0 for a feed (input or history
    tap), else one more than its deepest producer. Stages of one level
    read only rings of earlier levels, so they share one barrier."""
    level: dict = {}
    for n in stages:
        if isinstance(n, tuple) or dag.stages[n].is_input:
            level[n] = 0
        else:
            level[n] = 1 + max(level[e.producer] for e in dag.in_edges(n))
    return level


def build_program(dag: PipelineDAG, h: int, w: int, rows_per_step: int,
                  frames: int = 1,
                  alloc_buffers: Mapping | None = None, *,
                  strip_w: int | None = None,
                  target_ctas: int = TARGET_CTAS,
                  threads: int = THREADS,
                  prefetch_depth: int = 1,
                  poison_prefetch: bool = False) -> StencilProgram:
    """Resolve ``dag`` into the kernel's stage table for (h, w) frames.

    Operand order is resolved here, once: each payload maps its in-edges
    (window-key order) to its op's operands; a stage function that is no
    payload is lowered (:func:`repro_torch.core.expr.lower_stage`) over
    its in-edges in window-key order, its row names its generated body
    (``S_XID``), its constants join the constant table, and the
    program's ``source`` holds the bodies. A temporal DAG gets one tap
    stage per (producer, j frames back) ahead of the other stages, and
    each producer's rings are laid out oldest tap first, live ring last,
    so an operand's (first ring, st) spans its time window. Stages are
    ordered by DAG level, and only the last stage of a level ends in a
    block barrier. Each stage names the kernel body that runs it
    (:func:`stage_kind`). ``frames`` is the batch the launch geometry is
    sized for; ``strip_w``, ``target_ctas`` and ``threads`` (threads per
    CTA at most) set that geometry (the defaults are what the executors
    use; other values serve the geometry sweep). With no ``strip_w`` the
    strip is ``STRIP_W`` columns, halved until the shared memory fits
    the block limit and, at depth >= 2, until it allows as many CTAs per
    SM as the depth-1 bill at the first strip does (so a deep program
    with grown rings keeps depth 1's occupancy).

    A CTA computes ``ncols`` columns: its strip and the left halo, the
    halo rounded up to 4 columns where the frame allows 16-byte vectors
    (w % 4 == 0 and strip_w % 4 == 0), the whole rounded up to a warp.
    Each ring row holds ``pad`` zero columns (the widest window's sw - 1,
    rounded up to 4) left of them, so the frame's left edge reads zero
    with no test. Beside the rings the CTA keeps R rows of the output
    stage and the rings' row table.

    At ``prefetch_depth`` d >= 2 the feeds (each input and each history
    tap) are copied d - 1 row groups ahead straight into their line
    rings, which grow to max(d * R + sh - 1, the plan's lines) rows
    (:func:`smem_rings`, :func:`smem_tap_rings`); the other rings keep
    their rows. So the bill is the depth-1 bill at the same strip plus
    (d - 1) * R * pitch * 4 bytes per feed ring where the plan's lines
    do not already cover the rows (``prefetch_bytes``). Outputs are
    stored from shared memory, so unlike ``codegen.prefetch_ring_bytes``
    (the TPU's VMEM arithmetic: input and output rings, lanes padded to
    128) the bill has no output rings. ``poison_prefetch`` makes the
    kernel fill with NaN every feed-ring slot a copy writes before any
    read (all but the zero tail that stands for the rows above the band),
    so a read that overtakes its copy shows.
    Raises ValueError for a DAG the kernel cannot run (a payload with no
    kernel op, a stage function that does not lower, table overflow,
    shared memory over the block limit) and for a depth below 1.
    """
    if h < 1 or w < 1:
        raise ValueError(f"frame shape must be positive, got ({h}, {w})")
    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1, got "
                         f"{prefetch_depth}")
    if not 32 <= threads <= THREADS or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{THREADS}], got {threads}")
    r = rows_per_step
    up, left0 = dag.cumulative_extent()
    depths = dag.temporal_depths()

    def rings_at(depth: int) -> tuple[list[int], dict]:
        live = smem_rings(dag, alloc_buffers, r, depth)
        taps = smem_tap_rings(dag, r, depth)
        rows: list[int] = []
        idx: dict = {}
        for p, n in live.items():
            for j in range(depths.get(p, 1) - 1, 0, -1):
                idx[(p, j)] = len(rows)
                rows.append(taps[(p, j)])
            idx[p] = len(rows)
            rows.append(n)
        return rows, idx
    ring_rows, ring_idx = rings_at(prefetch_depth)
    tap_sh = tap_reach(dag)
    rows_depth1 = sum(rings_at(1)[0])
    feeds = tuple(dag.input_stages())
    states = tuple(p for p in dag.topo_order if p in depths)
    fouts = tuple(frame_outputs(dag))
    out_stage = dag.output_stages()[0]
    final = dag.in_edges(out_stage)[0].producer
    stages = list(temporal_taps(dag)) \
        + [n for n in dag.topo_order if not dag.stages[n].is_output]
    level = _levels(dag, stages)
    stages.sort(key=level.__getitem__)
    n_feeds = len(feeds) + len(states)
    if len(stages) > MAX_STAGES or len(ring_rows) > MAX_RINGS \
            or n_feeds > MAX_FEEDS or 1 + len(fouts) > MAX_OUTS:
        raise ValueError(f"{dag.name}: {len(stages)} stages / "
                         f"{len(ring_rows)} rings / {n_feeds} feeds / "
                         f"{1 + len(fouts)} outputs exceed the kernel's "
                         f"{MAX_STAGES} / {MAX_RINGS} / {MAX_FEEDS} / "
                         f"{MAX_OUTS}")
    sw_max = max((e.sw for e in dag.edges), default=1)
    pad = -(-(sw_max - 1) // 4) * 4
    narrow = strip_w is None
    strip_w = STRIP_W if narrow else strip_w
    want = None
    while True:
        strip_w = min(strip_w, w)
        vec = w % 4 == 0 and strip_w % 4 == 0
        left = -(-left0 // 4) * 4 if vec else left0
        ncols = -(-(strip_w + left) // 32) * 32
        pitch = pad + ncols
        rings_floats = sum(ring_rows) * pitch
        # the output stage's R rows, then two row tables of MAX_RINGS ints
        slots = rings_floats + r * ncols
        smem = (slots + 2 * MAX_RINGS) * 4
        grown = (sum(ring_rows) - rows_depth1) * pitch * 4
        if want is None:
            want = _resident(smem - grown)
        if not narrow or strip_w <= 32 or (
                smem <= SMEM_LIMIT and _resident(smem) >= want):
            break
        strip_w = max(strip_w // 8 * 4, 32)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{dag.name}: rings need {smem} bytes of shared "
                         f"memory at R={r}, depth {prefetch_depth}, over "
                         f"the {SMEM_LIMIT}-byte block limit")

    table = np.zeros(TABLE_INTS, np.int32)
    wts: list[float] = []
    exprs: dict[str, StageExpr] = {}
    for s, name in enumerate(stages):
        row = table[HDR + s * STAGE_INTS: HDR + (s + 1) * STAGE_INTS]
        row[S_RING] = ring_idx.get(name, -1)
        row[S_FOUT] = 1 + fouts.index(name) if name in fouts else -1
        row[S_WOFF] = len(wts)
        row[S_KIND] = KINDS.index("feed")
        # the last stage of a level ends in a barrier
        row[S_SYNC] = int(s + 1 == len(stages)
                          or level[stages[s + 1]] > level[name])
        if isinstance(name, tuple):         # history tap (producer, j)
            p, j = name
            row[S_OP] = OPS.index("tap")
            row[S_STATE] = len(feeds) + states.index(p)
            # an internal producer's taps run one frame a launch, so they
            # always read the state; any valid feed index serves
            row[S_FEED] = feeds.index(p) if p in feeds else row[S_STATE]
            row[S_TAPJ] = j
            if prefetch_depth > 1:
                row[S_LEAD] = _lead(ring_rows[row[S_RING]], tap_sh[name])
            continue
        st = dag.stages[name]
        row[S_FINAL] = int(name == final)
        ins = dag.in_edges(name)
        if st.is_input:
            row[S_OP] = OPS.index("input")
            row[S_FEED] = feeds.index(name)
            if prefetch_depth > 1:
                row[S_LEAD] = _lead(ring_rows[row[S_RING]],
                                    _reach(dag, name))
            continue
        if st.fn is None:      # relay: identity on the producer's pixel
            op, srcs = "relay", [(ins[0].producer, 1, 1, 1)]
        elif isinstance(st.fn, Payload):
            op, srcs = _payload_operands(dag.name, name, st.fn, ins, wts)
        else:                  # a torch window function, lowered
            ex = exprs[name] = lower_stage(dag.name, name, st.fn, ins)
            op, srcs = "expr", list(ex.operands)
            row[S_XID] = expr_codegen.stage_id(ex)
            wts.extend(ex.consts)
        row[S_OP] = OPS.index(op)
        row[S_KIND] = KINDS.index(stage_kind(op, srcs))
        row[S_NSRC] = len(srcs)
        for j, (p, t, sh, sw) in enumerate(srcs):
            # time index dt reads ring first + dt; st - 1 is p's live ring
            row[S_SRC + j] = ring_idx[p] - (t - 1)
            row[S_ST + j], row[S_SH + j], row[S_SW + j] = t, sh, sw
    if len(wts) > MAX_WTS:
        raise ValueError(f"{dag.name}: {len(wts)} constants exceed the "
                         f"kernel's {MAX_WTS}")
    off = 0
    base = HDR + MAX_STAGES * STAGE_INTS
    for i, rows in enumerate(ring_rows):
        table[base + 2 * i: base + 2 * i + 2] = (off, rows)
        off += rows * pitch
    grid_x = -(-w // strip_w)
    band_h = _band_height(h, grid_x, frames, up, r, target_ctas)
    # temporal programs launch the kernel's temporal instantiation,
    # depth >= 2 its prefetch one, and a program with an expression stage
    # launches from its own library; the launch clears H_VEC when a
    # tensor is not 16-byte aligned. A final stage of level 0 (an input
    # wired to the output) writes the output rows before the first
    # barrier, so their store ends in one of its own (H_OSYNC).
    table[:H_EXPR + 1] = (
        len(stages), r, h, w, strip_w, left, ncols, band_h, up, smem,
        int(bool(states)), prefetch_depth, int(poison_prefetch),
        pad, pitch, rings_floats, slots, len(ring_rows), int(vec),
        min(threads, ncols), int(level[final] == 0), int(bool(exprs)))
    wt = np.zeros(MAX_WTS, np.float32)
    wt[:len(wts)] = wts
    return StencilProgram(dag=dag, h=h, w=w, rows_per_step=r, feeds=feeds,
                          states=states, frame_outs=fouts,
                          table=table, wts=wt, strip_w=strip_w,
                          band_h=band_h, grid_x=grid_x,
                          grid_y=-(-h // band_h), smem_bytes=smem,
                          prefetch_depth=prefetch_depth,
                          prefetch_bytes=grown,
                          rings=tuple(sorted(ring_idx, key=ring_idx.get)),
                          exprs=exprs,
                          source=expr_codegen.expr_source(exprs.values())
                          if exprs else "")


def _payload_operands(pipeline: str, name: str, fn, ins, wts: list
                      ) -> tuple[str, list[tuple[str, int, int, int]]]:
    """(op, [(producer, st, sh, sw)] in operand order) for a payload
    stage; appends the stage's weights and scalars to ``wts``."""
    where = f"{pipeline}/{name}"
    if fn.op not in _ARITY:
        raise ValueError(f"{where}: payload {fn!r} has no kernel op")
    if len(ins) > MAX_SRC:
        raise ValueError(f"{where}: {len(ins)} inputs exceed {MAX_SRC}")
    order = fn.operands(window_keys(ins), ins)
    srcs = [(ins[i].producer, ins[i].st, ins[i].sh, ins[i].sw)
            for i in order]
    if len(srcs) != _ARITY[fn.op] or len(ins) != len(srcs):
        raise ValueError(f"{where}: {fn.op} reads {_ARITY[fn.op]} "
                         f"windows, the stage has {len(ins)}")
    if len(fn.consts) != _CONSTS.get(fn.op, 0):
        raise ValueError(f"{where}: {fn.op} takes {_CONSTS.get(fn.op, 0)} "
                         f"constants, got {len(fn.consts)}")
    _, st, sh, sw = srcs[0]
    if fn.op not in _TEMPORAL_OPS and any(t > 1 for _, t, _, _ in srcs):
        raise ValueError(f"{where}: {fn.op} takes no temporal window")
    if fn.op == "frame_diff" and st < 2:
        raise ValueError(f"{where}: frame_diff needs st >= 2, got {st}")
    if fn.op == "stmean" and \
            fn.consts[0] != float(np.float32(1.0 / (st * sh * sw))):
        raise ValueError(f"{where}: stmean scale {fn.consts[0]} on a "
                         f"{st}x{sh}x{sw} window")
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


def _ops_per_pixel(op: str, st: int, sh: int, sw: int) -> int:
    """float32 operations per output pixel of one stage: a k-tap sum is
    k products and k - 1 sums; mag is two products, two sums and a root;
    nms is k - 1 maxima and a compare; a k-cell mean k - 1 sums and a
    product."""
    k = sh * sw
    return {"conv": 2 * k - 1, "xcorr": 2 * sh, "nms": k, "mag": 5,
            "denoise_comb": 7, "unsharp": 3, "harris_resp": 3,
            "square": 1, "prod": 1, "thresh": 1, "stmean": st * k,
            "frame_diff": 2, "bg_subtract": 3}.get(op, 0)


def launch_work(program: StencilProgram, frames: int) -> tuple[int, int]:
    """(bytes, float32 operations) a launch over ``frames`` frames needs
    at least: each input, output and frame-output pixel moved once, each
    history frame of the state read once, each stage's arithmetic done
    once per pixel (no halo recompute; an expression stage's operations
    are its lowered function's)."""
    hw = program.h * program.w
    n_stages = int(program.table[H_NSTAGES])
    ops = sum(ex.ops for ex in program.exprs.values())
    for s in range(n_stages):
        row = program.table[HDR + s * STAGE_INTS:]
        ops += _ops_per_pixel(OPS[row[S_OP]], int(row[S_ST]),
                              int(row[S_SH]), int(row[S_SW]))
    depths = program.dag.temporal_depths()
    history = sum(depths[p] - 1 for p in program.states)
    moved = (len(program.feeds) + 1 + len(program.frame_outs)) * frames \
        + history
    return moved * hw * 4, ops * frames * hw


def launch_traffic(program: StencilProgram, frames: int) -> int:
    """Bytes a launch over ``frames`` frames loads and stores as its
    geometry dictates. Each CTA loads, per feed stage (an input, or a
    history tap of its frame), the rows from its band's top halo to the
    end of its last row group and its ``ncols`` columns from the strip's
    left halo on, clipped to the frame; it stores its strip of its band
    of the output and of each frame output. A one-strip, one-band
    spatial program moves :func:`launch_work`'s bytes; more strips or
    bands add their halos, and a temporal launch reads every history
    tap of every frame (the L2 may serve repeated reads)."""
    t = program.table
    h, w, r = program.h, program.w, program.rows_per_step
    strip, left, ncols = int(t[H_STRIP_W]), int(t[H_HALO_LEFT]), \
        int(t[H_NCOLS])
    band, up = int(t[H_BAND_H]), int(t[H_HALO_UP])
    cols = 0
    for x in range(program.grid_x):
        cbase = x * strip - left
        cols += min(cbase + ncols, w) - max(cbase, 0)
    rows = 0
    for y in range(program.grid_y):
        y0 = y * band
        rlo = max(y0 - up, 0)
        steps = -(-(min(y0 + band, h) - rlo) // r)
        rows += min(rlo + steps * r, h) - rlo
    feed = KINDS.index("feed")
    n_feeds = sum(int(t[HDR + s * STAGE_INTS + S_KIND]) == feed
                  for s in range(int(t[H_NSTAGES])))
    stores = (1 + len(program.frame_outs)) * h * w
    return 4 * frames * (n_feeds * cols * rows + stores)


def stencil_pipeline_plain(dag: PipelineDAG,
                           feeds: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's plain PyTorch version: whole frames (any leading batch
    dims), stage by stage, through the same payloads. The row-group walk
    does not change the math, so it equals the kernel at every R."""
    return execute_reference(dag, feeds)[dag.output_stages()[0]]


def video_pipeline_plain(dag: PipelineDAG, feeds: Mapping
                         ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The kernel's plain PyTorch version for any DAG, temporal ones
    included: ``feeds`` holds each input stage and each history tap
    (keyed ``codegen.tap_name(p, j)``) as (B, h, w) frames, frame b's tap
    j being producer p's frame j steps before frame b. Returns the
    output and {internal temporal producer: its frames}."""
    vals = run_stages(dag, feeds, lambda p, j: torch.as_tensor(
        feeds[tap_name(p, j)], dtype=torch.float32))
    return (vals[dag.output_stages()[0]],
            {p: vals[p] for p in frame_outputs(dag)})


def tap_feeds(dag: PipelineDAG, inputs: Mapping[str, torch.Tensor],
              state: Mapping[str, torch.Tensor], frames: int
              ) -> dict[str, torch.Tensor]:
    """History taps of a launch over ``frames`` consecutive frames, as
    the plain version reads them: tap j of frame b is input frame b - j
    when b >= j, else slot j - b - 1 of the producer's frame-ring state
    (newest first). Built by concatenation — one copy per tap; the
    kernel reads the same frames in place."""
    taps = {}
    for (p, j) in temporal_taps(dag):
        parts = [state[p][:j].flip(0)]
        if p in inputs:
            parts.append(inputs[p])
        taps[tap_name(p, j)] = torch.cat(parts)[:frames]
    return taps


def _library_spec(source: str, temporal: bool, prefetch: bool
                  ) -> _build.Library:
    if not source:
        return _build.kernel_library("stencil_pipeline")
    return _build.expr_library(source, temporal, prefetch)


def library(program: StencilProgram) -> ctypes.CDLL:
    """The loaded library that runs ``program`` (``program.library_spec``),
    built first if missing: the shared library of the four payload
    instantiations, or, for a program with an expression stage, its own
    (``csrc/`` plus its generated ``source``, the one instantiation it
    launches). Raises with nvcc's output if the build fails."""
    lib = _build.load_library(program.library_spec)
    fn = lib.stencil_pipeline_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stencil_pipeline_error_string.argtypes = [ctypes.c_int]
        lib.stencil_pipeline_error_string.restype = ctypes.c_char_p
        lib.stencil_pipeline_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.stencil_pipeline_attributes.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def build_libraries(programs: Sequence[StencilProgram]) -> dict[str, float]:
    """Build, in one parallel wave, every missing library that
    ``programs`` launch from. Returns {library name: nvcc seconds} of the
    libraries built here. Raises with nvcc's output on a failure."""
    return _build.build_all(p.library_spec for p in programs)


def dag_libraries(dag: PipelineDAG) -> list[_build.Library]:
    """The libraries that ``dag``'s programs launch from, at any shape,
    batch and depth: the shared one, or, when a stage lowers to an
    expression, the program's own at depth 1 and at prefetch depth.
    Raises ValueError for a stage that does not lower."""
    exprs = [lower_stage(dag.name, n, st.fn, dag.in_edges(n))
             for n, st in dag.stages.items()
             if not (st.is_input or st.is_output or st.fn is None
                     or isinstance(st.fn, Payload))]
    source = expr_codegen.expr_source(exprs) if exprs else ""
    temporal = bool(dag.temporal_depths())
    return [_library_spec(source, temporal, prefetch)
            for prefetch in ((False, True) if source else (False,))]


def prebuild(dag: PipelineDAG) -> dict[str, float]:
    """Build, in one wave, the missing libraries of
    :func:`dag_libraries`, so that a pipeline's first frame finds them on
    disk. Returns {library name: nvcc seconds}. Raises nothing: a stage
    that does not lower, or a library that fails to build, raises where
    its program is built or its library loaded (:func:`build_program`,
    :func:`library`), without running nvcc again."""
    try:
        libs = dag_libraries(dag)
    except ValueError:
        return {}
    return _build.build_all(libs, check=False)


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.stencil_pipeline_error_string(rc).decode()
        raise RuntimeError(f"stencil_pipeline {what} failed: {msg}")


def blocks_per_sm(program: StencilProgram) -> int:
    """CTAs of the kernel resident on one SM at ``program``'s threads
    and shared memory (the CUDA occupancy calculator; needs the card)."""
    lib = library(program)
    n = ctypes.c_int(0)
    temporal = int(program.table[H_TEMPORAL])
    prefetch = int(program.prefetch_depth > 1)
    _check(lib, lib.stencil_pipeline_blocks_per_sm(
        program.smem_bytes, temporal, prefetch, int(program.table[H_EXPR]),
        int(program.table[H_THREADS]), ctypes.byref(n)),
        "occupancy query")
    return n.value


def kernel_attributes(program: StencilProgram) -> dict[str, int]:
    """{"registers": a thread's, "local_bytes": a thread's local memory}
    of the instantiation that runs ``program``, read from the loaded
    library (``cudaFuncGetAttributes``; needs the card). ptxas spills to
    local memory, so 0 local bytes means no spills."""
    lib = library(program)
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.stencil_pipeline_attributes(
        int(program.table[H_TEMPORAL]), int(program.prefetch_depth > 1),
        int(program.table[H_EXPR]), ctypes.byref(regs),
        ctypes.byref(local)), "attribute query")
    return {"registers": regs.value, "local_bytes": local.value}


class StencilPipelineKernel:
    """Wrapper of the fused stencil kernel.

    ``self(program, feeds, states)`` runs ``program`` over ``feeds`` —
    one (B, h, w) float32 contiguous tensor per input stage — and
    ``states`` — one (d-1, h, w) frame ring per temporal producer
    (``program.states``, newest frame first), all on one device. It
    returns the (B, h, w) output, or ``(output, {producer: (B, h, w)})``
    when the program has frame outputs (internal temporal producers;
    then B must be 1). CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream, and ``launches`` counts
    those launches; ``prefetch_launches`` counts those at prefetch depth
    >= 2 (the prefetch instantiations) among them, and
    ``temporal_launches`` those of programs with frame rings at depth 1
    (the temporal instantiation); the rest launched the spatial one.
    ``expr_launches`` counts, across all of them, the launches of
    programs with an expression stage (each from its own library, built
    at the program's first use: :func:`library`).
    """
    name = "stencil_pipeline"

    def __init__(self):
        self.launches = 0
        self.prefetch_launches = 0
        self.temporal_launches = 0
        self.expr_launches = 0

    def __call__(self, program: StencilProgram,
                 feeds: Sequence[torch.Tensor],
                 states: Sequence[torch.Tensor] = ()):
        dag = program.dag
        if len(feeds) != len(program.feeds) or \
                len(states) != len(program.states):
            raise ValueError(f"{dag.name} takes {len(program.feeds)} "
                             f"inputs {program.feeds} and "
                             f"{len(program.states)} states "
                             f"{program.states}, got {len(feeds)} and "
                             f"{len(states)}")
        devices = {t.device for t in (*feeds, *states)}
        if len(devices) != 1:
            raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
        dev = devices.pop()
        b = feeds[0].shape[0]
        depths = dag.temporal_depths()
        wants = [(b, program.h, program.w)] * len(feeds) + [
            (depths[p] - 1, program.h, program.w) for p in program.states]
        for t, want in zip((*feeds, *states), wants):
            if t.dtype != torch.float32:
                raise TypeError(f"inputs must be float32, got {t.dtype}")
            if tuple(t.shape) != want or b < 1:
                raise ValueError(f"inputs must be {want}, got "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError("inputs must be contiguous")
        if program.frame_outs and b != 1:
            raise ValueError(
                f"{dag.name}: a launch over {b} frames needs input-only "
                f"temporal taps, but {list(program.frame_outs)} are "
                f"internal temporal producers (frame t would need frame "
                f"t-1 from the same launch)")
        if dev.type == "cpu":
            inputs = dict(zip(program.feeds, feeds))
            out, frames = video_pipeline_plain(dag, {
                **inputs, **tap_feeds(dag, inputs,
                                      dict(zip(program.states, states)), b)})
            return (out, frames) if program.frame_outs else out
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if b > 65535:
            raise ValueError(f"batch {b} exceeds the grid's 65535 frames")
        lib = library(program)
        outs = [torch.empty((b, program.h, program.w), dtype=torch.float32,
                            device=dev)
                for _ in range(1 + len(program.frame_outs))]
        fptrs = (ctypes.c_void_p * MAX_FEEDS)(
            *[t.data_ptr() for t in (*feeds, *states)])
        optrs = (ctypes.c_void_p * MAX_OUTS)(*[t.data_ptr() for t in outs])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.stencil_pipeline_launch(
                program.table.ctypes.data, program.wts.ctypes.data,
                fptrs, optrs, program.grid_x, program.grid_y, b, stream)
        _check(lib, rc, "launch")
        self.launches += 1
        self.prefetch_launches += program.prefetch_depth > 1
        self.temporal_launches += bool(program.states) and \
            program.prefetch_depth == 1
        self.expr_launches += bool(program.exprs)
        if program.frame_outs:
            return outs[0], dict(zip(program.frame_outs, outs[1:]))
        return outs[0]


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
        names = self.program.feeds
        with h2d_span("executor.call", (images[n] for n in names),
                      self.device, pipeline=self.dag.name, batch=self.batch,
                      rows_per_step=self.rows_per_step):
            feeds = [self._feed(images[n]) for n in names]
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
    (1 when no plan). Runs on the GPU unless ``device="cpu"``; on the
    GPU the kernel's library is loaded here, and a program with an
    expression stage builds its own first if nothing built it before
    (nvcc, seconds: part of the caller's compile time, never of a frame;
    ``PlanCache`` builds it earlier, at admission, with :func:`prebuild`).
    """
    if dag.is_temporal():
        raise ValueError(f"{dag.name} reads frame history; build it with "
                         f"make_video_executor")
    r = _resolve_rows(rows_per_step, plan)
    d = _resolve_depth(prefetch_depth, plan)
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = resolve_device(device)
    prog = build_program(dag, h, w, r, frames=batch or 1,
                         alloc_buffers=plan.alloc.buffers if plan else None,
                         prefetch_depth=d)
    if dev.type == "cuda":
        library(prog)
    return StencilExecutor(dag=dag, h=h, w=w, batch=batch, rows_per_step=r,
                           prefetch_depth=d, smem_bytes=prog.smem_bytes,
                           device=dev, plan=plan, program=prog)


def init_frame_state(depths: Mapping[str, int], h: int, w: int,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """Zero frame rings for a fresh stream: one (d-1, h, w) float32 ring
    per temporal producer, newest frame first along axis 0, on
    ``device``. The single definition of the state layout (the JAX
    package's, so states compare one to one)."""
    dev = resolve_device(device)
    return {p: torch.zeros((d - 1, h, w), dtype=torch.float32, device=dev)
            for p, d in depths.items()}


@dataclasses.dataclass(frozen=True)
class VideoExecutor:
    """A frame-stream executor — stateless across streams.

    The temporal analogue of :class:`StencilExecutor`: one stage table
    serves every stream of the pipeline; all per-stream state — the frame
    rings holding each temporal producer's last ``d-1`` frames — is an
    explicit argument and result of ``__call__``, so N concurrent streams
    multiplex over ONE executor without cross-talk.

    ``chunk=None`` advances one frame per call ({input: (h, w)} ->
    (h, w)); ``chunk=B`` advances B *consecutive* frames of one stream
    per call ({input: (B, h, w)} -> (B, h, w)) in one launch — frame b's
    history taps are read from earlier frames of the chunk itself, which
    is why chunking requires input-only temporal taps (enforced at
    construction).

    ``__call__`` never mutates the ``state`` it is given: it returns a
    new state, so a caller commits state only on success. The roll
    copies each producer's d-1 frames once (``state_roll_bytes`` read and
    written per call).
    """
    dag: PipelineDAG
    h: int
    w: int
    chunk: int | None
    rows_per_step: int
    prefetch_depth: int
    smem_bytes: int                 # shared memory per CTA (rings)
    frame_state_bytes: int          # device-resident frame-ring state
    device: torch.device
    depths: dict = dataclasses.field(repr=False)   # producer -> frames
    plan: PipelinePlan | None = dataclasses.field(repr=False, default=None)
    program: StencilProgram = dataclasses.field(repr=False, kw_only=True)

    def init_state(self) -> dict[str, torch.Tensor]:
        """Zero frame rings — the stream-start (warm-up) state. Frames
        read from the zero region reproduce the reference's causal zero
        padding along time."""
        return init_frame_state(self.depths, self.h, self.w, self.device)

    def _feed(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        want = (self.h, self.w) if self.chunk is None \
            else (self.chunk, self.h, self.w)
        if tuple(t.shape) != want:
            raise ValueError(f"{self.dag.name}: input of shape "
                             f"{tuple(t.shape)}, executor takes {want}")
        return t.reshape(-1, self.h, self.w).contiguous()

    def __call__(self, images: Mapping, state: Mapping
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        prog = self.program
        with h2d_span("executor.call", (images[n] for n in prog.feeds),
                      self.device, pipeline=self.dag.name, chunk=self.chunk,
                      rows_per_step=self.rows_per_step):
            ins = {n: self._feed(images[n]) for n in prog.feeds}
            rings = {p: torch.as_tensor(state[p], dtype=torch.float32,
                                        device=self.device).contiguous()
                     for p in prog.states}
            res = stencil_pipeline(prog, [ins[n] for n in prog.feeds],
                                   [rings[p] for p in prog.states])
            out, frames = res if prog.frame_outs else (res, {})
            new_state = {}
            with trace.span("executor.roll", pipeline=self.dag.name) as sp:
                for p, d in self.depths.items():
                    # newest first: the launch's frames, last one first,
                    # then the oldest state frames that still fit
                    cur = ins[p] if p in ins else frames[p]
                    n = min(cur.shape[0], d - 1)
                    new_state[p] = torch.cat(
                        [cur[cur.shape[0] - 1 - i][None] for i in range(n)]
                        + [rings[p][:d - 1 - n]])
                if sp is not trace.NULL_SPAN:
                    # each frame the cat writes it also reads once
                    sp.set(roll_bytes=sum(2 * t.numel() * t.element_size()
                                          for t in new_state.values()))
            return (out if self.chunk is not None else out[0]), new_state

    @property
    def state_roll_bytes(self) -> int:
        """Device bytes the state roll reads and writes per call."""
        return 2 * self.frame_state_bytes

    @property
    def warmup_frames(self) -> int:
        """Frames before the output stops depending on the zero history."""
        return self.dag.cumulative_extent(temporal=True)[0]


def make_video_executor(dag: PipelineDAG, h: int, w: int,
                        plan: PipelinePlan | None = None,
                        rows_per_step: int | None = None,
                        chunk: int | None = None,
                        prefetch_depth: int | None = None,
                        device: str | torch.device = "cuda"
                        ) -> VideoExecutor:
    """Build a streaming executor for a (possibly temporal) pipeline.

    History taps are read from the caller's state (single-frame mode) or
    from earlier frames of the chunk and the state (chunk mode), and the
    returned state rolls the newest frames in. A DAG with no temporal
    edges degenerates to the plain executor with empty state. Runs on
    the GPU unless ``device="cpu"``; on the GPU the kernel's library is
    loaded (and built) here as in :func:`make_executor`.
    """
    r = _resolve_rows(rows_per_step, plan)
    d = _resolve_depth(prefetch_depth, plan)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    internal = frame_outputs(dag)
    if chunk is not None and internal:
        raise ValueError(
            f"{dag.name}: chunked execution needs input-only temporal "
            f"taps, but {internal} are internal temporal producers (frame "
            f"t would need frame t-1 from the same launch)")
    dev = resolve_device(device)
    depths = dag.temporal_depths()
    prog = build_program(dag, h, w, r, frames=chunk or 1,
                         alloc_buffers=plan.alloc.buffers if plan else None,
                         prefetch_depth=d)
    if dev.type == "cuda":
        library(prog)
    state_bytes = plan.vmem_frame_bytes(h) if plan is not None \
        else sum((k - 1) * h * w * 4 for k in depths.values())
    return VideoExecutor(dag=dag, h=h, w=w, chunk=chunk, rows_per_step=r,
                         prefetch_depth=d, smem_bytes=prog.smem_bytes,
                         frame_state_bytes=state_bytes, device=dev,
                         depths=dict(depths), plan=plan, program=prog)
