"""Prior-work baselines (paper Sec. 3, Tbl. 1, Sec. 7 "Baselines").

* Darkroom [16]: dual-port SRAM, multi-consumer pipelines *linearized* by
  inserting relay ("dummy") stages so every producer effectively has a
  single consumer pattern. Relays read in exactly the same pattern as the
  consumer they shadow and are therefore tied to its start cycle (Fig. 3).
* SODA [7]: FIFO-based line buffers (dual-port blocks). Multi-consumer
  stages split FIFOs at tap points. The partial head line lives in DFFs.
  Every SRAM block serves a push and a pop every cycle (2 accesses) —
  the power-hungry behavior the paper measures at +35%.
* FixyNN [38]: the classic design restricted to single-port SRAMs: no two
  accessors may ever touch one block in the same cycle. We schedule it
  with the same ILP at P=1 (the paper's Tbl. 1 characterization).
"""
from __future__ import annotations

import dataclasses
import math

from .contention import causality_delay
from .dag import Edge, PipelineDAG, Stage
from .ilp import Schedule, ScheduleProblem, build_problem, solve_schedule
from .linebuffer import Allocation, BufferAlloc, MemConfig


# --------------------------------------------------------------- Darkroom
def darkroom_linearize(dag: PipelineDAG) -> tuple[PipelineDAG, dict[str, str]]:
    """Insert relay stages so each producer has one effective consumer.

    Returns the rewritten DAG and the var ties (relay -> shadowed
    consumer's schedule variable).

    Temporal out-edges (st > 1) are left attached to their producer: the
    history taps stream from the frame store, not the line buffer (see
    ilp.build_problem), so routing them through a relay would both be
    acausal (a relay holds no frames) and silently drop the temporal
    extent. Only the spatial consumer patterns are linearized — which is
    all the line-buffer contention model ever sees.
    """
    stages = {n: s for n, s in dag.stages.items()}
    edges = list(dag.edges)
    var_of: dict[str, str] = {}
    topo_pos = {n: i for i, n in enumerate(dag.topo_order)}
    for p in dag.topo_order:
        # relay chain must follow the consumers' topological order — the
        # relay shadowing consumer c feeds only stages downstream of c
        # (sorting by stencil size alone can create an acausal rewiring).
        outs = sorted((e for e in dag.out_edges(p) if e.st == 1),
                      key=lambda e: (topo_pos[e.consumer], e.sh, e.sw))
        if len(outs) <= 1:
            continue
        cur_producer = p
        prev = outs[0]          # nearest consumer keeps reading p directly
        for i, e in enumerate(outs[1:], 1):
            relay = f"{p}__r{i}"
            stages[relay] = Stage(name=relay, fn=None)
            # relay shadows the previous consumer's pattern and schedule
            edges.append(Edge(cur_producer, relay, prev.sh, prev.sw))
            if prev.consumer != e.consumer:
                tie = prev.consumer
                var_of[relay] = var_of.get(tie, tie)
            # else: both edges belong to one stage (e.g. xcorr's 1x1 + 18x1
            # double read) — a relay tied to the very stage it feeds would
            # be acausal, so it stays free-standing (this is what makes
            # Darkroom replicate the tall buffer, paper Sec. 8.3).
            # rewire: e.consumer now reads from the relay
            edges.remove(e)
            new_e = Edge(relay, e.consumer, e.sh, e.sw)
            edges.append(new_e)
            cur_producer = relay
            prev = new_e
    new_dag = PipelineDAG(dag.name + "+darkroom", list(stages.values()), edges)
    return new_dag, var_of


def darkroom_schedule(dag: PipelineDAG, w: int, frame_h: int = 0,
                      mem_cfg: dict[str, MemConfig] | None = None
                      ) -> tuple[PipelineDAG, Schedule]:
    """Schedule the linearized DAG. ``frame_h`` folds the (unchanged by
    linearization) temporal frame-ring pixels into the reported objective;
    ``mem_cfg`` maps *original* stages to memory configs — relays are not
    in it and default to dual-port, Darkroom's Tbl. 1 characterization."""
    lin, ties = darkroom_linearize(dag)
    if mem_cfg is not None:
        prob = build_problem(lin, w, mem_cfg=dict(mem_cfg), var_of=ties,
                             frame_h=frame_h)
    else:
        prob = build_problem(lin, w, ports=2, var_of=ties, frame_h=frame_h)
    return lin, solve_schedule(prob)


# ------------------------------------------------------------------ SODA
@dataclasses.dataclass
class SodaDesign:
    alloc: Allocation
    dff_pixels: int            # head-line pixels held in registers
    latency_start: dict[str, int]
    frame_pixels: int = 0      # temporal frame-ring pixels (frame_h given)


def soda_allocate(dag: PipelineDAG, w: int, block_bits: int,
                  pixel_bits: int = 32, sized: bool = True,
                  frame_h: int = 0) -> SodaDesign:
    """Analytic SODA sizing: per consumer reuse chains as split FIFOs.

    For a buffer with consumer stencil heights sh_c and widths sw_c, the
    reuse chain holds (max_sh - 1) * W + max_sw pixels; the partial head
    (max_sw) is DFFs. Tap points of the remaining consumers split the
    full lines into separate FIFO blocks (Fig. 4b). Every block serves
    2 accesses/cycle (fifo_mode). ``frame_h`` reports the temporal
    frame-ring pixels ((st-1) full frames per temporal producer) —
    identical for every baseline, counted for comparability with the
    post-PR-3 ilp.Schedule objective.
    """
    buffers: dict[str, BufferAlloc] = {}
    dff = 0
    starts: dict[str, int] = {}
    wpb = block_bits // pixel_bits
    cfg = MemConfig("SODA-FIFO", ports=2, block_bits=block_bits,
                    sized=sized, pixel_bits=pixel_bits)
    for p in dag.topo_order:
        cons = [e for e in dag.out_edges(p)
                if not dag.stages[e.consumer].is_output]
        if not cons:
            continue
        depths = sorted({(e.sh - 1) * w + e.sw for e in cons})
        chain = max(depths)
        head = min(chain, max(e.sw for e in cons))   # DFF head
        dff += head
        sram_pixels = max(0, chain - head)
        n_lines = math.ceil(sram_pixels / w)
        # tap points strictly inside the SRAM portion split lines into
        # separate FIFOs; each full line also needs ceil(W/wpb) blocks.
        inner_taps = [d for d in depths[:-1] if d > head]
        blocks_per_line = max(1, math.ceil(min(w, max(sram_pixels, 1)) / wpb))
        n_blocks = n_lines * blocks_per_line + len(inner_taps)
        if n_blocks == 0:
            continue  # whole chain fits in DFFs
        if sized:
            alloc_bits = sram_pixels * pixel_bits
            bits_per_block = max(1, alloc_bits // n_blocks)
        else:
            alloc_bits = n_blocks * block_bits
            bits_per_block = block_bits
        reads = sum(e.sh for e in cons)
        buffers[p] = BufferAlloc(
            owner=p, cfg=cfg, n_lines=n_lines, n_lines_phys=n_lines, pack=1,
            n_blocks=n_blocks, bits_per_block=bits_per_block,
            alloc_bits=alloc_bits,
            logical_bits=sram_pixels * pixel_bits,
            reads_per_cycle=reads, writes_per_cycle=1,
            window_regs=sum(e.sh * e.sw for e in dag.out_edges(p)))
    # ASAP causality schedule (FIFOs stall-free by construction)
    for s in dag.topo_order:
        ins = dag.in_edges(s)
        starts[s] = 0 if not ins else max(
            starts[e.producer] + causality_delay(e.sh, w) for e in ins)
    alloc = Allocation(dag_name=dag.name + "+soda", w=w, buffers=buffers,
                       fifo_mode=True)
    frame_px = sum((d - 1) * frame_h * w
                   for d in dag.temporal_depths().values())
    return SodaDesign(alloc=alloc, dff_pixels=dff, latency_start=starts,
                      frame_pixels=frame_px)


# ---------------------------------------------------------------- FixyNN
def fixynn_schedule(dag: PipelineDAG, w: int, frame_h: int = 0) -> Schedule:
    """Single-port schedule: P=1 everywhere (no coalescing possible)."""
    prob = build_problem(dag, w, ports=1, frame_h=frame_h)
    return solve_schedule(prob)
