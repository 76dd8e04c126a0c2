"""Plan code generation (paper Sec. 4 "RTL Code Generation", adapted).

The paper emits synthesizable Verilog; it calls that step "a mechanical
translation ... not a contribution". Our backend targets are (i) the
cycle-accurate simulator and (ii) the fused line-buffered stencil kernel,
so codegen produces a :class:`PipelinePlan` — the complete static
description of the accelerator: stage schedule, ring-buffer sizes, block
layout, accessor maps — plus a human-readable pseudo-RTL dump for
inspection.

This module is a copy of the JAX package's planner, so a plan's dict and
fingerprint equal the reference's. The ``vmem_*`` sizing helpers describe
the reference's TPU embodiment (rings rounded to lcm(R, 8) rows, lanes to
128); the CUDA kernel sizes its shared-memory rings itself
(``kernels/stencil_pipeline.py``) and reports them as ``smem_bytes``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Mapping, Sequence

from repro_torch.obs import trace

from .dag import PipelineDAG
from .ilp import Schedule, build_problem, solve_schedule
from .linebuffer import DP, DPLC, QP, SP, Allocation, MemConfig, allocate
from .power import memory_area, memory_power
from .simulate import SimReport, simulate


def mem_cfg_key(mem: MemConfig | Mapping[str, MemConfig]) -> tuple:
    """Stable, hashable identity of a memory-config combo.

    This is the "mem" leg of a plan-cache key. A single MemConfig keys
    as its field tuple; a per-stage mapping keys as a sorted tuple of
    (stage, field tuple) — except that a mapping assigning the same
    config to every stage collapses to the uniform key, so a compiled
    plan's fully-expanded ``mem_cfg`` keys identically to the uniform
    spec it came from. (A *partial* mapping that compile_pipeline would
    fill with DP defaults still keys distinctly: the stage set is not
    known here.)
    """
    if isinstance(mem, MemConfig):
        return ("uniform", dataclasses.astuple(mem))
    cfgs = {dataclasses.astuple(c) for c in mem.values()}
    if len(cfgs) == 1:
        return ("uniform", next(iter(cfgs)))
    return ("per-stage", tuple(sorted(
        (s, dataclasses.astuple(c)) for s, c in mem.items())))


def probe_height(dag: PipelineDAG, alloc: Allocation) -> int:
    """Simulator probe height covering every ring's full wrap behavior:
    three wraps of the tallest ring plus stencil reach. The single
    definition — compile_pipeline's padding loop and the autotuner's
    contention-slack scoring (dse.py) must probe at the same height or
    the tuner would score on a simulation the compiler never validated.
    """
    max_n = max((b.n_lines_phys for b in alloc.buffers.values()),
                default=1)
    max_sh = max((e.sh for e in dag.edges), default=1)
    return 3 * (max_n + max_sh) + 4


def row_group_rings(dag: PipelineDAG, alloc_buffers: Mapping | None,
                    rows_per_step: int) -> dict[str, int]:
    """Physical VMEM ring rows per buffer owner for row-group execution.

    With ``rows_per_step`` (R) output rows per grid step, a consumer
    reading an (sh, sw) window needs the producer's last ``R + sh - 1``
    rows live simultaneously — one contiguous slab per step instead of sh
    row reads. Rings therefore cover ``max(plan physical lines,
    R + max_consumer_sh - 1)``, rounded up to a multiple of lcm(R, 8):
    the R leg keeps every R-row ring *write* slab contiguous (write slots
    are multiples of R, so stores never wrap), the 8 leg is the float32
    (8, 128) VMEM sublane tile. At R=1 this reduces exactly to the old
    per-row sizing padded to 8 sublanes.
    """
    if rows_per_step < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
    quantum = math.lcm(rows_per_step, 8)
    rings: dict[str, int] = {}
    for p in dag.topo_order:
        shs = [e.sh for e in dag.out_edges(p)
               if not dag.stages[e.consumer].is_output]
        if not shs:
            continue
        need = rows_per_step + max(shs) - 1
        if alloc_buffers and p in alloc_buffers:
            need = max(need, alloc_buffers[p].n_lines_phys)
        rings[p] = -(-need // quantum) * quantum
    return rings


def row_group_vmem_bytes(dag: PipelineDAG, alloc_buffers: Mapping | None,
                         rows_per_step: int, w: int) -> int:
    """float32 VMEM footprint of the row-group rings at line width ``w``,
    including the temporal tap rings of a video pipeline."""
    w_pad = -(-w // 128) * 128
    rings = row_group_rings(dag, alloc_buffers, rows_per_step)
    taps = temporal_tap_rings(dag, rows_per_step)
    return sum(r * w_pad * 4 for r in rings.values()) \
        + sum(r * w_pad * 4 for r in taps.values())


def tap_name(producer: str, j: int) -> str:
    """Display/ring name of temporal tap ``j`` (frames back) of a producer."""
    return f"{producer}@t-{j}"


def frame_outputs(dag: PipelineDAG) -> list[str]:
    """Internal (non-input) temporal producers, in topo order: their
    frames must round-trip through the caller's frame ring, so the fused
    kernel emits them as extra outputs. The single definition — the
    kernel builder and the prefetch-ring sizing must agree on the output
    set or the DMA accounting drifts from the program."""
    depths = dag.temporal_depths()
    return [p for p in dag.topo_order
            if depths.get(p, 1) > 1 and not dag.stages[p].is_input]


def prefetch_rings(dag: PipelineDAG, rows_per_step: int,
                   prefetch_depth: int) -> dict[str, int]:
    """VMEM prefetch-ring rows per DMA endpoint at ``prefetch_depth`` > 1.

    With multi-buffered DMA/compute overlap the fused kernel stops
    streaming I/O through BlockSpec grid slices; instead every feed
    (input stage or temporal tap) owns an input prefetch ring of
    ``prefetch_depth`` slots x ``rows_per_step`` rows that
    ``pltpu.make_async_copy`` fills ahead of compute, and every output
    (the pipeline output plus each internal temporal producer's frame
    round-trip) owns a staging ring of the same shape that drains
    asynchronously behind it. Keys are ``{name}@pf-in`` /
    ``{name}@pf-out`` — disjoint from the line-buffer and ``@t-j`` tap
    namespaces. ``prefetch_depth == 1`` is the synchronous BlockSpec
    path: no rings, empty dict.
    """
    if prefetch_depth < 1:
        raise ValueError(
            f"prefetch_depth must be >= 1, got {prefetch_depth}")
    if prefetch_depth == 1:
        return {}
    slab = prefetch_depth * rows_per_step
    rings: dict[str, int] = {}
    for name in dag.input_stages():
        rings[f"{name}@pf-in"] = slab
    for (p, j) in temporal_taps(dag):
        rings[f"{tap_name(p, j)}@pf-in"] = slab
    rings[f"{dag.output_stages()[0]}@pf-out"] = slab
    for p in frame_outputs(dag):
        rings[f"{p}@pf-out"] = slab
    return rings


def prefetch_ring_bytes(dag: PipelineDAG, rows_per_step: int,
                        prefetch_depth: int, w: int) -> int:
    """float32 VMEM footprint of the prefetch rings at line width ``w``
    (0 at depth 1 — the synchronous path allocates none)."""
    w_pad = -(-w // 128) * 128
    return sum(r * w_pad * 4
               for r in prefetch_rings(dag, rows_per_step,
                                       prefetch_depth).values())


def temporal_taps(dag: PipelineDAG) -> list[tuple[str, int]]:
    """(producer, j) for every history tap a temporal pipeline needs.

    An edge with temporal extent st reads its producer at offsets
    j = 0..st-1 frames back; j = 0 is the producer's live ring, each
    j >= 1 is a *pseudo-input* — the producer's frame from j steps ago,
    streamed from the device-resident frame ring. Deterministic order:
    topo position of the producer, then ascending j.
    """
    depths = dag.temporal_depths()
    return [(p, j) for p in dag.topo_order
            for j in range(1, depths.get(p, 1))]


def temporal_tap_rings(dag: PipelineDAG, rows_per_step: int
                       ) -> dict[tuple[str, int], int]:
    """VMEM ring rows per temporal tap pseudo-input.

    Tap (p, j) feeds every edge from p with st > j; like any producer its
    ring must hold one read slab — ``R + max_sh - 1`` rows over those
    edges — rounded to the same lcm(R, 8) quantum as the spatial rings
    (see :func:`row_group_rings`). These rings have no line-buffer plan
    to grow from: history frames stream from HBM, so the slab is the
    whole requirement.
    """
    quantum = math.lcm(rows_per_step, 8)
    rings: dict[tuple[str, int], int] = {}
    for (p, j) in temporal_taps(dag):
        sh = max(e.sh for e in dag.out_edges(p) if e.st > j)
        need = rows_per_step + sh - 1
        rings[(p, j)] = -(-need // quantum) * quantum
    return rings


@dataclasses.dataclass
class PipelinePlan:
    dag: PipelineDAG
    w: int
    schedule: Schedule
    alloc: Allocation
    mem_cfg: dict[str, MemConfig]
    rows_per_step: int = 1
    prefetch_depth: int = 1

    @property
    def total_alloc_bits(self) -> int:
        return self.alloc.total_alloc_bits

    @property
    def power(self) -> float:
        return memory_power(self.alloc)

    @property
    def area(self) -> float:
        return memory_area(self.alloc)

    def verify(self, h: int) -> SimReport:
        return simulate(self.dag, self.schedule, self.w, h,
                        alloc=self.alloc, cfg_of=self.mem_cfg)

    @property
    def cache_key(self) -> tuple:
        """(pipeline name, width, mem combo, row group, prefetch depth)
        — the plan-cache identity. ``rows_per_step`` and
        ``prefetch_depth`` are execution-granularity choices the
        schedule/allocation are independent of, so plans differing only
        in them can be derived from each other without re-running the
        ILP (see PlanCache.plan_for) — but they ARE distinct compiled
        artifacts: ring physical sizing, VMEM accounting, and the
        generated executor all change with R and with depth."""
        return (self.dag.name, self.w, mem_cfg_key(self.mem_cfg),
                self.rows_per_step, self.prefetch_depth)

    def vmem_rings(self) -> dict[str, int]:
        """Physical VMEM ring rows per buffer for the row-group executor:
        line-buffer rings, temporal tap rings (keyed ``producer@t-j``),
        and — at prefetch_depth > 1 — the DMA prefetch rings (keyed
        ``name@pf-in`` / ``name@pf-out``)."""
        rings = row_group_rings(self.dag, self.alloc.buffers,
                                self.rows_per_step)
        for (p, j), rr in temporal_tap_rings(self.dag,
                                             self.rows_per_step).items():
            rings[tap_name(p, j)] = rr
        rings.update(prefetch_rings(self.dag, self.rows_per_step,
                                    self.prefetch_depth))
        return rings

    def buffer_meta(self) -> dict[str, dict]:
        """Stable identity + sizing for every buffer this plan embodies.

        The join key of the memory-observability plane: memtrace samples
        (keyed by buffer name) meet allocation facts (ring rows/bytes,
        ports, pack, memory kind) here, so occupancy-vs-allocation waste
        can be computed without reaching into ``alloc``/``vmem_rings``
        separately. Keys match :meth:`vmem_rings` for VMEM rings
        (``stage`` / ``producer@t-j`` / ``name@pf-in|out``) plus
        ``producer@ring`` for device-resident frame rings. The
        ``ring_bytes`` of the line-buffer, temporal-tap, and
        prefetch-ring entries sum exactly to :attr:`vmem_ring_bytes`.
        """
        w_pad = -(-self.w // 128) * 128
        meta: dict[str, dict] = {}
        rings = row_group_rings(self.dag, self.alloc.buffers,
                                self.rows_per_step)
        for p, rows in rings.items():
            b = self.alloc.buffers.get(p)
            meta[p] = {
                "kind": "line_buffer", "stage": p,
                "ring_rows": rows, "ring_bytes": rows * w_pad * 4,
                "n_lines": b.n_lines if b else 0,
                "n_lines_phys": b.n_lines_phys if b else rows,
                "pack": b.pack if b else 1,
                "ports": b.cfg.ports if b else 0,
                "mem": b.cfg.name if b else "-",
            }
        for (p, j), rows in temporal_tap_rings(
                self.dag, self.rows_per_step).items():
            meta[tap_name(p, j)] = {
                "kind": "temporal_tap", "stage": p, "tap": j,
                "ring_rows": rows, "ring_bytes": rows * w_pad * 4,
                "pack": 1, "ports": 0, "mem": "-",
            }
        for name, rows in prefetch_rings(
                self.dag, self.rows_per_step, self.prefetch_depth).items():
            stage, _, direction = name.rpartition("@")
            meta[name] = {
                "kind": "prefetch_ring", "stage": stage,
                "direction": "in" if direction == "pf-in" else "out",
                "depth": self.prefetch_depth,
                "ring_rows": rows, "ring_bytes": rows * w_pad * 4,
                "pack": 1, "ports": 0, "mem": "-",
            }
        for p, d in self.frame_depths.items():
            if d > 1:
                meta[f"{p}@ring"] = {
                    "kind": "frame_ring", "stage": p, "depth": d,
                    "frames_resident": d - 1,
                }
        return meta

    @property
    def vmem_ring_bytes(self) -> int:
        """float32 VMEM the Pallas embodiment of this plan allocates —
        the row-group rings plus, at prefetch_depth > 1, the extra
        in-flight DMA slabs of the prefetch rings."""
        return row_group_vmem_bytes(self.dag, self.alloc.buffers,
                                    self.rows_per_step, self.w) \
            + prefetch_ring_bytes(self.dag, self.rows_per_step,
                                  self.prefetch_depth, self.w)

    @property
    def frame_depths(self) -> dict[str, int]:
        """Producer -> frames of history its consumers read (entries > 1).
        The frame-ring analogue of ``alloc.buffers``: producer p must keep
        its last ``frame_depths[p] - 1`` frames device-resident."""
        return self.dag.temporal_depths()

    def vmem_frame_bytes(self, h: int) -> int:
        """float32 bytes of device-resident frame-ring state at frame
        height ``h`` — (d-1) full (h, w) frames per temporal producer.
        Height is an execution-shape parameter (like the executor's h),
        so this is a method where ``vmem_ring_bytes`` is a property."""
        return sum((d - 1) * h * self.w * 4
                   for d in self.frame_depths.values())

    def to_dict(self) -> dict:
        """JSON-serializable structural summary of the compiled plan.

        The stage compute payloads (python closures) are deliberately not
        serialized — a plan dict describes the *accelerator* (schedule,
        rings, blocks), which is what persists across processes; payloads
        are re-bound from the pipeline registry by name.
        """
        return {
            "pipeline": self.dag.name,
            "w": self.w,
            "rows_per_step": self.rows_per_step,
            "prefetch_depth": self.prefetch_depth,
            "vmem_rings": self.vmem_rings(),
            "vmem_ring_bytes": self.vmem_ring_bytes,
            "frame_depths": self.frame_depths,
            "schedule": dict(self.schedule.starts),
            "buffers": {
                p: {"n_lines": b.n_lines, "n_lines_phys": b.n_lines_phys,
                    "pack": b.pack, "n_blocks": b.n_blocks,
                    "bits_per_block": b.bits_per_block,
                    "window_regs": b.window_regs, "cfg": b.cfg.name,
                    "ports": b.cfg.ports}
                for p, b in self.alloc.buffers.items()},
            "mem_cfg": {s: c.name for s, c in self.mem_cfg.items()},
            "total_alloc_bits": self.total_alloc_bits,
        }

    def fingerprint(self) -> str:
        """sha256 over the canonical plan dict — change detection for
        serialized plans, cache-consistency assertions, and the compiled-
        kernel memo key in kernels/ops.py. Memoized on the instance (the
        dict walk is not free on a per-call hot path); ``dataclasses.
        replace`` builds a fresh object, so derived siblings never
        inherit a stale digest."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            blob = json.dumps(self.to_dict(), sort_keys=True).encode()
            fp = self.__dict__["_fingerprint"] = \
                hashlib.sha256(blob).hexdigest()
        return fp

    def pseudo_rtl(self) -> str:
        """Textual dump in the spirit of the generated Verilog."""
        lines = [f"// pipeline {self.dag.name}  W={self.w}",
                 f"// schedule: {self.schedule.starts}"]
        for p, b in self.alloc.buffers.items():
            lines.append(
                f"linebuffer {p}: lines={b.n_lines_phys} (logical "
                f"{b.n_lines}) pack={b.pack} blocks={b.n_blocks} x "
                f"{b.bits_per_block}b ports={b.cfg.ports} "
                f"regs={b.window_regs}")
        for p, d in self.frame_depths.items():
            lines.append(f"framering {p}: frames={d - 1} x (H x {self.w})")
        for s in self.dag.topo_order:
            st = self.dag.stages[s]
            kind = ("input" if st.is_input else
                    "output" if st.is_output else "stage")
            reads = ", ".join(
                f"{e.producer}[{e.sh}x{e.sw}]" if e.st == 1
                else f"{e.producer}[{e.st}x{e.sh}x{e.sw}]"
                for e in self.dag.in_edges(s))
            lines.append(f"{kind} {s} @ S={self.schedule.starts[s]}"
                         + (f" reads {reads}" if reads else ""))
        return "\n".join(lines)


def compile_pipeline(dag: PipelineDAG, w: int,
                     mem: MemConfig | Mapping[str, MemConfig] = DP,
                     objective: str = "exact",
                     prune: bool = True,
                     max_pad_iters: int = 8,
                     rows_per_step: int = 1,
                     frame_h: int = 0,
                     mem_cfg: MemConfig | Mapping[str, MemConfig] | None = None,
                     schedule: Schedule | None = None,
                     prefetch_depth: int = 1) -> PipelinePlan:
    """Front door: DAG + memory spec -> scheduled, allocated plan.

    After scheduling, the allocation is validated by the cycle-accurate
    simulator; buffers whose minimal ring aliases the writer's block with
    the oldest consumer's reads (a corner the paper's logical-line model
    misses — see simulate.py) get their ring padded by one slot group at a
    time until the simulation is clean. The schedule never changes.

    ``frame_h`` folds temporal frame-ring pixels into the schedule's
    reported objective (see ilp.build_problem); it never affects the
    solve, so plans are still height-independent artifacts.

    ``mem_cfg`` is an alias of ``mem`` (the name the serving stack and the
    autotuner use for per-stage dicts); passing both is an error.
    ``schedule`` skips the MILP solve and reuses a schedule the caller
    already solved under an equivalent constraint problem — equivalence is
    the caller's contract (see ilp.schedule_signature); the allocation and
    simulator validation still run against the *given* memory configs.
    """
    with trace.span("compile.pipeline", dag=dag.name, w=w,
                    rows_per_step=rows_per_step,
                    prefetch_depth=prefetch_depth,
                    reused_schedule=schedule is not None) as sp:
        plan = _compile_pipeline(dag, w, mem, objective, prune,
                                 max_pad_iters, rows_per_step, frame_h,
                                 mem_cfg, schedule, prefetch_depth)
        sp.set(vmem_ring_bytes=plan.vmem_ring_bytes)
        return plan


def _compile_pipeline(dag, w, mem, objective, prune, max_pad_iters,
                      rows_per_step, frame_h, mem_cfg,
                      schedule, prefetch_depth) -> PipelinePlan:
    if mem_cfg is not None:
        if mem is not DP:
            raise TypeError("pass either mem= or mem_cfg=, not both")
        mem = mem_cfg
    if isinstance(mem, MemConfig):
        cfg_of = {s: mem for s in dag.stages}
    else:
        cfg_of = dict(mem)
        for s in dag.stages:
            cfg_of.setdefault(s, DP)
    if schedule is None:
        prob = build_problem(dag, w, mem_cfg=cfg_of, prune=prune,
                             frame_h=frame_h)
        sched = solve_schedule(prob, objective=objective)
    else:
        sched = schedule

    extra: dict[str, int] = {}
    for _ in range(max_pad_iters):
        alloc = allocate(dag, sched, cfg_of, w, extra_lines=extra)
        rep = simulate(dag, sched, w, probe_height(dag, alloc),
                       alloc=alloc, cfg_of=cfg_of)
        if rep.ok:
            break
        progressed = False
        for p in rep.bad_buffers:
            if p in alloc.buffers:
                extra[p] = extra.get(p, 0) + alloc.buffers[p].pack
                progressed = True
        if not progressed:
            raise ValueError(f"{dag.name}: simulation violations not "
                             f"attributable to ring size: {rep.violations}")
    else:
        raise ValueError(f"{dag.name}: ring padding did not converge: "
                         f"{rep.violations}")
    return PipelinePlan(dag=dag, w=w, schedule=sched, alloc=alloc,
                        mem_cfg=cfg_of, rows_per_step=rows_per_step,
                        prefetch_depth=prefetch_depth)


def plan_from_dict(d: Mapping, dag: PipelineDAG,
                   configs: Sequence[MemConfig] = (DP, SP, DPLC, QP)
                   ) -> PipelinePlan:
    """Rebuild a :class:`PipelinePlan` from :meth:`PipelinePlan.to_dict`.

    The dict carries the schedule's start cycles and every buffer's
    allocation, but not the stage payloads or the memory configs' full
    fields: ``dag`` re-binds the payloads, and each config is looked up
    by name in ``configs`` (the ASIC set by default; pass the FPGA set
    for FPGA plans). The allocation is recomputed by :func:`allocate`
    from the start cycles (Eq. 2 line counts) plus the ring padding the
    dict's line counts imply, then checked field by field against the
    dict, so a dict from another planner version that disagrees raises
    instead of yielding a silently different accelerator.
    """
    if d["pipeline"] != dag.name:
        raise ValueError(f"plan is for {d['pipeline']!r}, dag is "
                         f"{dag.name!r}")
    w = int(d["w"])
    by_name = {c.name: c for c in configs}
    try:
        mem_cfg = {s: by_name[n] for s, n in d["mem_cfg"].items()}
    except KeyError as e:
        raise ValueError(f"memory config {e} not among "
                         f"{sorted(by_name)}") from None
    starts = {s: int(v) for s, v in d["schedule"].items()}
    lines, extra = {}, {}
    for p, b in d["buffers"].items():
        deltas = [starts[e.consumer] - starts[p] for e in dag.out_edges(p)
                  if not dag.stages[e.consumer].is_output]
        lines[p] = max(deltas) // w + 1
        extra[p] = int(b["n_lines"]) - lines[p]
    sched = Schedule(dag_name=dag.name, w=w, starts=starts,
                     buffer_lines=lines,
                     total_pixels=sum(n * w for n in lines.values()),
                     enforced=[], n_branches=0, solve_ms=0.0,
                     objective_mode="from_dict",
                     frame_depths=dag.temporal_depths())
    alloc = allocate(dag, sched, mem_cfg, w, extra_lines=extra)
    for p, b in d["buffers"].items():
        got = alloc.buffers[p]
        have = {"n_lines": got.n_lines, "n_lines_phys": got.n_lines_phys,
                "pack": got.pack, "n_blocks": got.n_blocks,
                "bits_per_block": got.bits_per_block,
                "window_regs": got.window_regs, "cfg": got.cfg.name,
                "ports": got.cfg.ports}
        if have != dict(b):
            raise ValueError(f"buffer {p!r}: dict {dict(b)} does not "
                             f"reallocate as given: {have}")
    if alloc.total_alloc_bits != d["total_alloc_bits"]:
        raise ValueError(f"total_alloc_bits {alloc.total_alloc_bits} != "
                         f"{d['total_alloc_bits']}")
    return PipelinePlan(dag=dag, w=w, schedule=sched, alloc=alloc,
                        mem_cfg=mem_cfg,
                        rows_per_step=int(d["rows_per_step"]),
                        prefetch_depth=int(d["prefetch_depth"]))
