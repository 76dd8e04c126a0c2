"""Memory-config autotuner / design-space exploration (paper Sec. 5-8.5).

The paper's core loop — pick on-chip memory structures that minimize SRAM
while holding theoretical max throughput — as a callable subsystem rather
than an offline figure generator. :func:`autotune` enumerates per-stage
:class:`MemConfig` assignments (port counts, coalescing pack factors,
block sizing), prunes candidates with the port-constraint machinery
before ever invoking the MILP, memoizes solves across combos that induce
the same constraint problem (ilp.schedule_signature), compiles the
survivors, and scores each on three axes:

  * **VMEM ring bytes** — the Pallas embodiment's footprint
    (plan.vmem_ring_bytes), the serving stack's SRAM bill;
  * **power** — the analytic energy model (power.memory_power) over the
    candidate's allocation;
  * **contention slack** — spare port headroom from the cycle-accurate
    simulator (contention.port_slack): 0 means some block is saturated
    at its worst-case cycle, higher means margin.

This module is a copy of the JAX package's autotuner, so a search's
winner, Pareto set and depth axis equal the reference's. Its VMEM
scores are the reference's TPU planner arithmetic, not measurements of
a card: the CUDA kernel sizes its shared-memory rings itself
(``kernels/stencil_pipeline.py``). The depth axis classifies a pipeline
DMA-bound against the perf model's ``DMA_BYTES_PER_CYCLE``, the modeled
accelerator's interface width (``perf/model.py``).

The result is a ranked :class:`TuningResult`: ``best`` minimizes
(vmem bytes, power, area) lexicographically, and ``pareto()`` is the
frontier over {vmem bytes, power, slack}. The serving default (uniform
DP) is always candidate #0, so ``best`` can never be worse than the
untuned config — the invariant the CI smoke gate (benchmarks/
tune_sweep.py) enforces end to end.

The legacy 2-axis sweep (:func:`sweep`, Fig. 10) remains for the
area/power Pareto plots; it now forwards ``frame_h``/``rows_per_step``
to the post-PR-3 compile signature.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Mapping, Sequence

from repro_torch.obs import trace

from .codegen import PipelinePlan, compile_pipeline, probe_height
from .contention import port_slack
from .dag import PipelineDAG
from .ilp import Schedule, build_problem, schedule_signature, solve_schedule
from .linebuffer import DP, DPLC, QP, SP, MemConfig
from .pruning import or_branch_count

# The default search space: one axis per memory-structure decision.
#   SP    — fewest ports: cheapest leakage/area per bit, tightest schedule;
#   DP    — the paper's (and the serving stack's) default;
#   QP    — port-rich: dissolves every port OR-group, line counts drop to
#           the causality minimum, paid for in quadratic port area/leakage;
#   DPLC  — dual-port with line coalescing (wide-word packing, Sec. 6);
#   DPLC2 — coalescing capped at 2 lines/block (the paper's K=min(P,SH)
#           split) — the pack-factor axis, distinct from DPLC wherever
#           the uncapped pack exceeds 2.
DPLC2 = MemConfig("DPLC2", ports=2, block_bits=DPLC.block_bits,
                  coalesce=True, pack_cap=2)
TUNE_OPTIONS: tuple[MemConfig, ...] = (SP, DP, QP, DPLC, DPLC2)


@dataclasses.dataclass
class Candidate:
    """One evaluated memory combo: compiled plan + the three score axes.

    After ranking, only the winning candidate keeps its compiled
    ``plan``; the rest are released (``plan=None``) so a memoized
    TuningResult holds one plan, not ``max_candidates`` of them — the
    scored metrics are all a non-best candidate is ever read for.
    """
    combo: dict[str, str]               # buffer owner -> cfg name
    mem_cfg: dict[str, MemConfig]       # full per-stage assignment
    plan: PipelinePlan | None
    vmem_bytes: int                     # plan.vmem_ring_bytes
    power: float
    area: float
    alloc_bits: int
    total_pixels: int                   # ILP objective (LB + frame rings)
    contention_slack: int
    pareto: bool = False

    @property
    def score(self) -> tuple:
        return (self.vmem_bytes, self.power, self.area,
                tuple(sorted(self.combo.items())))

    def to_dict(self) -> dict:
        return {"combo": dict(self.combo), "vmem_bytes": self.vmem_bytes,
                "power": self.power, "area": self.area,
                "alloc_bits": self.alloc_bits,
                "total_pixels": self.total_pixels,
                "contention_slack": self.contention_slack,
                "pareto": self.pareto}


@dataclasses.dataclass
class TuneStats:
    n_enumerated: int = 0               # combos drawn from the space
    n_pruned_infeasible: int = 0        # port OR-group with no candidate
    n_pruned_branches: int = 0          # branch product over branch_cap
    n_solver_infeasible: int = 0        # all MILP branches infeasible
    n_compiled: int = 0                 # candidates fully compiled+scored
    n_sched_memo_hits: int = 0          # solves saved by signature memo
    space_size: int = 0                 # |options| ** |owners|
    truncated: bool = False             # space exceeded max_candidates
    tune_s: float = 0.0


@dataclasses.dataclass
class TuningResult:
    """Ranked outcome of one autotune run (one pipeline at one width)."""
    pipeline: str
    w: int
    rows_per_step: int
    frame_h: int
    candidates: list[Candidate]         # ranked: candidates[0] is best
    default: Candidate                  # uniform serving default (DP)
    stats: TuneStats
    # --- DMA/compute-overlap axis (scored on the winning mem combo) ---
    bound: str = "compute"              # model roofline of the winner
    best_depth: int = 1                 # ranked prefetch_depth winner
    depth_candidates: list[dict] = dataclasses.field(default_factory=list)

    @property
    def best(self) -> Candidate:
        return self.candidates[0]

    def pareto(self) -> list[Candidate]:
        """Frontier over (vmem bytes ↓, power ↓, contention slack ↑)."""
        return [c for c in self.candidates if c.pareto]

    def to_dict(self) -> dict:
        return {
            "pipeline": self.pipeline, "w": self.w,
            "rows_per_step": self.rows_per_step, "frame_h": self.frame_h,
            "best": self.best.to_dict(), "default": self.default.to_dict(),
            "pareto": [c.to_dict() for c in self.pareto()],
            "n_candidates": len(self.candidates),
            "bound": self.bound,
            "best_depth": self.best_depth,
            "depth_candidates": [dict(d) for d in self.depth_candidates],
            "stats": dataclasses.asdict(self.stats),
        }


def buffer_owners(dag: PipelineDAG) -> list[str]:
    """Stages owning a line buffer — the only stages whose memory config
    is a real decision (everything else holds no SRAM)."""
    return [p for p in dag.topo_order
            if any(not dag.stages[e.consumer].is_output
                   for e in dag.out_edges(p))]


def _mark_pareto3(cands: list[Candidate]) -> None:
    for c in cands:
        c.pareto = not any(
            q.vmem_bytes <= c.vmem_bytes and q.power <= c.power
            and q.contention_slack >= c.contention_slack
            and (q.vmem_bytes < c.vmem_bytes or q.power < c.power
                 or q.contention_slack > c.contention_slack)
            for q in cands)


def _enumerate(owners: Sequence[str], options: Sequence[MemConfig],
               base: Mapping[str, MemConfig]):
    """Combos in evaluation order: the serving default first (so ``best``
    is never worse than it), then the uniform assignments (the likely
    winners, and the cheapest to reason about), then the cartesian
    product. Duplicates are filtered by the caller via the seen-set."""
    yield {p: base[p] for p in owners}
    for opt in options:
        yield {p: opt for p in owners}
    for choice in itertools.product(options, repeat=len(owners)):
        yield dict(zip(owners, choice))


def autotune(dag: PipelineDAG, w: int,
             options: Sequence[MemConfig] = TUNE_OPTIONS,
             default: MemConfig | Mapping[str, MemConfig] = DP,
             rows_per_step: int = 1,
             frame_h: int = 0,
             max_candidates: int = 128,
             branch_cap: int = 256,
             prefetch_depths: Sequence[int] = (1, 2, 4),
             vmem_budget: int | None = None) -> TuningResult:
    """Search per-stage memory assignments; return the ranked result.

    ``options`` is the per-owner choice set; non-owner stages keep the
    ``default`` config (their entry never touches SRAM). ``max_candidates``
    bounds *compiled* candidates — pruned combos are free — and the
    cartesian product is truncated beyond it (uniform combos are always
    evaluated first, so truncation can only cost exotic mixes, never the
    serving default). ``branch_cap`` prunes combos whose port OR-groups
    would explode into more MILP branches than it allows.

    Every returned candidate compiled cleanly and passed the simulator's
    R1/R2/R3 validation inside compile_pipeline; scoring runs one more
    simulate() probe to extract the contention-slack axis.

    ``prefetch_depths`` is the DMA/compute-overlap axis, scored on the
    winning memory combo *after* the mem search (depth siblings are
    dataclasses.replace derivations — no re-ILP): only a pipeline the
    analytic roofline classifies DMA-bound enumerates depth > 1
    (overlap cannot beat the compute roof, so a compute-bound pipeline
    never pays the prefetch-ring VMEM), and the ranker minimizes
    (predicted cycles, VMEM ring bytes) over depths whose VMEM fits
    ``vmem_budget`` (None = unbounded). Ties on predicted cycles —
    the analytic model cannot separate depth 2 from 4 — resolve to the
    shallower ring; the measured depth sweep in benchmarks/perf_lab.py
    is the empirical referee.
    """
    with trace.span("dse.autotune", pipeline=dag.name, w=w) as sp:
        res = _autotune(dag, w, options, default, rows_per_step, frame_h,
                        max_candidates, branch_cap, prefetch_depths,
                        vmem_budget)
        sp.set(enumerated=res.stats.n_enumerated,
               compiled=res.stats.n_compiled,
               pruned=(res.stats.n_pruned_infeasible
                       + res.stats.n_pruned_branches),
               memo_hits=res.stats.n_sched_memo_hits,
               truncated=res.stats.truncated,
               bound=res.bound, best_depth=res.best_depth)
        return res


def _score_depths(plan: PipelinePlan, dag: PipelineDAG, w: int,
                  frame_h: int, prefetch_depths: Sequence[int],
                  vmem_budget: int | None) -> tuple[str, int, list[dict]]:
    """(bound, best_depth, depth candidate rows) for the winning plan.

    Uses the perf model's DMA accounting so the classification here and
    the prediction in perf_report/v1 can never disagree. The probe
    height is ``frame_h`` when the caller gave one (temporal tuning
    already carries it), else ``w`` — bound is height-invariant (both
    steady and DMA cycles scale with h), so any positive height ranks
    identically.
    """
    # local import: perf.model depends on core; core.dse must not pull
    # it in at module-import time
    from repro_torch.perf.model import DMA_BYTES_PER_CYCLE, _hbm_bytes
    h = frame_h if frame_h > 0 else w
    steady = h * w
    fill = int(plan.schedule.starts[dag.output_stages()[0]])
    dma = -(-_hbm_bytes(plan, h) // DMA_BYTES_PER_CYCLE)
    bound = "dma" if dma >= steady else "compute"
    rows: list[dict] = []
    depths = sorted(set(prefetch_depths) | {1})
    for d in depths:
        if d < 1:
            raise ValueError(f"prefetch_depths must be >= 1, got {d}")
        if d > 1 and bound != "dma":
            continue
        vmem = dataclasses.replace(plan, prefetch_depth=d).vmem_ring_bytes
        cycles = fill + (max(steady, dma) if d >= 2 else steady + dma)
        rows.append({
            "prefetch_depth": d, "vmem_bytes": vmem,
            "predicted_cycles_per_frame": cycles, "bound": bound,
            "within_budget": vmem_budget is None or vmem <= vmem_budget,
        })
    fits = [r for r in rows if r["within_budget"]] or rows[:1]
    best = min(fits, key=lambda r: (r["predicted_cycles_per_frame"],
                                    r["vmem_bytes"], r["prefetch_depth"]))
    return bound, best["prefetch_depth"], rows


def _autotune(dag: PipelineDAG, w: int, options, default, rows_per_step,
              frame_h, max_candidates, branch_cap, prefetch_depths,
              vmem_budget) -> TuningResult:
    t0 = time.perf_counter()
    if isinstance(default, MemConfig):
        base = {s: default for s in dag.stages}
    else:
        base = {s: default.get(s, DP) for s in dag.stages}
    owners = buffer_owners(dag)
    stats = TuneStats(space_size=max(len(options), 1) ** len(owners))
    sched_memo: dict[tuple, Schedule | None] = {}
    seen: set[tuple] = set()
    cands: list[Candidate] = []
    default_cand: Candidate | None = None
    default_key = tuple(sorted((p, dataclasses.astuple(base[p]))
                               for p in owners))

    for combo in _enumerate(owners, options, base):
        if stats.n_compiled >= max_candidates:
            stats.truncated = True
            break
        cfg_of = dict(base)
        cfg_of.update(combo)
        # dedup on full config identity — option *names* can collide
        # (e.g. DP and DP_SIZED are both displayed "DP")
        ckey = tuple(sorted((p, dataclasses.astuple(c))
                            for p, c in combo.items()))
        if ckey in seen:
            continue
        seen.add(ckey)
        stats.n_enumerated += 1
        is_default = ckey == default_key

        sig = schedule_signature(dag, w, cfg_of)
        if sig in sched_memo:
            stats.n_sched_memo_hits += 1
            sched = sched_memo[sig]
            if sched is None:       # signature known infeasible/pruned
                continue
        else:
            prob = build_problem(dag, w, mem_cfg=cfg_of, frame_h=frame_h)
            if prob.port_problem.infeasible:
                stats.n_pruned_infeasible += 1
                sched_memo[sig] = None
                continue
            # the default combo is exempt from the cost-cap prune: it is
            # the baseline 'tuned <= default' is measured against, and
            # what the untuned serving path would solve anyway (falling
            # back to solve_schedule's internal greedy cap if enormous)
            if (not is_default
                    and or_branch_count(prob.port_problem) > branch_cap):
                stats.n_pruned_branches += 1
                sched_memo[sig] = None
                continue
            try:
                sched = solve_schedule(prob)
            except ValueError:
                stats.n_solver_infeasible += 1
                sched_memo[sig] = None
                continue
            sched_memo[sig] = sched

        try:
            plan = compile_pipeline(dag, w, mem_cfg=cfg_of,
                                    rows_per_step=rows_per_step,
                                    frame_h=frame_h, schedule=sched)
        except ValueError:          # ring padding failed under this mix
            stats.n_solver_infeasible += 1
            continue
        stats.n_compiled += 1
        rep = plan.verify(probe_height(dag, plan.alloc))
        cand = Candidate(
            combo={p: c.name for p, c in combo.items()},
            mem_cfg=cfg_of, plan=plan,
            vmem_bytes=plan.vmem_ring_bytes,
            power=plan.power, area=plan.area,
            alloc_bits=plan.total_alloc_bits,
            total_pixels=sched.total_pixels,
            contention_slack=port_slack(
                rep.peak_block_accesses,
                {p: cfg_of[p].ports for p in rep.peak_block_accesses}))
        cands.append(cand)
        if is_default:
            default_cand = cand

    if default_cand is None:
        raise ValueError(
            f"{dag.name}: the serving default config is infeasible at "
            f"w={w} — autotune has no baseline to improve on"
            + (f" ({len(cands)} other combos compiled)" if cands else ""))
    cands.sort(key=lambda c: c.score)
    _mark_pareto3(cands)
    for c in cands[1:]:             # see Candidate: losers drop their plan
        c.plan = None
    bound, best_depth, depth_cands = _score_depths(
        cands[0].plan, dag, w, frame_h, prefetch_depths, vmem_budget)
    stats.tune_s = time.perf_counter() - t0
    return TuningResult(pipeline=dag.name, w=w, rows_per_step=rows_per_step,
                        frame_h=frame_h, candidates=cands,
                        default=default_cand, stats=stats,
                        bound=bound, best_depth=best_depth,
                        depth_candidates=depth_cands)


# --------------------------------------------------------------- legacy sweep
@dataclasses.dataclass
class DsePoint:
    combo: dict[str, str]        # stage -> cfg name
    area: float
    power: float
    alloc_bits: int
    pareto: bool = False


def sweep(dag: PipelineDAG, w: int, options: Sequence[MemConfig],
          max_points: int = 4096, frame_h: int = 0,
          rows_per_step: int = 1) -> list[DsePoint]:
    """Exhaustive (area, power) sweep over the cartesian product —
    the paper's Fig. 10 axes, kept for the plotting example. Forwards
    ``frame_h``/``rows_per_step`` to the post-PR-3 compile signature so
    temporal pipelines sweep like spatial ones."""
    owners = buffer_owners(dag)
    combos = itertools.product(options, repeat=len(owners))
    points: list[DsePoint] = []
    for i, choice in enumerate(combos):
        if i >= max_points:
            break
        cfg_of = dict(zip(owners, choice))
        try:
            plan = compile_pipeline(dag, w, mem_cfg=cfg_of,
                                    rows_per_step=rows_per_step,
                                    frame_h=frame_h)
        except ValueError:
            continue  # infeasible under this memory mix
        points.append(DsePoint(
            combo={p: c.name for p, c in cfg_of.items()},
            area=plan.area, power=plan.power,
            alloc_bits=plan.total_alloc_bits))
    mark_pareto(points)
    return points


def mark_pareto(points: list[DsePoint]) -> None:
    for p in points:
        p.pareto = not any(
            (q.area <= p.area and q.power <= p.power and
             (q.area < p.area or q.power < p.power))
            for q in points)
