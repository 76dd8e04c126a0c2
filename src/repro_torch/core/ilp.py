"""ILP schedule synthesis (paper Sec. 5.2/5.5).

Variables: start cycle S_i per schedule variable (stages, with ties for
relays/virtual stages) and an integer line count q_p per buffer owner.

    minimize    sum_p q_p * W                                  (exact Eq. 1a)
    subject to  S_c - S_p >= (SH_cp - 1)*W + 1    for each edge (Eq. 1b)
                S_late - S_early >= W * sh_late   per enforced pair (Eq. 12)
                q_p * W >= S_c - S_p              for each consumer c of p
                S_input = 0, all vars integer >= 0

The paper drops the ceiling from the objective and minimizes raw cycle
deltas, arguing argmin f(x) ⊆ argmin f(ceil(x)) per monotone term; with a
*sum* of ceilinged terms that argument is not airtight, so we encode the
ceiling exactly with the integer q_p (still linear). ``objective="paper"``
reproduces the paper's relaxation for comparison; tests show both give the
same line counts on the evaluation pipelines.

OR-groups that survive pruning are branched over (paper Sec. 5.4: "formulate
sub-optimization problems"); each branch is one MILP solved by scipy/HiGHS.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Sequence

import numpy as np

from repro_torch.obs import trace

from .contention import PairConstraint, causality_delay
from .dag import PipelineDAG
from .pruning import PortConstraintProblem, build_port_constraints

try:
    from scipy.optimize import Bounds, LinearConstraint, milp
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

MAX_BRANCHES = 4096


@dataclasses.dataclass
class Schedule:
    """Solved pipeline schedule."""
    dag_name: str
    w: int
    starts: dict[str, int]              # stage -> start cycle
    buffer_lines: dict[str, int]        # buffer owner -> line count
    total_pixels: int                   # LB + frame-ring pixels (Eq. 1a ext.)
    enforced: list[PairConstraint]
    n_branches: int
    solve_ms: float
    objective_mode: str
    # Temporal extension: producers whose consumers read st > 1 frames
    # keep their last st-1 frames in a frame ring — the one-axis-up
    # analogue of a line buffer. Ring size is (st-1) * frame_h * W pixels:
    # schedule-independent (a whole frame of delay per tap, vs. the
    # line buffer's schedule-dependent fraction of a frame), so it enters
    # the objective as a constant — counted, but never steering the ILP.
    frame_depths: dict[str, int] = dataclasses.field(default_factory=dict)
    frame_pixels: int = 0

    def lb_pixels(self, p: str) -> int:
        return self.buffer_lines[p] * self.w


@dataclasses.dataclass
class ScheduleProblem:
    dag: PipelineDAG
    w: int
    ports: dict[str, int]
    var_of: dict[str, str]                      # stage -> schedule variable
    port_problem: PortConstraintProblem
    extra_causality: list[tuple[str, str, int]]  # (early_var, late_var, min_delta)
    frame_h: int = 0                            # frame height for frame-ring
    #                                            pixel accounting (0 = skip)

    @property
    def frame_ring_pixels(self) -> int:
        """Pixels held in frame rings: (st-1) full frames per temporal
        producer (see Schedule.frame_depths). Constant w.r.t. the
        schedule variables — accounted in the objective, not optimized."""
        return sum((d - 1) * self.frame_h * self.w
                   for d in self.dag.temporal_depths().values())

    @property
    def buffer_owners(self) -> list[str]:
        dag = self.dag
        return [p for p in dag.topo_order
                if any(not dag.stages[e.consumer].is_output
                       for e in dag.out_edges(p))]


def schedule_signature(dag: PipelineDAG, w: int, mem_cfg: dict) -> tuple:
    """Schedule-equivalence key of a (dag, width, memory combo) problem.

    Two memory combos yield the *same* constraint problem — hence the
    same optimal schedule — iff every stage agrees on port count and
    effective coalescing pack at width w; ``sized``/``block_bits`` only
    change the downstream allocation, never the solve. The autotuner
    (dse.py) memoizes MILP solves by this key so e.g. DP and DP_SIZED
    cost one solve between them.
    """
    return (dag.name, w, tuple(
        (s, mem_cfg[s].ports,
         mem_cfg[s].pack_factor(w) if mem_cfg[s].coalesce else 1)
        for s in sorted(mem_cfg)))


def build_problem(dag: PipelineDAG, w: int, ports: int | dict[str, int] = 2,
                  var_of: dict[str, str] | None = None,
                  extra_accessors=None, prune: bool = True,
                  mem_cfg: dict | None = None,
                  frame_h: int = 0) -> ScheduleProblem:
    """Assemble the schedule-synthesis problem.

    ``mem_cfg`` (stage -> MemConfig) routes buffers with a coalescing
    config to group-granularity constraints (paper Sec. 6); others use the
    standard per-line (P+1)-combination constraints (Sec. 5.3).

    ``frame_h`` sizes the temporal frame rings ((st-1) full frames per
    temporal producer) into the reported objective. Line-buffer port and
    causality constraints see only the per-frame spatial window (st taps
    of the same (sh, sw) pattern hit the frame store, not the line
    buffer), so temporal edges add no schedule constraints.
    """
    with trace.span("ilp.build_problem", dag=dag.name, w=w):
        return _build_problem(dag, w, ports, var_of, extra_accessors,
                              prune, mem_cfg, frame_h)


def _build_problem(dag, w, ports, var_of, extra_accessors, prune, mem_cfg,
                   frame_h) -> ScheduleProblem:
    var_of = dict(var_of or {})
    if mem_cfg is not None:
        ports = {p: mem_cfg[p].ports for p in dag.stages if p in mem_cfg}
        for p in dag.stages:
            ports.setdefault(p, 2)
    elif isinstance(ports, int):
        ports = {p: ports for p in dag.stages}
    coalesced = frozenset(
        p for p in dag.stages
        if mem_cfg is not None and p in mem_cfg
        and mem_cfg[p].coalesce and mem_cfg[p].pack_factor(w) > 1)
    pp = build_port_constraints(dag, w, ports, var_of=var_of,
                                extra_accessors=extra_accessors, prune=prune,
                                skip_buffers=coalesced)
    if coalesced:
        from .coalescing import coalesced_port_constraints
        for p in sorted(coalesced):
            if dag.stages[p].is_output or not dag.out_edges(p):
                continue
            cp = coalesced_port_constraints(dag, w, p, mem_cfg[p],
                                            var_of=var_of, prune=prune)
            pp.hard.extend(cp.hard)
            pp.groups.extend(cp.groups)
            pp.infeasible = pp.infeasible or cp.infeasible
        # re-dedupe hard constraints and drop satisfied groups
        hard_set = {(c.early, c.late, c.lines) for c in pp.hard}
        pp.hard = [PairConstraint(*k) for k in sorted(hard_set)]
        pp.groups = [g for g in pp.groups
                     if not any((c.early, c.late, c.lines) in hard_set
                                for c in g.candidates)]
    return ScheduleProblem(dag=dag, w=w, ports=ports, var_of=var_of,
                           port_problem=pp, extra_causality=[],
                           frame_h=frame_h)


def _variables(prob: ScheduleProblem) -> list[str]:
    seen: dict[str, None] = {}
    for s in prob.dag.topo_order:
        seen.setdefault(prob.var_of.get(s, s), None)
    return list(seen)


def _solve_one_milp(prob: ScheduleProblem, enforced: Sequence[PairConstraint],
                    objective: str) -> tuple[dict[str, int], dict[str, int], float] | None:
    """Solve one branch. Returns (var starts, buffer lines, objective) or None."""
    dag, w = prob.dag, prob.w
    svars = _variables(prob)
    owners = prob.buffer_owners
    nv, no = len(svars), len(owners)
    sidx = {v: i for i, v in enumerate(svars)}
    oidx = {p: nv + i for i, p in enumerate(owners)}
    n = nv + no

    rows, lbs = [], []

    def ge(coefs: dict[int, float], lo: float) -> None:
        r = np.zeros(n)
        for j, c in coefs.items():
            r[j] += c
        rows.append(r)
        lbs.append(lo)

    var = lambda s: sidx[prob.var_of.get(s, s)]

    for e in dag.edges:  # Eq. 1b
        if var(e.consumer) == var(e.producer):
            continue  # tied (relay mirrors its pattern-mate)
        ge({var(e.consumer): 1.0, var(e.producer): -1.0}, causality_delay(e.sh, w))
    for c in enforced:   # Eq. 12 (fixed)
        ge({sidx[c.late]: 1.0, sidx[c.early]: -1.0}, c.rhs(w))
    for (a, b, d) in prob.extra_causality:
        ge({sidx[b]: 1.0, sidx[a]: -1.0}, d)
    # Aux variable per buffer owner covering every consumer delay:
    #   exact:  q_p lines,  q_p * W >= S_c - S_p + 1
    #   paper:  M_p cycles, M_p     >= S_c - S_p
    # The +1 in exact mode corrects the paper's Eq. 2: when the binding
    # delay is an exact multiple of W, a ring of ceil(delay/W) lines
    # aliases the line being written with the oldest line still being
    # read in the *same physical block*, which the cycle-accurate
    # simulator flags as a port violation (see simulate.py). q_p * W >=
    # delta + 1 yields floor(delta/W)+1 lines — identical to Eq. 2 except
    # at exact multiples, where it adds the required extra line.
    aux_scale = float(w) if objective == "exact" else 1.0
    slack = 1.0 if objective == "exact" else 0.0
    for p in owners:
        for e in dag.out_edges(p):
            if dag.stages[e.consumer].is_output:
                continue
            ge({oidx[p]: aux_scale, var(e.producer): 1.0, var(e.consumer): -1.0},
               slack)

    # anchor inputs at 0 via equality (lb == ub)
    eq_rows, eq_vals = [], []
    for s in dag.input_stages():
        r = np.zeros(n)
        r[var(s)] = 1.0
        eq_rows.append(r)
        eq_vals.append(0.0)

    cost = np.zeros(n)
    for p in owners:
        cost[oidx[p]] = aux_scale  # sum q_p*W  (exact)  or  sum M_p  (paper)

    if not _HAVE_SCIPY:  # pragma: no cover - scipy is available in this env
        raise RuntimeError("scipy required for MILP solve")

    A = np.vstack(rows + eq_rows) if (rows or eq_rows) else np.zeros((0, n))
    lb = np.array(lbs + eq_vals)
    ub = np.array([np.inf] * len(lbs) + eq_vals)
    res = milp(c=cost,
               constraints=LinearConstraint(A, lb, ub),
               integrality=np.ones(n),
               bounds=Bounds(0, np.inf))
    if not res.success:
        return None
    x = np.round(res.x).astype(int)
    starts = {v: int(x[sidx[v]]) for v in svars}
    if objective == "exact":
        lines = {p: int(x[oidx[p]]) for p in owners}
    else:
        lines = {}
        for p in owners:
            deltas = [starts[prob.var_of.get(e.consumer, e.consumer)]
                      - starts[prob.var_of.get(e.producer, e.producer)]
                      for e in dag.out_edges(p)
                      if not dag.stages[e.consumer].is_output]
            # corrected Eq. 2 sizing: floor(delta/W) + 1 (see note above)
            lines[p] = (max(deltas) // w) + 1 if deltas else 0
    obj = float(sum(lines[p] * w for p in owners))
    return starts, lines, obj


def solve_schedule(prob: ScheduleProblem, objective: str = "exact") -> Schedule:
    """Branch over OR-groups, solve each MILP, keep the best."""
    with trace.span("ilp.solve", dag=prob.dag.name, w=prob.w) as sp:
        sched = _solve_schedule(prob, objective)
        sp.set(n_branches=sched.n_branches, solve_ms=sched.solve_ms,
               total_pixels=sched.total_pixels)
        return sched


def _solve_schedule(prob: ScheduleProblem, objective: str) -> Schedule:
    t0 = time.perf_counter()
    pp = prob.port_problem
    if pp.infeasible:
        raise ValueError(f"{prob.dag.name}: port constraints infeasible "
                         f"(a combination admits no disjoint pair)")
    group_choices = [g.candidates for g in pp.groups]
    n_branch_total = 1
    for g in group_choices:
        n_branch_total *= len(g)
    if n_branch_total > MAX_BRANCHES:
        # fall back: greedily pick the first candidate per group (documented
        # approximation; never triggered on the paper's pipelines).
        assignments = [tuple(g[0] for g in group_choices)]
    else:
        assignments = list(itertools.product(*group_choices)) if group_choices else [()]

    best = None
    n_solved = 0
    seen: set[tuple] = set()
    for choice in assignments:
        enforced = list(pp.hard) + list(choice)
        sig = tuple(sorted({(c.early, c.late, c.lines) for c in enforced}))
        if sig in seen:
            continue
        seen.add(sig)
        out = _solve_one_milp(prob, enforced, objective)
        n_solved += 1
        if out is None:
            continue
        starts, lines, obj = out
        if best is None or obj < best[2]:
            best = (starts, lines, obj, enforced)
    if best is None:
        raise ValueError(f"{prob.dag.name}: all {n_solved} branches infeasible")
    starts, lines, obj, enforced = best
    stage_starts = {s: starts[prob.var_of.get(s, s)] for s in prob.dag.topo_order}
    frame_px = prob.frame_ring_pixels
    return Schedule(dag_name=prob.dag.name, w=prob.w, starts=stage_starts,
                    buffer_lines=lines, total_pixels=int(obj) + frame_px,
                    enforced=enforced, n_branches=n_solved,
                    solve_ms=(time.perf_counter() - t0) * 1e3,
                    objective_mode=objective,
                    frame_depths=prob.dag.temporal_depths(),
                    frame_pixels=frame_px)


def brute_force_schedule(prob: ScheduleProblem, s_max: int) -> Schedule | None:
    """Exhaustive reference solver over S_i in [0, s_max] (tests only).

    Checks the *set-counting oracle* directly (not the arithmetized
    constraints), so it validates both the ILP and the Eq. 12 fix.
    """
    from .contention import max_concurrent_accesses
    from .pruning import buffer_accessors

    dag, w = prob.dag, prob.w
    svars = _variables(prob)
    owners = prob.buffer_owners
    inputs = set(dag.input_stages())
    free = [v for v in svars if v not in inputs]
    var = lambda s: prob.var_of.get(s, s)

    best: Schedule | None = None
    for combo in itertools.product(range(s_max + 1), repeat=len(free)):
        starts_v = {v: 0 for v in svars}
        starts_v.update(dict(zip(free, combo)))
        ok = True
        for e in dag.edges:
            if var(e.consumer) == var(e.producer):
                continue
            if starts_v[var(e.consumer)] - starts_v[var(e.producer)] < causality_delay(e.sh, w):
                ok = False
                break
        if not ok:
            continue
        for p in owners:
            accs = buffer_accessors(dag, p, prob.var_of)
            pairs = [(starts_v[a.stage], a) for a in accs]
            t_hi = max(s for s, _ in pairs) + 3 * w * max(a.sh for _, a in pairs) + 2 * w
            if max_concurrent_accesses(pairs, w, 0, t_hi) > prob.ports[p]:
                ok = False
                break
        if not ok:
            continue
        lines = {}
        for p in owners:
            deltas = [starts_v[var(e.consumer)] - starts_v[var(e.producer)]
                      for e in dag.out_edges(p)
                      if not dag.stages[e.consumer].is_output]
            lines[p] = (max(deltas) // w) + 1  # corrected Eq. 2
        # same constant frame-ring term as solve_schedule, so the two
        # solvers' total_pixels stay directly comparable on temporal DAGs
        obj = sum(lines[p] * w for p in owners) + prob.frame_ring_pixels
        if best is None or obj < best.total_pixels:
            best = Schedule(dag_name=dag.name, w=w,
                            starts={s: starts_v[var(s)] for s in dag.topo_order},
                            buffer_lines=lines, total_pixels=int(obj),
                            enforced=[], n_branches=0, solve_ms=0.0,
                            objective_mode="brute",
                            frame_depths=dag.temporal_depths(),
                            frame_pixels=prob.frame_ring_pixels)
    return best
