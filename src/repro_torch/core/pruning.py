"""Port-constraint construction and pruning (paper Sec. 5.3-5.4).

For every line buffer with accessor set N and port count P, every
(P+1)-combination of accessors forms an OR-group: at least one directed
pair in the combination must have disjoint access sets (Eq. 5 -> Eq. 7).

Pruning theorem (paper Sec. 5.4, restated in our early/late notation and
proved in DESIGN.md Sec. 7): within an OR-group, constraint C(a,b)
[enforce S_b - S_a >= W*sh_b] is implied by C(c,d) whenever

    a <= c,   d <= b,   sh_b <= sh_d

with <= the DAG partial order (reflexive). It is then safe to drop the
stricter C(c,d): any schedule satisfying C(c,d) also satisfies C(a,b), so
keeping only the most relaxed candidates preserves optimality of the OR.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from .contention import Accessor, PairConstraint
from .dag import PipelineDAG


@dataclasses.dataclass
class OrGroup:
    """One (P+1)-combination's OR of candidate pair constraints."""
    buffer: str                       # owning line buffer (producer stage)
    members: tuple[str, ...]          # accessor keys in the combination
    candidates: list[PairConstraint]


@dataclasses.dataclass
class PortConstraintProblem:
    hard: list[PairConstraint]        # OR-groups that collapsed to one choice
    groups: list[OrGroup]             # remaining genuine ORs (branch points)
    infeasible: bool = False          # some group has zero feasible candidates


def or_branch_count(pp: PortConstraintProblem) -> int:
    """Number of MILP branches ``solve_schedule`` would enumerate.

    The product of each OR-group's candidate count (1 when no groups
    survive pruning). The autotuner (dse.py) uses this as a cheap
    pre-solve cost bound: a memory combo whose branch product explodes
    is pruned from the search rather than solved approximately.
    """
    n = 1
    for g in pp.groups:
        n *= max(len(g.candidates), 1)
    return n


def buffer_accessors(dag: PipelineDAG, producer: str,
                     var_of: dict[str, str] | None = None) -> list[Accessor]:
    """Accessors of the line buffer owned by ``producer``.

    ``var_of`` maps stage name -> schedule-variable key; stages tied to the
    same variable (Darkroom relays, coalescing virtual stages) merge — the
    paper's "same pattern acts effectively as one consumer" (Fig. 3).

    Edges from one schedule variable merge into a single accessor with
    sh = max over its edges: all windows of a stage are bottom-aligned at
    the same output pixel, so smaller windows read a *subset* of the
    largest window's lines (the extra values come from the shift-register
    array, not from additional SRAM reads). This is what lets Ours serve
    xcorr-m's 18x1 + 1x1 double read from one buffer at no extra cost.
    """
    var_of = var_of or {}
    accs: list[Accessor] = [Accessor(stage=var_of.get(producer, producer),
                                     sh=1, is_writer=True)]
    sh_of: dict[str, int] = {}
    for e in dag.out_edges(producer):
        var = var_of.get(e.consumer, e.consumer)
        sh_of[var] = max(sh_of.get(var, 0), e.sh)
    for var in sorted(sh_of):
        accs.append(Accessor(stage=var, sh=sh_of[var]))
    return accs


def _leq(dag: PipelineDAG, a: str, b: str) -> bool:
    """Partial order on schedule variables == DAG stage order (vars are stages)."""
    if a == b:
        return True
    if a in dag.stages and b in dag.stages:
        return dag.depends(a, b)
    return False


def candidate_pairs(dag: PipelineDAG, combo: Sequence[Accessor],
                    w: int) -> list[PairConstraint]:
    """Feasible directed disjointness constraints for one (P+1)-combination.

    A direction (early=x, late=y) is infeasible when causality already
    forces S_x > S_y, i.e. when y < x strictly in the partial order.
    Accessors sharing a schedule variable can never be disjoint via a
    constraint between themselves (S_y - S_x = 0 < W*sh).
    """
    out: list[PairConstraint] = []
    for x, y in itertools.permutations(combo, 2):
        if x.key == y.key:
            continue
        if x.stage == y.stage:
            continue  # tied variables: delta is structurally 0
        if _leq(dag, y.stage, x.stage) and y.stage != x.stage:
            continue  # y strictly upstream of x: x cannot be 'early'
        out.append(PairConstraint(early=x.stage, late=y.stage, lines=y.sh))
    # dedupe
    uniq: dict[tuple, PairConstraint] = {}
    for c in out:
        uniq[(c.early, c.late, c.lines)] = c
    return list(uniq.values())


def prune_group(dag: PipelineDAG, cands: list[PairConstraint]) -> list[PairConstraint]:
    """Drop every candidate that is strictly stricter than another candidate.

    C(a,b) implied-by C(c,d)  iff  a <= c, d <= b, lines_b <= lines_d.
    We drop (c,d) when some distinct (a,b) is implied by it; mutual
    implication (equivalent constraints) keeps the lexicographically first.
    """
    def implied_by(relaxed: PairConstraint, strict: PairConstraint) -> bool:
        return (_leq(dag, relaxed.early, strict.early)
                and _leq(dag, strict.late, relaxed.late)
                and relaxed.lines <= strict.lines)

    keep: list[PairConstraint] = []
    srt = sorted(cands, key=lambda c: (c.early, c.late, c.lines))
    for i, c in enumerate(srt):
        dominated = False
        for j, other in enumerate(srt):
            if i == j:
                continue
            if implied_by(other, c):
                # `c` is stricter than `other` -> drop c, unless they are
                # mutually implied and c comes first lexicographically.
                if implied_by(c, other) and i < j:
                    continue
                dominated = True
                break
        if not dominated:
            keep.append(c)
    return keep


def build_port_constraints(dag: PipelineDAG, w: int, ports: dict[str, int],
                           var_of: dict[str, str] | None = None,
                           extra_accessors: dict[str, list[Accessor]] | None = None,
                           prune: bool = True,
                           skip_buffers: frozenset[str] = frozenset()) -> PortConstraintProblem:
    """Construct (and optionally prune) all port OR-groups of a pipeline.

    ``ports[p]`` is the port count of the memory holding stage p's line
    buffer. ``extra_accessors`` lets the coalescing rewrite add virtual
    readers. Output stages own no line buffer (they stream off-chip).
    ``skip_buffers`` excludes buffers handled at group granularity by the
    coalescing rewrite (their constraints are strictly stronger).
    """
    hard: list[PairConstraint] = []
    groups: list[OrGroup] = []
    infeasible = False
    for p in dag.topo_order:
        if dag.stages[p].is_output or not dag.out_edges(p) or p in skip_buffers:
            continue
        accs = buffer_accessors(dag, p, var_of)
        if extra_accessors and p in extra_accessors:
            accs = extra_accessors[p]
        P = ports[p]
        if len(accs) <= P:
            continue
        for combo in itertools.combinations(accs, P + 1):
            cands = candidate_pairs(dag, combo, w)
            if prune:
                cands = prune_group(dag, cands)
            if not cands:
                infeasible = True
                groups.append(OrGroup(buffer=p,
                                      members=tuple(a.key for a in combo),
                                      candidates=[]))
            elif len(cands) == 1:
                hard.append(cands[0])
            else:
                groups.append(OrGroup(buffer=p,
                                      members=tuple(a.key for a in combo),
                                      candidates=cands))
    # Deduplicate hard constraints; drop groups already satisfied by a hard
    # constraint (a group whose candidate set contains an enforced hard
    # constraint is automatically satisfied).
    hard_set = {(c.early, c.late, c.lines) for c in hard}
    hard = [PairConstraint(*k) for k in sorted(hard_set)]
    live_groups = []
    seen_groups: set[tuple] = set()
    for g in groups:
        if any((c.early, c.late, c.lines) in hard_set for c in g.candidates):
            continue
        sig = tuple(sorted((c.early, c.late, c.lines) for c in g.candidates))
        if sig in seen_groups:
            continue
        seen_groups.add(sig)
        live_groups.append(g)
    return PortConstraintProblem(hard=hard, groups=live_groups,
                                 infeasible=infeasible)
