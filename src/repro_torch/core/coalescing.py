"""Line-coalescing optimization (paper Sec. 6, Algorithm 1).

Coalescing packs C lines into one memory block *in the word dimension*:
address j of a block holds the C pixels (l .. l+C-1, j). One access then
serves a whole column chunk of a stencil window — the paper's virtual
stages K2_1/K2_2 of Fig. 7 are exactly the per-block chunks of K2's
window. Consequences:

  * a reader with stencil height sh touches ceil(sh/C) (+1 at group
    boundaries) blocks per cycle, ONE access each (unit load);
  * the port constraint moves from per-line to per-block granularity with
    unit loads: at most P *accessors* may touch a block per cycle —
    structurally identical to the (P+1)-combination construction of
    Sec. 5.3, but separations need a (C-1)-line wider margin so two access
    sets can never meet inside one C-line block regardless of ring
    alignment;
  * a FIFO implementation is impossible (data would have to migrate
    between word lanes) — the paper's "fundamentally incompatible with
    the FIFO-based approach" remark;
  * the physical ring is rounded up to a multiple of C so the
    line -> slot -> block mapping preserves the margins.

The rewrite is static — it depends only on the DAG, stencil heights and C
(paper: "this transformation can be done offline").
"""
from __future__ import annotations

import itertools

from .contention import PairConstraint
from .dag import PipelineDAG
from .linebuffer import MemConfig
from .pruning import (OrGroup, PortConstraintProblem, _leq, buffer_accessors,
                      prune_group)


def _coalesced_candidates(dag: PipelineDAG, combo, c: int) -> list[PairConstraint]:
    out: list[PairConstraint] = []
    for x, y in itertools.permutations(combo, 2):
        if x.key == y.key or x.stage == y.stage:
            continue
        if _leq(dag, y.stage, x.stage) and y.stage != x.stage:
            continue  # y strictly upstream: cannot be the 'late' accessor
        out.append(PairConstraint(early=x.stage, late=y.stage,
                                  lines=y.sh + c - 1))
    uniq = {(p.early, p.late, p.lines): p for p in out}
    return list(uniq.values())


def coalesced_port_constraints(dag: PipelineDAG, w: int, producer: str,
                               cfg: MemConfig,
                               var_of: dict[str, str] | None = None,
                               prune: bool = True) -> PortConstraintProblem:
    """Block-granularity OR-groups for one coalesced buffer (unit loads)."""
    accs = buffer_accessors(dag, producer, var_of)
    P = cfg.ports
    C = cfg.pack_factor(w)
    hard: list[PairConstraint] = []
    groups: list[OrGroup] = []
    infeasible = False
    if len(accs) <= P:
        return PortConstraintProblem(hard=hard, groups=groups)
    for combo in itertools.combinations(accs, P + 1):
        cands = _coalesced_candidates(dag, combo, C)
        if prune:
            cands = prune_group(dag, cands)
        if not cands:
            infeasible = True
            groups.append(OrGroup(buffer=producer,
                                  members=tuple(a.key for a in combo),
                                  candidates=[]))
        elif len(cands) == 1:
            hard.append(cands[0])
        else:
            groups.append(OrGroup(buffer=producer,
                                  members=tuple(a.key for a in combo),
                                  candidates=cands))
    return PortConstraintProblem(hard=hard, groups=groups, infeasible=infeasible)
