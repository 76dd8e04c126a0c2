"""On-chip memory contention model (paper Sec. 5.3).

Access sets and their arithmetization. The set-counting form (Eq. 4/5) is
used by the cycle-accurate oracle; the t-free linear form (Eq. 12) is what
feeds the ILP.

NOTE on the paper's Eq. 12: deriving Eq. 9 -> Eq. 12 via Eq. 11 gives

    ((t - S_i)/W) + 1 + SH_i - 1 <= (t - S_j)/W
      <=>  S_i - S_j >= W * SH_i

i.e. the stencil height of the *later*-starting stage i (whose access set
must sit strictly below stage j's), not SH_j as printed in the paper. Our
tests (tests/test_contention.py) show the printed form admits schedules that
violate the port bound under the set-counting oracle, while this form never
does; we treat it as a typo and implement the derived form.

Terminology used throughout: line indices increase in raster order, so a
stage that started *earlier* is accessing *higher* line indices at any
cycle t. ``PairConstraint(early, late)`` enforces that the access set of
``late`` lies strictly below the access set of ``early`` at all times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Accessor:
    """One accessor of a line buffer: the writer or a consumer edge.

    ``stage``: schedule variable this accessor is tied to (the stage name).
    ``sh``: number of lines touched per cycle (writer: 1; reader: stencil
    height of the edge). ``tag`` distinguishes multiple accessors tied to
    the same stage (virtual stages from line coalescing).
    """
    stage: str
    sh: int
    is_writer: bool = False
    tag: str = ""

    @property
    def key(self) -> str:
        return f"{self.stage}{('#' + self.tag) if self.tag else ''}"


def first_line(s: int, t: int, w: int) -> int:
    """L_{i,t} = ceil((t - S_i) / W), Eq. 3. Valid for t >= s."""
    return -((s - t) // w)  # ceil((t - s)/w) with ints


def access_set(s: int, sh: int, t: int, w: int) -> range:
    """A_{i,t}, Eq. 4 — the lines touched by an accessor at cycle t."""
    l0 = first_line(s, t, w)
    return range(l0, l0 + sh)


@dataclasses.dataclass(frozen=True)
class PairConstraint:
    """Separation between two accessors enforced as a linear constraint:

        S[late] - S[early] >= W * lines

    For plain line-level disjointness (fixed Eq. 12), ``lines`` is the
    access-set height of the later accessor. Line coalescing uses a larger
    margin (sh_late + C - 1) so the two access sets never share a C-line
    memory block (see coalescing.py).
    """
    early: str   # schedule-variable key of the earlier accessor
    late: str    # schedule-variable key of the later accessor
    lines: int   # required separation margin, in image lines

    def rhs(self, w: int) -> int:
        return w * self.lines

    def satisfied(self, schedule: dict[str, int], w: int) -> bool:
        return schedule[self.late] - schedule[self.early] >= self.rhs(w)


def pair_disjoint_oracle(s_early: int, sh_early: int, s_late: int, sh_late: int,
                         w: int, t_max: int) -> bool:
    """Set-counting oracle: are the two access sets disjoint for all t?

    Brute force over cycles — used in tests to validate the arithmetization.
    """
    t0 = max(s_early, s_late)
    for t in range(t0, t_max):
        a = access_set(s_early, sh_early, t, w)
        b = access_set(s_late, sh_late, t, w)
        if set(a) & set(b):
            return False
    return True


def count_line_accesses(accessors: Sequence[tuple[int, Accessor]], t: int,
                        w: int) -> dict[int, int]:
    """B_{l,t} for one line buffer: line -> number of accesses at cycle t.

    ``accessors`` is a list of (start_cycle, Accessor). Accessors that have
    not started yet contribute nothing.
    """
    counts: dict[int, int] = {}
    for s, acc in accessors:
        if t < s:
            continue
        for l in access_set(s, acc.sh, t, w):
            counts[l] = counts.get(l, 0) + 1
    return counts


def max_concurrent_accesses(accessors: Sequence[tuple[int, Accessor]],
                            w: int, t_lo: int, t_hi: int) -> int:
    """max over t, l of B_{l,t} — the oracle the ILP's constraints must bound."""
    worst = 0
    for t in range(t_lo, t_hi):
        c = count_line_accesses(accessors, t, w)
        if c:
            worst = max(worst, max(c.values()))
    return worst


def port_slack(peak_accesses: Mapping[str, int],
               ports_of: Mapping[str, int]) -> int:
    """Minimum spare port headroom across a design's buffers.

    ``peak_accesses`` is per-buffer worst concurrent block accesses (from
    the cycle-accurate simulator or :func:`max_concurrent_accesses`);
    ``ports_of`` the port count of each buffer's memory. Slack 0 means
    some block is saturated every worst-case cycle — the design is valid
    but has no margin for extra accessors; the autotuner (dse.py) reports
    it as the third Pareto axis. A design with no buffers has slack equal
    to its (irrelevant) minimum port count, or 0 when empty.
    """
    slacks = [ports_of[p] - peak for p, peak in peak_accesses.items()]
    return min(slacks, default=0)


def lines_written(s_p: int, t: int, w: int, h: int) -> int:
    """Lines the producer has started writing by cycle t (0..h).

    The writer emits line ``(t - s_p) // w`` at cycle t, so by then it
    has touched lines 0..that — ``(t - s_p) // w + 1`` of them. Scalar
    form; :func:`repro.core.simulate.sample_buffers` vectorizes the same
    expression and is differential-tested against this one.
    """
    return min(max((t - s_p) // w + 1, 0), h)


def lines_retired(s_c: int, t: int, w: int, h: int) -> int:
    """Lines a reader starting at ``s_c`` is *done* with before cycle t.

    Reader access sets use ``first_line = ceil((t - s_c) / W)`` (Eq. 3),
    so line l is last read at cycle ``s_c + l*W`` and is retired on the
    next cycle. Count of retired lines at t: ``(t - s_c - 1) // W + 1``,
    clipped to [0, h].
    """
    return min(max((t - s_c - 1) // w + 1, 0), h)


def buffer_occupancy(s_p: int, reader_starts: Sequence[int], t: int,
                     w: int, h: int) -> int:
    """Live lines resident in a buffer at cycle t (the fill level).

    A line is live from the cycle its writer touches it until every
    reader has moved past it — occupancy is lines written minus lines
    retired by the *slowest* (latest-starting) reader. R2 guarantees
    this never exceeds the physical ring for a valid schedule; the
    memtrace plane samples it per cycle to show fill ramps, steady
    state, and allocation waste.
    """
    if not reader_starts:
        return 0
    return max(lines_written(s_p, t, w, h)
               - min(lines_retired(s_c, t, w, h) for s_c in reader_starts),
               0)


def required_delay(sh_late: int, w: int) -> int:
    """RHS of the fixed Eq. 12 (disjointness margin)."""
    return w * sh_late


def causality_delay(sh: int, w: int) -> int:
    """RHS of Eq. 1b: (SH_c - 1)*W + 1."""
    return (sh - 1) * w + 1


def line_buffer_lines(delays: Sequence[int], w: int) -> int:
    """Eq. 2 in lines: ceil(max_c (S_c - S_p) / W)."""
    d = max(delays)
    return math.ceil(d / w)
