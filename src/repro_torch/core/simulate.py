"""Cycle-accurate line-buffered pipeline simulator (paper Sec. 7, 8.1).

Plays a solved schedule against a W x H frame and verifies the three
no-stall requirements of Sec. 5.1 at *physical block* granularity:

  R1 (causality)  — a pixel is read only after it was written;
  R2 (no off-chip) — a ring slot is overwritten only after its last read;
  R3 (ports)      — accesses to any physical block at any cycle <= P.

Physical semantics (floor, not the paper's ceil — see contention.py note):
at cycle t >= S, an accessor sweeps column (t - S) mod W of lines
[L, L+sh-1] with L = (t - S) // W; a writer writes line L. Lines map to
ring slots l mod n_phys; coalescing packs `pack` consecutive slots per
physical block.

This slot-granular check exposes a corner the paper's logical-line model
misses: a ring of n slots aliases line l with line l+n, so the oldest
consumer's reads share a *block* with the writer (and any reader tracking
the writer) for (delay mod W) cycles per line — 3 accesses on one block
even though no logical line ever sees more than 2. codegen.py closes the
gap by padding the ring (extra slots) until this simulator is clean; the
schedule itself never changes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from .dag import PipelineDAG
from .ilp import Schedule
from .linebuffer import Allocation, MemConfig


@dataclasses.dataclass
class SimReport:
    ok: bool
    violations: list[str]
    bad_buffers: dict[str, int]           # buffer -> worst per-block count
    latency_cycles: int                   # cycle of last output pixel + 1
    output_start: int
    throughput: float                     # output px/cycle once started
    peak_block_accesses: dict[str, int]
    accesses_per_cycle: dict[str, float]  # steady-state mean (power xcheck)


def _block_counts(w: int, h: int, n_phys: int, pack: int,
                  accessors: list[tuple[int, int]],
                  t_lo: int, t_hi: int) -> np.ndarray:
    """Per-cycle per-block access counts for one buffer: (T, n_groups).

    With coalescing (pack > 1) blocks hold C lines as wide words, so an
    accessor contributes *one* access per block it touches per cycle
    (unit load), however many of the block's lines fall in its window.
    """
    T = t_hi - t_lo
    n_groups = max(1, math.ceil(n_phys / pack))
    counts = np.zeros((T, n_groups), dtype=np.int16)
    t = np.arange(t_lo, t_hi)
    touched = np.zeros((T, n_groups), dtype=bool)
    for (s, sh) in accessors:
        active = (t >= s) & (t < s + w * h)
        if not active.any():
            continue
        base = (t - s) // w
        touched[:] = False
        for k in range(sh):
            line = base + k
            ok = active & (line >= 0) & (line < h)
            grp = (line[ok] % n_phys) // pack
            touched[np.nonzero(ok)[0], grp] = True
        counts += touched.astype(np.int16)
    return counts


def _buffer_check(w: int, h: int, n_phys: int, pack: int, ports: int,
                  s_p: int, readers: list[tuple[int, int, str]],
                  owner: str) -> tuple[list[str], int, float]:
    """Vectorized R3 check for one buffer. Returns (violations, peak, mean)."""
    accessors = [(s_p, 1)] + [(s, sh) for (s, sh, _) in readers]
    max_sh = max(sh for _, sh in accessors)
    t_lo = min(s for s, _ in accessors)
    span = min(w * h, 3 * w * (max_sh + n_phys) + 4 * w)
    t_hi = max(s for s, _ in accessors) + span
    counts = _block_counts(w, h, n_phys, pack, accessors, t_lo, t_hi)
    peak = int(counts.max()) if counts.size else 0
    mean = float(counts.sum() / max((counts.sum(axis=1) > 0).sum(), 1))
    violations = []
    if peak > ports:
        bad_t, bad_g = np.nonzero(counts > ports)
        i = 0
        violations.append(
            f"{owner}: R3 violated at t={int(bad_t[i]) + t_lo}: "
            f"{int(counts[bad_t[i], bad_g[i]])} accesses > P={ports} "
            f"on block {int(bad_g[i])} ({len(bad_t)} offending cycles)")
    return violations, peak, mean


@dataclasses.dataclass
class BufferSamples:
    """Per-cycle samples of one buffer — the memtrace plane's raw feed.

    ``occupancy`` is the live-line (or live-row, for frame rings) count
    per cycle; ``accesses`` the worst per-block access count per cycle;
    ``conflicts`` marks cycles whose accesses exceed the ports (always
    all-False for a plan that passed :func:`simulate` — nonzero only
    when probing deliberately under-provisioned configs). ``capacity``
    is the physical allocation in the same unit as ``occupancy``, so
    ``capacity - occupancy.max()`` is the allocation-vs-peak waste.
    """
    owner: str
    kind: str                  # "line_buffer" | "frame_ring"
    unit: str                  # "lines" | "rows"
    t0: int                    # cycle index of samples[0]
    occupancy: np.ndarray      # (T,) int32
    accesses: np.ndarray       # (T,) int16
    conflicts: np.ndarray      # (T,) bool
    capacity: int
    ports: int
    pack: int

    @property
    def peak_occupancy(self) -> int:
        return int(self.occupancy.max()) if self.occupancy.size else 0

    @property
    def peak_accesses(self) -> int:
        return int(self.accesses.max()) if self.accesses.size else 0

    @property
    def conflict_cycles(self) -> int:
        return int(self.conflicts.sum())


def _resolve_buffer(p: str, n_lines: int, alloc, cfg_of, w: int):
    """(n_phys, pack, ports) for buffer p — the same resolution order
    simulate() uses, factored out so sampling and checking agree."""
    cfg = cfg_of[p] if cfg_of else None
    pack = cfg.pack_factor(w) if (cfg and cfg.coalesce) else 1
    ports = cfg.ports if cfg else 2
    if alloc is not None and p in alloc.buffers:
        return (alloc.buffers[p].n_lines_phys, alloc.buffers[p].pack,
                alloc.buffers[p].cfg.ports)
    return int(math.ceil(n_lines / pack) * pack), pack, ports


def sample_buffers(dag: PipelineDAG, sched: Schedule, w: int, h: int,
                   alloc: Allocation | None = None,
                   cfg_of: Mapping[str, MemConfig] | None = None,
                   t_hi: int | None = None
                   ) -> dict[str, BufferSamples]:
    """Play the schedule and record per-cycle buffer state (memtrace).

    The observability counterpart of :func:`simulate`: instead of
    checking the R1–R3 invariants, it *samples* them — line-buffer fill
    level (vectorized form of :func:`repro.core.contention.
    buffer_occupancy`), worst per-block port accesses, and over-port
    conflict cycles, for every cycle of one frame. Temporal producers
    additionally get a ``frame_ring`` track: history rows resident plus
    the current frame's write progress.

    ``t_hi`` caps the sampled window (default: the frame's full latency,
    ``max start + w*h``). Downsampling for artifacts happens in
    :mod:`repro.obs.memtrace`, not here — this returns exact per-cycle
    arrays.
    """
    if t_hi is None:
        t_hi = max(sched.starts.values()) + w * h
    t = np.arange(0, t_hi)
    out: dict[str, BufferSamples] = {}
    for p, n_lines in sched.buffer_lines.items():
        n_phys, pack, ports = _resolve_buffer(p, n_lines, alloc, cfg_of, w)
        s_p = sched.starts[p]
        sh_of: dict[str, int] = {}
        for e in dag.out_edges(p):
            if dag.stages[e.consumer].is_output:
                continue
            sh_of[e.consumer] = max(sh_of.get(e.consumer, 0), e.sh)
        readers = [(sched.starts[c], sh) for c, sh in sorted(sh_of.items())]
        if not readers:
            continue
        written = np.clip((t - s_p) // w + 1, 0, h)
        retired = np.min(np.stack(
            [np.clip((t - s_c - 1) // w + 1, 0, h)
             for (s_c, _) in readers]), axis=0)
        occupancy = np.maximum(written - retired, 0).astype(np.int32)
        accessors = [(s_p, 1)] + readers
        counts = _block_counts(w, h, n_phys, pack, accessors, 0, t_hi)
        accesses = counts.max(axis=1).astype(np.int16)
        out[p] = BufferSamples(
            owner=p, kind="line_buffer", unit="lines", t0=0,
            occupancy=occupancy, accesses=accesses,
            conflicts=accesses > ports, capacity=n_phys,
            ports=ports, pack=pack)
    # frame rings: temporal producers keep (depth-1) full history frames
    # device-resident; the track shows that base plus the current frame's
    # write ramp, in rows
    for p, depth in dag.temporal_depths().items():
        if depth <= 1:
            continue
        s_p = sched.starts[p]
        written = np.clip((t - s_p) // w + 1, 0, h)
        occupancy = ((depth - 1) * h + written).astype(np.int32)
        out[f"{p}@ring"] = BufferSamples(
            owner=p, kind="frame_ring", unit="rows", t0=0,
            occupancy=occupancy, accesses=np.zeros(t_hi, np.int16),
            conflicts=np.zeros(t_hi, bool), capacity=depth * h,
            ports=0, pack=1)
    return out


def simulate(dag: PipelineDAG, sched: Schedule, w: int, h: int,
             alloc: Allocation | None = None,
             cfg_of: Mapping[str, MemConfig] | None = None) -> SimReport:
    violations: list[str] = []
    bad: dict[str, int] = {}
    peak: dict[str, int] = {}
    mean_acc: dict[str, float] = {}

    for p, n_lines in sched.buffer_lines.items():
        n_phys, pack, ports = _resolve_buffer(p, n_lines, alloc, cfg_of, w)
        s_p = sched.starts[p]
        sh_of: dict[str, int] = {}
        for e in dag.out_edges(p):
            if dag.stages[e.consumer].is_output:
                continue
            sh_of[e.consumer] = max(sh_of.get(e.consumer, 0), e.sh)
        readers = [(sched.starts[c], sh, c) for c, sh in sorted(sh_of.items())]
        if not readers:
            continue

        # --- R2: ring slot never overwritten before its last read --------
        max_delay = max(s_c - s_p for (s_c, _, _) in readers)
        if n_phys * w < max_delay + 1:
            violations.append(
                f"{p}: R2 ring too small: {n_phys} lines * W={w} "
                f"<= max consumer delay {max_delay}")
            bad[p] = max(bad.get(p, 0), 99)

        # --- R1: causality -------------------------------------------------
        for (s_c, sh, cname) in readers:
            if s_c - s_p < (sh - 1) * w + 1:
                violations.append(
                    f"{p}->{cname}: R1 violated: delay {s_c - s_p} < "
                    f"{(sh - 1) * w + 1}")

        # --- R3: per-block port bound (vectorized) -------------------------
        v, pk, mean = _buffer_check(w, h, n_phys, pack, ports, s_p, readers, p)
        violations.extend(v)
        if v:
            bad[p] = pk
        peak[p] = pk
        mean_acc[p] = mean

    out = dag.output_stages()[0]
    out_start = sched.starts[out]
    latency = out_start + w * h
    return SimReport(ok=not violations, violations=violations, bad_buffers=bad,
                     latency_cycles=latency, output_start=out_start,
                     throughput=1.0, peak_block_accesses=peak,
                     accesses_per_cycle=mean_acc)
