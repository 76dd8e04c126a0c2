"""Predicted-side performance model: cycles/frame and bytes moved.

Everything here is derived from artifacts the compiler already produced —
the ILP :class:`~repro_torch.core.ilp.Schedule` (stage start cycles,
buffer line counts), the :class:`~repro_torch.core.linebuffer.Allocation`
(per-buffer block layout and steady-state access rates), and the analytic
power model (:func:`repro_torch.core.power.power_breakdown`). Nothing is
measured: ``predict(plan, h)`` is a pure function of the compiled plan,
so the prediction is reproducible across machines and can be
regression-gated exactly (see :mod:`repro_torch.perf.ledger`).

This is the paper's model of the *generated accelerator* (one pixel per
cycle, ``S_out + h*w``), not a model of the GPU, and it is a copy of the
JAX package's: ``predict(plan, h).to_dict()`` equals the reference's
field for field. The card enters only on the measured side
(:mod:`repro_torch.perf.measure`).

Accounting conventions (the measured side in :mod:`measure` mirrors
them so the join in :mod:`attribution` compares like with like):

  * **cycles/frame** — the accelerator retires one output pixel per
    cycle in steady state (paper Sec. 5: all stages advance in raster
    lockstep), so compute costs ``S_out + h*w`` cycles: the
    pipeline-fill latency (the output stage's scheduled start cycle,
    which the ILP minimizes indirectly through buffer occupancy) plus
    one cycle per pixel. Off-chip traffic costs
    ``hbm_bytes / DMA_BYTES_PER_CYCLE`` DMA cycles on top. At
    ``prefetch_depth == 1`` (synchronous streaming) the DMA serializes
    with compute — cycles/frame is the *sum*; at depth >= 2 the
    prefetch rings overlap the two engines, so cycles/frame is
    ``fill + max(steady, dma)`` — the roofline ``max`` the push-memory
    compilers build for.
  * **HBM bytes/frame** — off-chip traffic: every input frame is read
    once, the output written once, each temporal history tap streams one
    full frame in, and each temporal producer writes one frame of ring
    state back (4 bytes/px float32, the executors' only dtype).
  * **SRAM bytes/frame** — on-chip line-buffer traffic: each buffer
    serves ``accesses_per_cycle`` block accesses per cycle (writer +
    per-consumer-line reads, wide coalesced words counting once — the
    same rate the power model bills), times ``h*w`` cycles, times 4
    bytes per access word.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.codegen import (PipelinePlan, probe_height,
                                      temporal_taps)
from repro_torch.core.contention import port_slack
from repro_torch.core.power import power_breakdown

BYTES_PER_PX = 4  # float32 — the only dtype the executors stream today

# The modeled accelerator's off-chip interface width: 4 px/cycle against
# its 1 px/cycle compute retire rate (a property of the generated design,
# not of any device the executors run on). A single-stream (input +
# output) pipeline is then safely compute-bound (0.5 px of traffic per
# px-cycle), while tap-heavy temporal pipelines and multi-input stacks
# cross into DMA-bound — the split the dse depth axis keys off.
DMA_BYTES_PER_CYCLE = 16


def exact_fractions(parts: dict[str, float]) -> dict[str, float]:
    """Normalize ``parts`` into fractions that sum to exactly 1.0.

    Floating normalization (``v / total``) leaves the sum a few ULP off
    1.0; the attribution report promises the fractions are a *partition*
    (tests assert ``math.fsum(...) == 1.0`` bitwise), so the largest
    component absorbs the residual: it is set to ``1 - sum(others)``.
    That subtraction rounds twice (the others' sum, then the
    difference), which leaves ``math.fsum`` of the result one ULP off
    1.0 for about 3% of inputs; there, and only there, the residual is
    taken in one correctly rounded step (``fsum`` of 1 and the negated
    others), so the promise always holds and the result equals the JAX
    package's wherever the JAX package's keeps it. Negative parts are
    invalid (a fraction is a share of a nonnegative total); an empty or
    all-zero input returns ``{}``.
    """
    if any(v < 0 for v in parts.values()):
        raise ValueError(f"negative component in fractions: {parts}")
    total = math.fsum(parts.values())
    if not parts or total <= 0:
        return {}
    out = {k: v / total for k, v in parts.items()}
    largest = max(out, key=lambda k: out[k])
    others = [v for k, v in out.items() if k != largest]
    out[largest] = 1.0 - math.fsum(others)
    if math.fsum(out.values()) != 1.0:
        out[largest] = math.fsum([1.0] + [-v for v in others])
    return out


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Analytic prediction for one (plan, frame height) pair."""
    pipeline: str
    w: int
    h: int
    # --- cycles ---
    fill_cycles: int               # output stage start S_out (pipeline fill)
    steady_cycles_per_frame: int   # h*w at 1 px/cycle (compute)
    dma_cycles_per_frame: int      # hbm bytes / DMA_BYTES_PER_CYCLE
    prefetch_depth: int            # overlap depth the plan was compiled at
    bound: str                     # "dma" | "compute" (ties -> dma)
    # fill + steady + dma at depth 1 (serialized);
    # fill + max(steady, dma) at depth >= 2 (overlapped)
    cycles_per_frame: int
    # --- traffic (bytes/frame) ---
    hbm_bytes_per_frame: int
    sram_bytes_per_frame: int
    bytes_per_frame: int           # hbm + sram
    traffic_fractions: dict[str, float]   # {"hbm", "sram"} — sums to 1
    sram_fractions: dict[str, float]      # per line buffer — sums to 1
    # --- contention / power (model artifacts carried for the report) ---
    port_slack: int                # min spare ports across buffers
    power_total: float
    power_fractions: dict[str, float]     # per buffer — sums to 1
    vmem_ring_bytes: int
    alloc_bits: int

    def predicted_fps(self, clock_hz: float) -> float:
        """Frames/sec the model predicts at an assumed clock."""
        return clock_hz / self.cycles_per_frame

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _hbm_bytes(plan: PipelinePlan, h: int) -> int:
    """Off-chip bytes per frame under the streaming executor's contract."""
    dag = plan.dag
    px = h * plan.w * BYTES_PER_PX
    n_inputs = len(dag.input_stages())
    n_outputs = len(dag.output_stages())
    taps = temporal_taps(dag)                    # history frames streamed in
    inputs_set = set(dag.input_stages())
    # internal temporal producers round-trip their frame through HBM so
    # the ring can be rolled (kernels/stencil_pipeline.py extra outputs);
    # input producers' rings roll from the input frame already counted
    internal_ring_writes = sum(1 for p in plan.frame_depths
                               if p not in inputs_set)
    return px * (n_inputs + n_outputs + len(taps) + internal_ring_writes)


def _sram_bytes(plan: PipelinePlan, h: int) -> tuple[int, dict[str, int]]:
    """(total, per-buffer) line-buffer bytes touched per frame."""
    cycles = h * plan.w
    per: dict[str, int] = {}
    for p, b in plan.alloc.buffers.items():
        per[p] = int(round(b.accesses_per_cycle * cycles)) * BYTES_PER_PX
    return sum(per.values()), per


def predict(plan: PipelinePlan, h: int) -> PerfModel:
    """Analytic performance prediction for ``plan`` at frame height ``h``.

    Pure function of the compiled plan: the schedule fixes the fill
    latency, the allocation fixes per-buffer access rates, the power
    model fixes the energy split, and the cycle-accurate simulator
    (probed at the same height compile_pipeline validated at) fixes the
    port-slack margin. ``h`` only scales the per-frame totals.
    """
    if h < 1:
        raise ValueError(f"frame height must be >= 1, got {h}")
    dag = plan.dag
    out_stage = dag.output_stages()[0]
    fill = int(plan.schedule.starts[out_stage])
    steady = h * plan.w
    hbm = _hbm_bytes(plan, h)
    sram, sram_per = _sram_bytes(plan, h)
    dma = -(-hbm // DMA_BYTES_PER_CYCLE)
    # ties classify as dma-bound, matching measure.classify
    bound = "dma" if dma >= steady else "compute"
    if plan.prefetch_depth >= 2:
        cycles = fill + max(steady, dma)     # DMA hides behind compute
    else:
        cycles = fill + steady + dma         # synchronous: they serialize

    rep = plan.verify(probe_height(dag, plan.alloc))
    slack = port_slack(rep.peak_block_accesses,
                       {p: plan.mem_cfg[p].ports
                        for p in rep.peak_block_accesses})

    pb = power_breakdown(plan.alloc)
    power_total = sum(b["total"] for b in pb.values())
    return PerfModel(
        pipeline=dag.name, w=plan.w, h=h,
        fill_cycles=fill, steady_cycles_per_frame=steady,
        dma_cycles_per_frame=dma, prefetch_depth=plan.prefetch_depth,
        bound=bound,
        cycles_per_frame=cycles,
        hbm_bytes_per_frame=hbm, sram_bytes_per_frame=sram,
        bytes_per_frame=hbm + sram,
        traffic_fractions=exact_fractions({"hbm": float(hbm),
                                           "sram": float(sram)}),
        sram_fractions=exact_fractions(
            {p: float(v) for p, v in sram_per.items()}),
        port_slack=slack,
        power_total=power_total,
        power_fractions=exact_fractions(
            {p: b["total"] for p, b in pb.items()}),
        vmem_ring_bytes=plan.vmem_ring_bytes,
        alloc_bits=plan.total_alloc_bits,
    )
