"""Analytic on-chip memory power/area model (paper Sec. 7).

The paper estimates per-access SRAM energy with OpenRAM + FreePDK45 and
combines it with simulated access counts. Neither tool is available here,
so we use a documented analytic surrogate with the same structure:

  * dynamic energy per access  E_acc(bits, ports) = E0 * sqrt(bits/REF_BITS)
        * (1 + PORT_E * (ports-1))
    (bitline/wordline energy grows ~sqrt(capacity) for square arrays;
     extra ports add wire/diffusion capacitance)
  * leakage+clock power per cycle  P_leak(bits, ports) = L0 * (bits/REF_BITS)
        * leak_factor(ports),  leak_factor(P) = (6 + 2(P-1))/6
    (leakage scales with the cell transistor count: 6T single-port vs
     8T dual-port cells)
  * area(bits, ports) = bits * area_factor(ports),
        area_factor(P) = (P^2 + 3) / 4   -> 1.0 for SP, 1.75 for DP
    (SRAM area grows quadratically with port count, paper Sec. 3.1 [37];
     the constant is normalized so a single-port block has factor 1)

Calibration: the paper measures that a BRAM serving 2 accesses/cycle burns
~35% more power than one serving 1 access/cycle (Sec. 3.1). At REF_BITS
and 2 ports:  L + 2E = 1.35 (L + E)  =>  E = 0.538 L. We anchor L0 = 1 and
back out E0. All results are therefore *relative* (arbitrary units) — the
benchmarks compare percentage savings against the paper's percentages.

Known deviation (documented in EXPERIMENTS.md): with this model SODA's
single-consumer designs (fewer, smaller FIFO blocks) score *better* power
than ours, while the paper reports SODA 56% worse overall; the paper's
FIFO penalty evidently exceeds our 2-accesses-per-block-per-cycle model.
The multi-consumer pipelines (split/replicated FIFOs) do reproduce the
paper's ordering.
"""
from __future__ import annotations

import math

from .linebuffer import Allocation

REF_BITS = 36 * 1024
PORT_E = 0.15    # per-extra-port dynamic energy overhead
L0 = 1.0
# Per-array periphery (decoder, sense amps, control): a fixed cost per
# SRAM macro, expressed as the equivalent of PERIPH_FRAC of a REF_BITS
# array. This is what makes coalescing (fewer, bigger arrays) an *area*
# win even when total bits are unchanged (paper Sec. 8.5).
PERIPH_FRAC = 0.30


def leak_factor(ports: int) -> float:
    return (6 + 2 * (ports - 1)) / 6.0


# calibrate E0 so (L + 2E) = 1.35 (L + E) at REF_BITS, ports=2
_L_REF = L0 * (1.0 + PERIPH_FRAC) * leak_factor(2)
_E_REF = 0.35 / (2.0 - 1.35) * _L_REF          # E at REF_BITS, 2 ports
E0 = _E_REF / (1.0 + PORT_E)                    # strip the port factor


def area_factor(ports: int) -> float:
    return (ports ** 2 + 3) / 4.0


def e_acc(bits: int, ports: int) -> float:
    return E0 * math.sqrt(max(bits, 1) / REF_BITS) * (1 + PORT_E * (ports - 1))


def p_leak(bits: int, ports: int) -> float:
    return (L0 * (bits / REF_BITS + PERIPH_FRAC) * leak_factor(ports))


def area(bits: int, ports: int) -> float:
    """Relative area of one block (cell array + periphery)."""
    return (bits + PERIPH_FRAC * REF_BITS) * area_factor(ports)


def power_breakdown(alloc: Allocation) -> dict[str, dict[str, float]]:
    """Per-buffer {leakage, dynamic, total} power (arbitrary units).

    The itemized form of :func:`memory_power` — the autotuner reports it
    per candidate so a scoring change is attributable to a specific
    buffer's leakage or access energy, and the golden-model tests pin it
    so any recalibration of the analytic surrogate is visible in review.
    """
    out: dict[str, dict[str, float]] = {}
    for p, b in alloc.buffers.items():
        ports = b.cfg.ports
        leak = b.n_blocks * p_leak(b.bits_per_block, ports)
        if alloc.fifo_mode:
            accesses = 2.0 * b.n_blocks
        else:
            accesses = float(b.accesses_per_cycle)
        dyn = accesses * e_acc(b.bits_per_block, ports)
        out[p] = {"leakage": leak, "dynamic": dyn, "total": leak + dyn}
    return out


def memory_power(alloc: Allocation) -> float:
    """Average memory power per cycle (arbitrary units) in steady state.

    Each line-level access is one block access. SODA-style FIFO mode
    forces 2 accesses to every block every cycle (the FIFO's push+pop),
    which is exactly the behavior the paper identifies as power-hungry.
    """
    return sum(b["total"] for b in power_breakdown(alloc).values())


def memory_area(alloc: Allocation) -> float:
    return sum(b.n_blocks * area(b.bits_per_block, b.cfg.ports)
               for b in alloc.buffers.values())
