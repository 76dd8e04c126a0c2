"""Line-buffer sizing and memory-block allocation (paper Sec. 2, 5, 7).

Maps a solved :class:`Schedule` plus per-stage memory configurations onto
physical memory blocks, reporting allocated bits (including internal
fragmentation — the FPGA BRAM / fixed-size ASIC macro reality), logical
bits, block counts, per-cycle access counts (feeding the power model) and
register (DFF) counts for the stencil windows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from .dag import PipelineDAG
from .ilp import Schedule


@dataclasses.dataclass(frozen=True)
class MemConfig:
    """One memory implementation option for a line buffer.

    ``block_bits`` is the *capacity* of one memory block. ``sized=True``
    models the ASIC backend (paper Sec. 7: OpenRAM compiles macros up to
    64 Kbit, sized to content — allocated bits == content bits);
    ``sized=False`` models fixed-size blocks (FPGA BRAMs — internal
    fragmentation is real and counted). ``coalesce`` packs up to
    min(ports, capacity) lines per block (paper Sec. 6).
    """
    name: str
    ports: int
    block_bits: int
    coalesce: bool = False
    sized: bool = False
    pixel_bits: int = 32
    pack_cap: int = 0      # optional cap on the coalescing factor (0 = none)

    def words_per_block(self) -> int:
        return self.block_bits // self.pixel_bits

    def pack_factor(self, w: int) -> int:
        """Lines coalesced per block (wide-word packing, paper Sec. 6).

        C lines are stacked in the *word* dimension: address j holds the
        C pixels (l..l+C-1, j), so one access serves a whole column chunk
        of the stencil window (this is why coalescing is "fundamentally
        incompatible with the FIFO-based approach" — FIFO streaming moves
        single-line words). C is bounded by block capacity; ``pack_cap``
        optionally reproduces the paper's K = min(P, SH) split.
        """
        if not self.coalesce:
            return 1
        cap = self.words_per_block() // w
        if self.pack_cap:
            cap = min(cap, self.pack_cap)
        return max(1, cap)


# Standard configurations used in the evaluation (paper Sec. 7/8.5).
# Pixel width 32b; fixed-size blocks: FPGA BRAM 36Kbit, ASIC macro 64Kbit.
# At 320p (W=480: 15Kbit/line) a 64Kbit macro coalesces 4 lines and a BRAM
# 2; at 1080p (W=1920: 60Kbit/line) neither holds >1 line — matching the
# paper's "coalescing applies to 320p but not 1080p" setup.
FPGA_BRAM_BITS = 36 * 1024
ASIC_SRAM_BITS = 64 * 1024

DP = MemConfig("DP", ports=2, block_bits=ASIC_SRAM_BITS)
SP = MemConfig("SP", ports=1, block_bits=ASIC_SRAM_BITS)
DPLC = MemConfig("DPLC", ports=2, block_bits=ASIC_SRAM_BITS, coalesce=True)
# Quad-port option for the autotuner (dse.py): with P=4 no evaluation
# pipeline has more accessors than ports, so every port OR-group vanishes
# and line counts drop to the pure causality minimum — bought with the
# quadratic area and leakage cost of the extra ports (power.py). The
# paper's evaluation stops at DP; QP exists to give the design-space
# search a schedule-freedom-vs-power axis, not to model a specific SRAM.
QP = MemConfig("QP", ports=4, block_bits=ASIC_SRAM_BITS)
FPGA_DP = MemConfig("DP", ports=2, block_bits=FPGA_BRAM_BITS)
FPGA_SP = MemConfig("SP", ports=1, block_bits=FPGA_BRAM_BITS)
FPGA_DPLC = MemConfig("DPLC", ports=2, block_bits=FPGA_BRAM_BITS,
                      coalesce=True)
# Sized (OpenRAM-compiled, content-sized) variants for the ASIC DSE sweep
# (Fig. 10): DPLC arrays are bigger per block -> higher per-access energy,
# fewer arrays -> lower leakage/area; the algorithm-specific trade-off.
DP_SIZED = MemConfig("DP", ports=2, block_bits=ASIC_SRAM_BITS, sized=True)
DPLC_SIZED = MemConfig("DPLC", ports=2, block_bits=ASIC_SRAM_BITS,
                       coalesce=True, sized=True)


@dataclasses.dataclass
class BufferAlloc:
    """Physical allocation of one stage's line buffer."""
    owner: str
    cfg: MemConfig
    n_lines: int            # logical lines (Eq. 2)
    n_lines_phys: int       # rounded up to a multiple of the pack factor
    pack: int               # lines per block (C)
    n_blocks: int
    bits_per_block: int
    alloc_bits: int
    logical_bits: int
    reads_per_cycle: float  # steady-state block reads (wide words count 1)
    writes_per_cycle: float  # 1 while producer active
    window_regs: int        # DFF count for consumer shift-register arrays

    @property
    def accesses_per_cycle(self) -> float:
        return self.reads_per_cycle + self.writes_per_cycle


@dataclasses.dataclass
class Allocation:
    dag_name: str
    w: int
    buffers: dict[str, BufferAlloc]
    fifo_mode: bool = False   # SODA-style: every block serves 2 acc/cycle

    @property
    def total_alloc_bits(self) -> int:
        return sum(b.alloc_bits for b in self.buffers.values())

    @property
    def total_logical_bits(self) -> int:
        return sum(b.logical_bits for b in self.buffers.values())

    @property
    def total_blocks(self) -> int:
        return sum(b.n_blocks for b in self.buffers.values())

    @property
    def total_regs(self) -> int:
        return sum(b.window_regs for b in self.buffers.values())


def allocate(dag: PipelineDAG, sched: Schedule,
             cfg_of: Mapping[str, MemConfig], w: int,
             extra_lines: Mapping[str, int] | None = None) -> Allocation:
    """Map the schedule's line counts onto physical blocks.

    ``extra_lines`` holds per-buffer ring padding added by the
    simulator-guided loop in codegen.py (slot-alias avoidance).
    """
    buffers: dict[str, BufferAlloc] = {}
    for p, n_lines in sched.buffer_lines.items():
        cfg = cfg_of[p]
        pack = cfg.pack_factor(w)
        if extra_lines:
            n_lines = n_lines + extra_lines.get(p, 0)
        n_phys = int(math.ceil(n_lines / pack) * pack)
        wpb = cfg.words_per_block()
        if pack > 1:     # coalesced blocks (pack*W <= wpb holds)
            n_blocks = n_phys // pack
            bits_per_block = (pack * w * cfg.pixel_bits if cfg.sized
                              else cfg.block_bits)
        else:            # one line per block; wide lines split across blocks
            blocks_per_line = max(1, math.ceil(w / wpb))
            n_blocks = n_phys * blocks_per_line
            per_block_words = math.ceil(w / blocks_per_line)
            bits_per_block = (per_block_words * cfg.pixel_bits if cfg.sized
                              else cfg.block_bits)
        sh_of: dict[str, int] = {}
        for e in dag.out_edges(p):
            if not dag.stages[e.consumer].is_output:
                sh_of[e.consumer] = max(sh_of.get(e.consumer, 0), e.sh)
        # merged per consumer (see pruning.py); a sliding sh-line window
        # touches on average (sh-1)/C + 1 wide-word blocks per cycle
        reads = sum((sh - 1) / pack + 1.0 for sh in sh_of.values())
        regs = sum(e.sh * e.sw for e in dag.out_edges(p))
        buffers[p] = BufferAlloc(
            owner=p, cfg=cfg, n_lines=n_lines, n_lines_phys=n_phys, pack=pack,
            n_blocks=n_blocks, bits_per_block=bits_per_block,
            alloc_bits=n_blocks * bits_per_block,
            logical_bits=n_lines * w * cfg.pixel_bits,
            reads_per_cycle=reads, writes_per_cycle=1, window_regs=regs)
    return Allocation(dag_name=dag.name, w=w, buffers=buffers)
