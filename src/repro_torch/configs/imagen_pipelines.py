"""The paper's own workloads as selectable configs (Tbl. 3 + Sec. 7)."""
from repro_torch.core import algorithms
from repro_torch.core.linebuffer import (DP, DPLC, FPGA_DP, FPGA_DPLC,
                                         FPGA_SP, SP, MemConfig)

PIPELINES = dict(algorithms.ALGORITHMS)
# Temporal (multi-frame) pipelines: same compiler, one axis up — frame
# rings instead of (well, alongside) line buffers. Kept separate from
# PIPELINES so single-frame sweeps (DSE, paper tables) stay single-frame.
VIDEO_PIPELINES = dict(algorithms.VIDEO_ALGORITHMS)
RESOLUTIONS = dict(algorithms.RESOLUTIONS)
MEMORIES = {"DP": DP, "SP": SP, "DPLC": DPLC,
            "FPGA_DP": FPGA_DP, "FPGA_SP": FPGA_SP, "FPGA_DPLC": FPGA_DPLC}
