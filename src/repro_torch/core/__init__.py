"""ImaGen core: ILP-scheduled, contention-free line-buffered pipelines.

    dag  = algorithms.unsharp_m()
    plan = codegen.compile_pipeline(dag, w=480, mem=linebuffer.DP)
    plan.verify(h=320)          # cycle-accurate R1/R2/R3 check
    plan.total_alloc_bits       # Fig. 8a metric
    plan.power                  # Fig. 8b metric
"""
from . import (algorithms, coalescing, codegen, contention, dag, dsl, ilp,
               linebuffer, power, pruning, simulate)
from .codegen import PipelinePlan, compile_pipeline, plan_from_dict
from .dag import Edge, PipelineDAG, Stage
from .dsl import Pipeline
from .ilp import Schedule, build_problem, solve_schedule
from .linebuffer import DP, DPLC, FPGA_DP, FPGA_DPLC, FPGA_SP, QP, SP, \
    MemConfig

__all__ = [
    "algorithms", "coalescing", "codegen", "contention", "dag", "dsl",
    "ilp", "linebuffer", "power", "pruning", "simulate", "PipelinePlan",
    "compile_pipeline", "plan_from_dict", "Edge", "PipelineDAG", "Stage",
    "Pipeline", "Schedule", "build_problem", "solve_schedule",
    "DP", "DPLC", "FPGA_DP", "FPGA_DPLC", "FPGA_SP", "QP", "SP",
    "MemConfig",
]
