"""Hopper kernels of the port: the fused line-buffered stencil pipeline."""
from . import ops, ref, stencil_pipeline
from .ops import fused_pipeline
from .stencil_pipeline import StencilExecutor, make_executor

__all__ = ["StencilExecutor", "fused_pipeline", "make_executor", "ops",
           "ref", "stencil_pipeline"]
