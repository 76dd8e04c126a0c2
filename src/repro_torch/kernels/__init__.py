"""Hopper kernels of the port: the fused line-buffered stencil pipeline,
spatial and temporal."""
from . import ops, ref, stencil_pipeline
from .ops import fused_pipeline
from .stencil_pipeline import (StencilExecutor, VideoExecutor, make_executor,
                               make_video_executor)

__all__ = ["StencilExecutor", "VideoExecutor", "fused_pipeline",
           "make_executor", "make_video_executor", "ops", "ref",
           "stencil_pipeline"]
