"""Hopper kernels of the port: the fused line-buffered stencil pipeline
(spatial, temporal, any prefetch depth), the decode of unorm8 frames,
the single-stage conv stencil and sliding-window decode attention."""
from . import conv2d_stencil, ops, ref, stencil_pipeline, swa_decode, unorm8
from .ops import conv2d, fused_pipeline, swa_decode as swa_decode_op
from .stencil_pipeline import (StencilExecutor, VideoExecutor, make_executor,
                               make_video_executor)

__all__ = ["StencilExecutor", "VideoExecutor", "conv2d", "conv2d_stencil",
           "fused_pipeline", "make_executor", "make_video_executor", "ops",
           "ref", "stencil_pipeline", "swa_decode", "swa_decode_op",
           "unorm8"]
