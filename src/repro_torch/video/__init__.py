"""Temporal pipeline subsystem: frame rings and stream serving.

One axis up from the imaging subsystem: where a line buffer holds the
last few *rows* a spatial stencil needs, a frame ring holds the last few
*frames* a temporal stencil needs — same compiler (core/), same fused
kernel (kernels/stencil_pipeline.py), same plan cache. This package adds
the serving layer for streams:

  * :class:`VideoEngine` — per-stream sessions (frame-ring state, warm-up
    accounting, ordered delivery) multiplexed over shared executors,
    with bounded-FIFO backpressure per stream.
  * re-exports of the executor-side pieces a video caller needs.
"""
from repro_torch.kernels.stencil_pipeline import (VideoExecutor,
                                                  make_video_executor)

from .engine import (CompletedVideoFrame, VideoEngine, VideoFrame,
                     VideoSession)

__all__ = [
    "CompletedVideoFrame", "VideoEngine", "VideoExecutor", "VideoFrame",
    "VideoSession", "make_video_executor",
]
