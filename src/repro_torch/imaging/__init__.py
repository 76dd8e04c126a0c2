"""Frame-serving subsystem: compiled ImaGen plans as long-lived artifacts.

The layer between the compiler (core/, kernels/) and the outside world:

  * :class:`PlanCache` — compile once per (pipeline, width, mem combo),
    serve the fused-kernel executor forever after.
  * :func:`execute_tiled` — frames larger than the compiled plan, split
    into overlapping tiles (halo = the DAG's cumulative stencil extent).
  * :class:`FrameEngine` — slot-based continuous batching over frame
    requests, with backpressure and throughput/latency/shared-memory
    metrics.
"""
from .engine import CompletedFrame, FrameEngine, FrameRequest
from .metrics import EngineMetrics
from .plan_cache import CacheStats, PlanCache
from .tiling import (TileGrid, execute_tiled, plan_tile_grid,
                     rows_per_step_for_tile, tile_origins)

__all__ = [
    "CacheStats", "CompletedFrame", "EngineMetrics", "FrameEngine",
    "FrameRequest", "PlanCache", "TileGrid", "execute_tiled",
    "plan_tile_grid", "rows_per_step_for_tile", "tile_origins",
]
