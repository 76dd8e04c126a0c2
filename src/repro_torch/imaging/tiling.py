"""Tiled execution: serve frames larger than the compiled plan.

An ImaGen plan is compiled for one line width W; the hardware it models
physically cannot accept a wider line. Rather than recompiling per frame
size, a large frame is cut into overlapping tiles of the compiled shape
and each tile runs through the (cached, batched) executor.

Halo math: windows are causal (bottom-right aligned, zero padded at the
frame top/left), so output pixel (r, x) depends on input rows
``r-up .. r`` and cols ``x-left .. x`` where ``(up, left)`` is the DAG's
cumulative stencil extent (``PipelineDAG.cumulative_extent``). A tile is
an *input-space* window ``frame[a:a+TH, b:b+TW]`` of the compiled shape
(TH, TW); its output rows ``< a+up`` / cols ``< b+left`` are recomputed
halo and discarded before stitching — except when the tile hugs the frame
top (a == 0) or left (b == 0), where the kernel's own boundary masking IS
the frame boundary condition, so every row/col is exact. The halo is
never synthesized with explicit zero padding: stages like canny's
``sqrt(gx^2+gy^2+eps)`` map zero inputs to nonzero values, so a zero halo
would not reproduce the true frame-boundary semantics.

Successive tiles advance by TH-up rows / TW-left cols (the last origin is
pulled back so the final tile stays full-sized); every tile has the same
shape, so one compiled batched executor serves the entire frame.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dag import PipelineDAG

from .plan_cache import PlanCache


def tile_origins(total: int, tile: int, halo: int) -> list[int]:
    """Input-space tile origins covering [0, total) with stride tile-halo.

    Each tile contributes ``tile - halo`` new output rows (the first tile
    contributes all ``tile``); origins are pulled back at the far edge so
    the last tile keeps the compiled size when ``tile - halo`` does not
    divide the remainder.
    """
    if total <= tile:
        return [0]
    if tile <= halo:
        raise ValueError(f"tile extent {tile} must exceed halo {halo}")
    origins = [0]
    covered = tile
    while covered < total:
        a = min(covered - halo, total - tile)
        origins.append(a)
        covered = a + tile
    return origins


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tiling of an (h, w) frame into (tile_h, tile_w) input tiles."""
    h: int
    w: int
    tile_h: int
    tile_w: int
    halo_up: int
    halo_left: int
    row_origins: tuple[int, ...]
    col_origins: tuple[int, ...]

    @property
    def n_tiles(self) -> int:
        return len(self.row_origins) * len(self.col_origins)

    def valid_region(self, a: int, b: int) -> tuple[int, int, int, int]:
        """(r_lo, r_hi, c_lo, c_hi) of exact output within tile (a, b)."""
        r_lo = a if a == 0 else a + self.halo_up
        c_lo = b if b == 0 else b + self.halo_left
        return r_lo, a + self.tile_h, c_lo, b + self.tile_w


def plan_tile_grid(dag: PipelineDAG, h: int, w: int,
                   tile_h: int, tile_w: int) -> TileGrid:
    up, left = dag.cumulative_extent()
    th, tw = min(tile_h, h), min(tile_w, w)
    return TileGrid(h=h, w=w, tile_h=th, tile_w=tw,
                    halo_up=up, halo_left=left,
                    row_origins=tuple(tile_origins(h, th, up)),
                    col_origins=tuple(tile_origins(w, tw, left)))


def rows_per_step_for_tile(tile_h: int, preferred: int = 8) -> int:
    """Row-group factor for a tile: ``preferred`` capped by the tile
    height — a 5-row tile cannot block 8 rows."""
    return max(1, min(preferred, tile_h))


def execute_tiled(cache: PlanCache, name: str, images: dict,
                  tile_h: int, tile_w: int,
                  batch: int = 8,
                  rows_per_step: int | None = None,
                  tune: bool = False,
                  prefetch_depth: int = 1) -> torch.Tensor:
    """Run pipeline ``name`` over a frame of any size via tiling.

    ``images`` holds full-resolution (H, W) inputs; tiles are assembled
    into batches of up to ``batch`` and executed through the cache's
    batched executor. Assembly, execution and stitching all stay on the
    cache's device: the only host transfer is whatever the caller does
    with the returned (H, W) tensor — one per frame, not one per tile
    batch. A trailing partial batch runs through a tail-sized executor
    (cached like any other) instead of being padded with dead-weight zero
    tiles.

    ``rows_per_step`` defaults from the tile shape
    (:func:`rows_per_step_for_tile`); ``tune=True`` serves tiles through
    the cache's autotuned memory config (tiles share one compiled width,
    so one search covers the whole frame). Returns the (H, W) output.
    """
    dag = cache.dag_for(name)
    first = next(iter(images.values()))
    h, w = first.shape
    grid = plan_tile_grid(dag, h, w, tile_h, tile_w)
    th, tw = grid.tile_h, grid.tile_w
    if rows_per_step is None:
        rows_per_step = rows_per_step_for_tile(th)

    frames = {n: torch.as_tensor(img, dtype=torch.float32,
                                 device=cache.device)
              for n, img in images.items()}
    coords = [(a, b) for a in grid.row_origins for b in grid.col_origins]
    out = torch.zeros((h, w), dtype=torch.float32, device=cache.device)
    for i in range(0, len(coords), batch):
        chunk = coords[i:i + batch]
        tiles = {n: torch.stack([f[a:a + th, b:b + tw] for (a, b) in chunk])
                 for n, f in frames.items()}
        ex = cache.executor_for(name, th, tw, batch=len(chunk),
                                rows_per_step=rows_per_step, tune=tune,
                                prefetch_depth=prefetch_depth)
        res = ex(tiles)
        for j, (a, b) in enumerate(chunk):
            r_lo, r_hi, c_lo, c_hi = grid.valid_region(a, b)
            out[r_lo:r_hi, c_lo:c_hi] = res[j, r_lo - a:, c_lo - b:]
    return out
