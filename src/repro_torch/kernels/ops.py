"""Public wrappers for the port's kernels.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from repro_torch._device import resolve_device
from repro_torch.core.codegen import PipelinePlan
from repro_torch.core.dag import PipelineDAG

from .stencil_pipeline import (StencilExecutor, _resolve_depth,
                               _resolve_rows, make_executor)

__all__ = ["fused_pipeline", "pipeline_smem_bytes"]

# sentinel fingerprint for plan-less builds: keys must never collide with
# a real plan's sha256 hex digest (which is lowercase hex, no colons)
_NO_PLAN = "no-plan"


@dataclasses.dataclass
class _KernelCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0


class _KernelCache:
    """Bounded LRU memo of fused-kernel executors.

    Keyed on the **plan fingerprint** — not ``plan is not None`` — so two
    plans at the same (pipeline, h, w, R) that differ anywhere that
    matters (mem config, schedule, ...) build distinct executors; the
    fingerprint covers the full canonical plan dict. Least-recently-used
    entries are evicted past ``max_entries``, with hit/miss/eviction
    counters for tests and telemetry.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        self.stats = _KernelCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def get_or_build(self, key: tuple, build):
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.stats.misses += 1
        entry = build()
        self._entries[key] = entry
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return entry

    def clear(self) -> None:
        self._entries.clear()
        self.stats = _KernelCacheStats()


_PIPE_CACHE = _KernelCache()


def _pipe_key(dag: PipelineDAG, h: int, w: int, plan: PipelinePlan | None,
              device: torch.device, rows_per_step: int | None,
              prefetch_depth: int | None) -> tuple:
    """Executor identity: shape + device + the resolved execution-
    granularity knobs + the plan's content fingerprint."""
    return (dag.name, h, w,
            plan.fingerprint() if plan is not None else _NO_PLAN,
            str(device),
            _resolve_rows(rows_per_step, plan),
            _resolve_depth(prefetch_depth, plan))


def _executor(dag, h, w, plan, rows_per_step, prefetch_depth,
              device) -> StencilExecutor:
    dev = resolve_device(device)
    key = _pipe_key(dag, h, w, plan, dev, rows_per_step, prefetch_depth)
    return _PIPE_CACHE.get_or_build(
        key, lambda: make_executor(dag, h, w, plan=plan,
                                   rows_per_step=rows_per_step,
                                   prefetch_depth=prefetch_depth,
                                   device=dev))


def fused_pipeline(dag: PipelineDAG, images: dict,
                   plan: PipelinePlan | None = None,
                   rows_per_step: int | None = None,
                   prefetch_depth: int | None = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Run a whole pipeline DAG over one (h, w) frame as one fused
    line-buffered kernel launch.

    ``rows_per_step`` is the row-group blocking factor and
    ``prefetch_depth`` the overlap depth (None defers to the plan's
    fields; 1 when no plan)."""
    h, w = next(iter(images.values())).shape
    ex = _executor(dag, h, w, plan, rows_per_step, prefetch_depth, device)
    return ex(images)


def pipeline_smem_bytes(dag: PipelineDAG, h: int, w: int,
                        plan: PipelinePlan | None = None,
                        rows_per_step: int | None = None,
                        prefetch_depth: int | None = None,
                        device: str | torch.device = "cuda") -> int:
    """Shared memory per CTA of the kernel ``fused_pipeline`` launches."""
    return _executor(dag, h, w, plan, rows_per_step, prefetch_depth,
                     device).smem_bytes
