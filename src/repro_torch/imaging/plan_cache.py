"""Plan cache: compile once per shape, serve forever (paper's core deal).

An ImaGen accelerator is compiled for one line width and then streams
frames indefinitely; re-running the ILP scheduler + allocator + stage
table build per frame throws that amortization away. The cache has two
levels, mirroring the two compilation costs:

  * **plan level** — keyed by ``(pipeline name, width, mem-config combo,
    rows_per_step, prefetch_depth)`` (``PipelinePlan.cache_key``):
    memoizes ``compile_pipeline`` — the ILP solve, ring allocation, and
    simulator validation. The schedule/allocation are independent of the
    row-group factor and the prefetch depth, so a plan differing from a
    resident one only in ``rows_per_step`` and/or ``prefetch_depth`` is
    *derived* (dataclasses.replace) instead of re-solved — the ILP runs
    once per (name, width, mem) no matter how many row-group variants
    are served.
  * **executor level** — keyed by plan key + (height, batch) + device:
    memoizes the kernel's stage table and launch geometry. Height/batch
    are execution-shape parameters the plan itself is independent of,
    so one plan fans out to many executors.

Both levels are LRU-bounded (``max_plans`` / ``max_execs``): shape-
diverse traffic — every distinct width is a new plan, every distinct
height/batch a new executor — must recycle the oldest entry instead of
growing without bound. Evicting a plan also cascades to the executors
built from it (they hold the plan alive and are exactly as stale).
Evictions bump ``stats.plan_evictions`` / ``stats.exec_evictions``.

Both levels report hit/miss/compile-time stats for the serving metrics.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch._device import resolve_device
from repro_torch.core import algorithms
from repro_torch.core.codegen import (PipelinePlan, compile_pipeline,
                                      mem_cfg_key)
from repro_torch.core.dag import PipelineDAG
from repro_torch.core.linebuffer import DP, MemConfig
from repro_torch.kernels.stencil_pipeline import (StencilExecutor,
                                                  make_executor)
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry

_STAT_FIELDS = (
    "plan_hits", "plan_misses", "plan_evictions",
    "exec_hits", "exec_misses", "exec_evictions",
    "plan_compile_s", "exec_compile_s",
)


class CacheStats:
    """Hit/miss/compile-time stats, backed by obs registry counters.

    Attribute reads and writes (``stats.plan_hits += 1``) route to
    counters in ``registry`` so a shared registry exposes the cache
    alongside the engines on one Prometheus endpoint.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 prefix: str = "plan_cache"):
        reg = registry if registry is not None else MetricsRegistry()
        self.__dict__["registry"] = reg
        self.__dict__["_c"] = {f: reg.counter(f"{prefix}_{f}")
                               for f in _STAT_FIELDS}

    def __getattr__(self, name):
        try:
            return self.__dict__["_c"][name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value) -> None:
        c = self.__dict__["_c"].get(name)
        if c is not None:
            c.value = value
        else:
            self.__dict__[name] = value

    def snapshot(self) -> dict:
        return {f: self._c[f].value for f in _STAT_FIELDS}


class PlanCache:
    """Long-lived compiled-artifact store for the frame-serving layer.

    ``pipelines`` maps name -> DAG factory (defaults to the paper's
    Table-3 set). The DAG is built once per name and shared by every plan
    and executor under that name. ``device`` is where every executor the
    cache builds runs: the GPU unless ``device="cpu"``.
    """

    def __init__(self,
                 pipelines: Mapping[str, Callable[[], PipelineDAG]] | None = None,
                 mem: MemConfig | Mapping[str, MemConfig] = DP,
                 device: str | torch.device = "cuda",
                 max_plans: int = 256,
                 max_execs: int = 256,
                 registry: MetricsRegistry | None = None):
        if max_plans < 1 or max_execs < 1:
            raise ValueError(f"max_plans/max_execs must be >= 1, got "
                             f"{max_plans}/{max_execs}")
        self.device = resolve_device(device)
        self._factories = dict(pipelines if pipelines is not None
                               else algorithms.ALGORITHMS)
        self._dags: dict[str, PipelineDAG] = {}
        self._plans: OrderedDict[tuple, PipelinePlan] = OrderedDict()
        self._execs: OrderedDict[tuple, StencilExecutor] = OrderedDict()
        self.default_mem = mem
        self.max_plans = max_plans
        self.max_execs = max_execs
        self.stats = CacheStats(registry=registry)

    # ------------------------------------------------------------- lookups
    def dag_for(self, name: str) -> PipelineDAG:
        if name not in self._dags:
            if name not in self._factories:
                raise KeyError(f"unknown pipeline {name!r}; have "
                               f"{sorted(self._factories)}")
            self._dags[name] = self._factories[name]()
        return self._dags[name]

    def _evict_lru_plan(self) -> None:
        key, _ = self._plans.popitem(last=False)
        self.stats.plan_evictions += 1
        # executors built from this plan identity are equally stale:
        # exec keys embed the plan key's (name, w, mem, R, prefetch_depth)
        stale = [k for k in self._execs if k[:5] == key[:5]]
        for k in stale:
            del self._execs[k]
        self.stats.exec_evictions += len(stale)

    def plan_for(self, name: str, w: int,
                 mem: MemConfig | Mapping[str, MemConfig] | None = None,
                 rows_per_step: int = 1,
                 prefetch_depth: int = 1) -> PipelinePlan:
        mem = self.default_mem if mem is None else mem
        mkey = mem_cfg_key(mem)
        key = (name, w, mkey, rows_per_step, prefetch_depth)
        if key in self._plans:
            self.stats.plan_hits += 1
            self._plans.move_to_end(key)
            return self._plans[key]
        self.stats.plan_misses += 1
        # the ILP/allocation do not depend on the row group or the
        # prefetch depth: derive from a sibling plan (any resident
        # rows_per_step/prefetch_depth) instead of re-solving
        sibling = next((p for (n2, w2, m2, _r, _d), p in self._plans.items()
                        if (n2, w2, m2) == (name, w, mkey)), None)
        t0 = time.perf_counter()
        with trace.span("cache.plan", pipeline=name, w=w,
                        rows_per_step=rows_per_step,
                        prefetch_depth=prefetch_depth, hit=False,
                        derived=sibling is not None):
            if sibling is not None:
                plan = dataclasses.replace(sibling,
                                           rows_per_step=rows_per_step,
                                           prefetch_depth=prefetch_depth)
            else:
                plan = compile_pipeline(self.dag_for(name), w, mem=mem,
                                        rows_per_step=rows_per_step,
                                        prefetch_depth=prefetch_depth)
        self.stats.plan_compile_s += time.perf_counter() - t0
        while len(self._plans) >= self.max_plans:
            self._evict_lru_plan()
        self._plans[key] = plan
        return plan

    def executor_for(self, name: str, h: int, w: int,
                     batch: int | None = None,
                     mem: MemConfig | Mapping[str, MemConfig] | None = None,
                     rows_per_step: int = 1,
                     prefetch_depth: int = 1) -> StencilExecutor:
        mem = self.default_mem if mem is None else mem
        # leading 5 fields == plan cache_key, so plan eviction can find us
        key = (name, w, mem_cfg_key(mem), rows_per_step, prefetch_depth,
               h, batch, str(self.device))
        if key in self._execs:
            self.stats.exec_hits += 1
            self._execs.move_to_end(key)
            return self._execs[key]
        plan = self.plan_for(name, w, mem=mem, rows_per_step=rows_per_step,
                             prefetch_depth=prefetch_depth)
        self.stats.exec_misses += 1
        t0 = time.perf_counter()
        with trace.span("cache.exec", pipeline=name, h=h, w=w, batch=batch,
                        hit=False):
            ex = make_executor(self.dag_for(name), h, w, batch=batch,
                               plan=plan, device=self.device)
        self.stats.exec_compile_s += time.perf_counter() - t0
        while len(self._execs) >= self.max_execs:
            self._execs.popitem(last=False)
            self.stats.exec_evictions += 1
        self._execs[key] = ex
        return ex

    def evict_executors(self) -> int:
        """Drop every resident executor (plans stay). Returns the number
        of executors evicted."""
        n = len(self._execs)
        self._execs.clear()
        self.stats.exec_evictions += n
        return n

    # ----------------------------------------------------------- accounting
    def smem_bytes(self) -> int:
        """High-water per-CTA shared memory across resident executors."""
        return max((e.smem_bytes for e in self._execs.values()), default=0)

    def snapshot(self) -> dict:
        """One-call cache telemetry: hit/miss/eviction counters merged
        with per-level residency and the resident executors' shared-
        memory bill."""
        return {
            **self.stats.snapshot(),
            "plans_resident": len(self._plans),
            "execs_resident": len(self._execs),
            "max_plans": self.max_plans,
            "max_execs": self.max_execs,
            "smem_bytes": self.smem_bytes(),
        }

    def __len__(self) -> int:
        return len(self._plans)
