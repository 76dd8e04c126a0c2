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
  * **executor level** — keyed by plan key + (kind, height, batch or
    chunk) + device: memoizes the kernel's stage table and launch
    geometry. Height/batch are execution-shape parameters the plan
    itself is independent of, so one plan fans out to many executors.
    Video executors (frame-ring streaming, see
    ``kernels.make_video_executor``) share this level under the
    ``"video"`` kind leg.

Both levels are LRU-bounded (``max_plans`` / ``max_execs``): shape-
diverse traffic — every distinct width is a new plan, every distinct
height/batch a new executor — must recycle the oldest entry instead of
growing without bound. Evicting a plan also cascades to the executors
built from it (they hold the plan alive and are exactly as stale).
Evictions bump ``stats.plan_evictions`` / ``stats.exec_evictions``.

Both levels report hit/miss/compile-time stats for the serving metrics.

A third memo sits above both: the **autotune level** — keyed by
``(pipeline, width)`` — runs the design-space search (core.dse.autotune)
once and pins the winning per-stage memory combo. ``tune=True`` on
``plan_for`` / ``executor_for`` / ``video_executor_for`` resolves the
memory spec through it, so one search serves every row-group sibling,
height, batch, and chunk variant; the winner's already-compiled plan is
seeded into the plan level so tuning never pays the ILP twice.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch._device import resolve_device
from repro_torch.core import algorithms, dse
from repro_torch.core.codegen import (PipelinePlan, compile_pipeline,
                                      mem_cfg_key)
from repro_torch.core.dag import PipelineDAG
from repro_torch.core.linebuffer import DP, MemConfig
from repro_torch.kernels.stencil_pipeline import (StencilExecutor,
                                                  VideoExecutor,
                                                  make_executor,
                                                  make_video_executor)
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry

_STAT_FIELDS = (
    "plan_hits", "plan_misses", "plan_evictions",
    "exec_hits", "exec_misses", "exec_evictions",
    "plan_compile_s", "exec_compile_s",
    "tunes",                    # autotune searches run (one per (name, w))
    "tune_s",
    "compile_retries",          # compile attempts re-run under the policy
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
    Table-3 set plus the temporal video pipelines). The DAG is built
    once per name and shared by every plan and executor under that name.
    ``device`` is where every executor the cache builds runs: the GPU
    unless ``device="cpu"``.
    """

    def __init__(self,
                 pipelines: Mapping[str, Callable[[], PipelineDAG]] | None = None,
                 mem: MemConfig | Mapping[str, MemConfig] = DP,
                 device: str | torch.device = "cuda",
                 max_plans: int = 256,
                 max_execs: int = 256,
                 tune_options: tuple[MemConfig, ...] = dse.TUNE_OPTIONS,
                 tune_max_candidates: int = 128,
                 registry: MetricsRegistry | None = None,
                 retry=None):
        if max_plans < 1 or max_execs < 1:
            raise ValueError(f"max_plans/max_execs must be >= 1, got "
                             f"{max_plans}/{max_execs}")
        self.device = resolve_device(device)
        self._factories = dict(pipelines if pipelines is not None
                               else {**algorithms.ALGORITHMS,
                                     **algorithms.VIDEO_ALGORITHMS})
        self._dags: dict[str, PipelineDAG] = {}
        self._plans: OrderedDict[tuple, PipelinePlan] = OrderedDict()
        self._execs: OrderedDict[tuple, StencilExecutor | VideoExecutor] = \
            OrderedDict()
        # autotune memo: (name, w) -> TuningResult, LRU-bounded like the
        # plan level; every R-sibling plan and executor variant derives
        # from the same winner
        self._tunings: OrderedDict[tuple, dse.TuningResult] = OrderedDict()
        self.tune_options = tune_options
        self.tune_max_candidates = tune_max_candidates
        self.default_mem = mem
        self.max_plans = max_plans
        self.max_execs = max_execs
        self.stats = CacheStats(registry=registry)
        # resilience wiring, all optional:
        #   ``retry`` — a repro_torch.resilience.RetryPolicy; every real
        #     compile (ILP solve, executor build) runs under it, so
        #     transient failures get bounded jittered-backoff retries
        #     before surfacing to the engine's fallback ladder.
        #   ``compile_hook(label)`` — fault-injection seam, called at
        #     the top of each real compile *inside* the retry boundary
        #     (the chaos harness raises here to prove retries work).
        #   ``executor_wrapper(ex)`` — applied to every executor handed
        #     out, hit or miss (the chaos harness wraps calls to inject
        #     executor exceptions without touching the cached object).
        self.retry = retry
        self.compile_hook = None
        self.executor_wrapper = None

    def _compile(self, fn: Callable, label: str):
        """Run one compile step under the retry policy + chaos seam."""
        def attempt():
            if self.compile_hook is not None:
                self.compile_hook(label)
            return fn()
        if self.retry is None:
            return attempt()

        def on_retry(attempt_no, delay, exc):
            self.stats.compile_retries += 1
        return self.retry.call(attempt, on_retry=on_retry)

    def _wrap(self, ex):
        return ex if self.executor_wrapper is None \
            else self.executor_wrapper(ex)

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

    # ------------------------------------------------------------ autotune
    def tuning_for(self, name: str, w: int,
                   rows_per_step: int = 1) -> dse.TuningResult:
        """Memoized design-space search for (pipeline, width).

        The search runs at the first caller's ``rows_per_step``; the
        winning memory combo is reused for every row-group variant (the
        schedule/allocation are R-independent, see plan_for). The
        winner's compiled plan is seeded into the plan level so the
        first tuned plan_for is a hit, not a re-solve.
        """
        key = (name, w)
        if key in self._tunings:
            self._tunings.move_to_end(key)
            return self._tunings[key]
        t0 = time.perf_counter()
        with trace.span("cache.tune", pipeline=name, w=w, hit=False):
            res = dse.autotune(self.dag_for(name), w,
                               options=self.tune_options,
                               default=self.default_mem,
                               rows_per_step=rows_per_step,
                               max_candidates=self.tune_max_candidates)
        self.stats.tunes += 1
        self.stats.tune_s += time.perf_counter() - t0
        while len(self._tunings) >= self.max_plans:
            self._tunings.popitem(last=False)
        self._tunings[key] = res
        pkey = res.best.plan.cache_key
        if pkey not in self._plans:
            while len(self._plans) >= self.max_plans:
                self._evict_lru_plan()
            self._plans[pkey] = res.best.plan
        return res

    def tuned_mem_for(self, name: str, w: int,
                      rows_per_step: int = 1) -> dict[str, MemConfig]:
        return self.tuning_for(name, w, rows_per_step).best.mem_cfg

    def _resolve_mem(self, name: str, w: int, mem, rows_per_step: int,
                     tune: bool):
        if tune:
            if mem is not None:
                raise ValueError("tune=True picks the memory config; "
                                 "pass either mem= or tune=, not both")
            return self.tuned_mem_for(name, w, rows_per_step)
        return self.default_mem if mem is None else mem

    def plan_for(self, name: str, w: int,
                 mem: MemConfig | Mapping[str, MemConfig] | None = None,
                 rows_per_step: int = 1, tune: bool = False,
                 prefetch_depth: int = 1) -> PipelinePlan:
        mem = self._resolve_mem(name, w, mem, rows_per_step, tune)
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
                plan = self._compile(
                    lambda: compile_pipeline(self.dag_for(name), w, mem=mem,
                                             rows_per_step=rows_per_step,
                                             prefetch_depth=prefetch_depth),
                    f"plan:{name}:{w}")
        self.stats.plan_compile_s += time.perf_counter() - t0
        while len(self._plans) >= self.max_plans:
            self._evict_lru_plan()
        self._plans[key] = plan
        return plan

    def _cached_executor(self, kind: str, name: str, h: int, w: int,
                         shape_leg: int | None, mem, rows_per_step: int,
                         tune: bool, prefetch_depth: int, build):
        mem = self._resolve_mem(name, w, mem, rows_per_step, tune)
        # leading 5 fields == plan cache_key, so plan eviction can find us
        key = (name, w, mem_cfg_key(mem), rows_per_step, prefetch_depth,
               kind, h, shape_leg, str(self.device))
        if key in self._execs:
            self.stats.exec_hits += 1
            self._execs.move_to_end(key)
            return self._wrap(self._execs[key])
        plan = self.plan_for(name, w, mem=mem, rows_per_step=rows_per_step,
                             prefetch_depth=prefetch_depth)
        self.stats.exec_misses += 1
        t0 = time.perf_counter()
        with trace.span("cache.exec", pipeline=name, kind=kind, h=h, w=w,
                        batch=shape_leg, hit=False):
            ex = self._compile(
                lambda: build(self.dag_for(name), plan),
                f"{'exec' if kind == 'frame' else 'video_exec'}:"
                f"{name}:{h}x{w}")
        self.stats.exec_compile_s += time.perf_counter() - t0
        while len(self._execs) >= self.max_execs:
            self._execs.popitem(last=False)
            self.stats.exec_evictions += 1
        self._execs[key] = ex
        return self._wrap(ex)

    def executor_for(self, name: str, h: int, w: int,
                     batch: int | None = None,
                     mem: MemConfig | Mapping[str, MemConfig] | None = None,
                     rows_per_step: int = 1, tune: bool = False,
                     prefetch_depth: int = 1) -> StencilExecutor:
        return self._cached_executor(
            "frame", name, h, w, batch, mem, rows_per_step, tune,
            prefetch_depth,
            lambda dag, plan: make_executor(dag, h, w, batch=batch,
                                            plan=plan, device=self.device))

    def video_executor_for(self, name: str, h: int, w: int,
                           chunk: int | None = None,
                           mem: MemConfig | Mapping[str, MemConfig]
                           | None = None,
                           rows_per_step: int = 1, tune: bool = False,
                           prefetch_depth: int = 1) -> VideoExecutor:
        """Streaming (frame-ring) executor — the video analogue of
        :meth:`executor_for`. Also serves spatial DAGs (empty state), so
        the VideoEngine can carry single-frame pipelines as degenerate
        streams. ``tune=True`` resolves the memory combo through the
        memoized autotuner; chunk variants are siblings of the same
        tuned plan."""
        return self._cached_executor(
            "video", name, h, w, chunk, mem, rows_per_step, tune,
            prefetch_depth,
            lambda dag, plan: make_video_executor(dag, h, w, plan=plan,
                                                  chunk=chunk,
                                                  device=self.device))

    def evict_executors(self) -> int:
        """Drop every resident executor (plans and tunings stay). The
        cache-eviction-storm surface: the chaos harness calls this
        mid-serve to prove engines rebuild transparently under load.
        Returns the number of executors evicted."""
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
            "tunings_resident": len(self._tunings),
            "max_plans": self.max_plans,
            "max_execs": self.max_execs,
            "smem_bytes": self.smem_bytes(),
        }

    def __len__(self) -> int:
        return len(self._plans)
