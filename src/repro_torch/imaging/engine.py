"""FrameEngine: slot-based continuous batching for stencil pipelines.

The engine multiplexes frame requests over compiled-plan executors. The
paper's accelerator compiles once and then streams frames; here the
compiled artifact (plan + the fused kernel's stage table) lives in a
PlanCache and the engine's job is purely scheduling:

  * **admission** — per-pipeline bounded FIFOs; a full queue refuses the
    request (backpressure to the caller) instead of growing without
    bound, and malformed requests raise at ``submit()`` so they can never
    poison an assembled batch.
  * **batch assembly** — each ``step()`` picks the pipeline whose head
    request is oldest, then fills up to ``max_batch`` slots with same-shape
    frames from that queue (FIFO, so per-pipeline completion order equals
    submission order). Partial batches run with zero-filled idle slots —
    the executor is built once at ``max_batch`` and reused.
  * **tiling dispatch** — frames no larger than ``tile_shape`` run through
    the batched executor directly; larger frames go through the tiled
    executor one request at a time (each frame's tiles ride the batched
    kernel, so slots stay full either way).

An executor exception never strands queued work mid-``step``: the batch
comes back as structured :class:`~repro_torch.resilience.FailedFrame`
results. (The resilient mode of the reference engine — screening, rate
limits, deadlines, the fallback ladder — is not ported yet.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import synchronize
from repro_torch.obs import trace
from repro_torch.resilience import FailedFrame, Priority
from repro_torch.serve.scheduling import BoundedFifo, assemble_batch, \
    pad_batch

from .metrics import EngineMetrics
from .plan_cache import PlanCache
from .tiling import execute_tiled, rows_per_step_for_tile


@dataclasses.dataclass
class FrameRequest:
    rid: int
    pipeline: str
    frames: Mapping[str, np.ndarray]      # {input name: (H, W)}
    submitted_at: float = 0.0             # stamped by the engine
    priority: int = Priority.NORMAL       # shed protection class

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(next(iter(self.frames.values())).shape)


@dataclasses.dataclass
class CompletedFrame:
    rid: int
    pipeline: str
    output: torch.Tensor                  # (H, W) on the engine's device
    latency_s: float


class FrameEngine:
    def __init__(self, cache: PlanCache | None = None,
                 max_batch: int = 4, max_pending: int = 64,
                 tile_shape: tuple[int, int] = (128, 128),
                 rows_per_step: int = 8,
                 prefetch_depth: int = 1,
                 registry=None,
                 device: str | torch.device = "cuda"):
        # ``registry``: a shared obs.MetricsRegistry for the serving
        # telemetry plane; default = a private one per engine. A cache
        # constructed here joins the same registry and runs on ``device``
        # (a given cache keeps its own device).
        self.cache = cache if cache is not None else \
            PlanCache(registry=registry, device=device)
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.tile_shape = tile_shape
        # row-group blocking factor for every executor this engine builds;
        # clamped per-batch so frames shorter than R still execute
        self.rows_per_step = rows_per_step
        self.prefetch_depth = prefetch_depth
        self._queues: dict[str, BoundedFifo] = {}
        self.metrics = EngineMetrics(registry=registry,
                                     prefix="frame_engine")
        # live queue depth for the telemetry plane: spans only show work
        # that *ran*; the collector needs the standing backlog as a gauge
        self._pending_gauge = self.metrics.registry.gauge(
            "frame_engine_pending_frames",
            help="frames admitted but not yet served")

    @property
    def device(self) -> torch.device:
        return self.cache.device

    # ------------------------------------------------------------ admission
    def submit(self, req: FrameRequest) -> bool:
        """Enqueue a request. False means the engine is saturated (retry
        after draining a step — the backpressure contract); malformed
        requests raise here, at admission."""
        dag = self.cache.dag_for(req.pipeline)
        if dag.is_temporal():
            raise ValueError(
                f"request {req.rid}: pipeline {req.pipeline!r} reads frame "
                f"history; the video engine is not ported yet")
        needed = set(dag.input_stages())
        if not needed <= set(req.frames):
            raise ValueError(
                f"request {req.rid}: pipeline {req.pipeline!r} needs inputs "
                f"{sorted(needed)}, got {sorted(req.frames)}")
        if len({tuple(np.shape(f)) for f in req.frames.values()}) != 1:
            raise ValueError(f"request {req.rid}: input frames must share "
                             f"one (H, W) shape")
        req.submitted_at = time.perf_counter()
        ok = self._queue_for(req.pipeline).push(req)
        self.metrics.frames_offered += 1
        if ok:
            self.metrics.frames_submitted += 1
        else:
            self.metrics.frames_rejected += 1
        return ok

    def _queue_for(self, pipeline: str) -> BoundedFifo:
        q = self._queues.get(pipeline)
        if q is None:
            q = self._queues[pipeline] = BoundedFifo(self.max_pending)
        return q

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------ execution
    def _execute(self, name: str, reqs: list[FrameRequest],
                 h: int, w: int, tiled: bool, rps: int) -> tuple[list, int]:
        """Run one batch; returns (outputs, smem_bytes). Ends in a device
        synchronise, so the caller's clock measures execution, not
        enqueue."""
        th, tw = self.tile_shape
        dev = self.device
        if tiled:
            with trace.span("engine.execute", pipeline=name, profile=True):
                outs = [execute_tiled(self.cache, name, r.frames, th, tw,
                                      batch=self.max_batch,
                                      rows_per_step=rps,
                                      prefetch_depth=self.prefetch_depth)
                        for r in reqs]
                synchronize(dev)
            return outs, self.cache.smem_bytes()
        ex = self.cache.executor_for(name, h, w, batch=self.max_batch,
                                     rows_per_step=rps,
                                     prefetch_depth=self.prefetch_depth)
        with trace.span("engine.assemble", pipeline=name):
            inputs = {n: torch.stack(pad_batch(
                [torch.as_tensor(r.frames[n], dtype=torch.float32,
                                 device=dev) for r in reqs],
                self.max_batch,
                lambda: torch.zeros((h, w), dtype=torch.float32,
                                    device=dev)))
                for n in self.cache.dag_for(name).input_stages()}
        with trace.span("engine.execute", pipeline=name, profile=True):
            batch_out = ex(inputs)
            synchronize(dev)
        return [batch_out[i] for i in range(len(reqs))], ex.smem_bytes

    # ----------------------------------------------------------------- step
    def step(self) -> list:
        """Assemble and execute one batch. Returns CompletedFrame results,
        or FailedFrame results when the executor raised ([] when idle)."""
        self._pending_gauge.set(self.pending)
        name, reqs = assemble_batch(
            self._queues, self.max_batch,
            age_of=lambda r: r.submitted_at,
            compatible=lambda a, b: a.shape == b.shape)
        if not reqs:
            return []
        # queue wait: how long the batch's oldest frame sat admitted but
        # unserved — the term the executor time can never explain
        queue_wait = time.perf_counter() - min(r.submitted_at for r in reqs)
        self.metrics.observe_queue_wait(queue_wait)
        h, w = reqs[0].shape
        th, tw = self.tile_shape
        tiled = h > th or w > tw
        # the row-group factor that actually executes: clamped by the tile
        # height on the tiled path, by the frame height otherwise
        rps = rows_per_step_for_tile(min(th, h) if tiled else h,
                                     self.rows_per_step)
        results: list = []
        with trace.span("engine.step", engine="frame", pipeline=name,
                        n_frames=len(reqs), tiled=tiled, rows_per_step=rps,
                        queue_wait_s=queue_wait) as sp:
            t0 = time.perf_counter()
            try:
                outs, smem = self._execute(name, reqs, h, w, tiled, rps)
            except Exception as e:  # noqa: BLE001 - structured failure:
                # the batch is already popped; losing the exception here
                # would strand it, raising would strand the *rest* of
                # the queue — so it travels as FailedFrame results
                err = repr(e)
                self.metrics.frames_failed += len(reqs)
                sp.set(failed=len(reqs), error=type(e).__name__)
                now = time.perf_counter()
                return [FailedFrame(pipeline=name, error=err, rid=r.rid,
                                    latency_s=now - r.submitted_at)
                        for r in reqs]
            dt = time.perf_counter() - t0
            self.metrics.observe_batch(name, len(reqs), self.max_batch, dt,
                                       smem, rows_per_step=rps)
            now = time.perf_counter()
            for r, out in zip(reqs, outs):
                lat = now - r.submitted_at
                self.metrics.observe_latency(lat)
                results.append(CompletedFrame(rid=r.rid, pipeline=name,
                                              output=out, latency_s=lat))
            sp.set(execute_s=dt, delivered=len(reqs))
        return results

    def run(self, requests: list[FrameRequest]) -> dict:
        """Submit everything (respecting backpressure), drain to
        completion. Returns {rid: output} for completed requests and
        {rid: FailedFrame} for failed ones."""
        pending = list(requests)
        results: dict = {}
        while pending or self.pending:
            while pending and self.submit(pending[0]):
                pending.pop(0)
            for c in self.step():
                results[c.rid] = c.output \
                    if isinstance(c, CompletedFrame) else c
        return results

    def snapshot(self) -> dict:
        """Engine + cache telemetry in one dict (the serving plane's
        JSON view; the Prometheus view is metrics.registry)."""
        snap = self.metrics.snapshot()
        snap["pending"] = self.pending
        snap["cache"] = self.cache.snapshot()
        return snap
