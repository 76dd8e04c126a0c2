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

``autotune=True`` serves every pipeline through the cache's autotuned
memory config (one memoized design-space search per (pipeline, width));
its results name the rung ``"tuned"`` instead of ``"default"``.

**Resilient mode** (``resilience=ResilienceConfig(...)``) threads the
serving control plane through all three:

  * admission *screens* instead of raising — malformed requests (unknown
    pipeline, missing inputs, bad shape/dtype, NaN pixels) come back as
    structured :class:`~repro_torch.resilience.RejectedFrame` results,
    screened on the host before any copy to the device; rate limits
    apply per pipeline, and saturated queues shed their worst resident
    (lowest priority, most deadline-expired) to admit better work;
  * requests carry SLA deadlines on the obs clock; expired work is swept
    out of the queues as ``ShedFrame(reason="deadline")`` at the top of
    each step rather than wasting executor time on a guaranteed miss;
  * execution runs down a fallback ladder — tuned plan → default plan →
    reference — each rung behind a circuit breaker, each attempt under
    the retry policy. The reference rung is the eager PyTorch oracle
    (``kernels.ref.stencil_pipeline_ref``) on the engine's device: the
    kernel's plain version, so its pixels equal the kernel's. Every
    result names its rung, and ``metrics.fallback_frames`` counts the
    frames served off the primary one, so a broken kernel cannot hide
    behind the ladder. A batch that exhausts the ladder is delivered as
    structured :class:`FailedFrame` results.

With ``resilience=None`` (the default) admission keeps its strict
raise-at-submit contract; the structured-failure guarantee for executor
exceptions holds in both modes: an executor exception never strands
queued work mid-``step``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import synchronize
from repro_torch.kernels import ref
from repro_torch.obs import trace
from repro_torch.resilience import (AdmissionController, FailedFrame,
                                    FallbackLadder, Priority, RejectedFrame,
                                    ResilienceConfig, ShedFrame, overdue_s,
                                    pick_shed_victim, screen_frames,
                                    split_expired)
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
    deadline_s: float | None = None       # relative SLA; None = config's
    deadline: float | None = None         # absolute (obs clock), stamped

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(next(iter(self.frames.values())).shape)


@dataclasses.dataclass
class CompletedFrame:
    rid: int
    pipeline: str
    output: torch.Tensor                  # (H, W) on the engine's device
    latency_s: float
    rung: str = "default"                 # ladder rung that served it
    deadline_missed: bool = False


class FrameEngine:
    def __init__(self, cache: PlanCache | None = None,
                 max_batch: int = 4, max_pending: int = 64,
                 tile_shape: tuple[int, int] = (128, 128),
                 rows_per_step: int = 8,
                 prefetch_depth: int = 1,
                 autotune: bool = False,
                 registry=None,
                 resilience: ResilienceConfig | None = None,
                 device: str | torch.device = "cuda"):
        # ``registry``: a shared obs.MetricsRegistry for the serving
        # telemetry plane; default = a private one per engine. A cache
        # constructed here joins the same registry, compiles under the
        # resilience retry policy and runs on ``device`` (a given cache
        # keeps its own device).
        self.cache = cache if cache is not None else \
            PlanCache(registry=registry, device=device,
                      retry=resilience.retry if resilience else None)
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.tile_shape = tile_shape
        # row-group blocking factor for every executor this engine builds;
        # clamped per-batch so frames shorter than R still execute
        self.rows_per_step = rows_per_step
        self.prefetch_depth = prefetch_depth
        # opt-in: serve through the cache's autotuned memory config
        self.autotune = autotune
        self.resilience = resilience
        self._queues: dict[str, BoundedFifo] = {}
        self.metrics = EngineMetrics(registry=registry,
                                     prefix="frame_engine")
        # live queue depth for the telemetry plane: spans only show work
        # that *ran*; the collector needs the standing backlog as a gauge
        self._pending_gauge = self.metrics.registry.gauge(
            "frame_engine_pending_frames",
            help="frames admitted but not yet served")
        # shed outcomes produced at admission time (overload evictions)
        # or by the expiry sweep; flushed into the next step()'s results
        self._shed_outbox: list[ShedFrame] = []
        if resilience is not None:
            self._admission = AdmissionController(
                resilience.rate, resilience.burst, clock=trace.now)
            self._ladder = FallbackLadder(
                retry=resilience.retry,
                failure_threshold=resilience.breaker_failures,
                reset_after_s=resilience.breaker_reset_s,
                on_retry=lambda a, d, e: self.metrics.observe_retry(d))
        else:
            self._admission = None
            self._ladder = None

    @property
    def device(self) -> torch.device:
        return self.cache.device

    # ------------------------------------------------------------ admission
    def submit(self, req: FrameRequest) -> bool | RejectedFrame:
        """Enqueue a request. Strict mode: False means the engine is
        saturated (retry after draining a step — the backpressure
        contract) and malformed requests raise here, at admission, so
        they can never poison an assembled batch. Resilient mode: every
        refusal — malformed, rate-limited, or saturated — returns a
        falsy :class:`RejectedFrame` carrying the reason instead of
        raising mid-loop."""
        if self.resilience is not None:
            return self._submit_resilient(req)
        dag = self.cache.dag_for(req.pipeline)
        if dag.is_temporal():
            raise ValueError(
                f"request {req.rid}: pipeline {req.pipeline!r} reads frame "
                f"history; serve it with the VideoEngine")
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

    def _screen(self, req: FrameRequest) -> RejectedFrame | None:
        try:
            dag = self.cache.dag_for(req.pipeline)
        except KeyError as e:
            return RejectedFrame("unknown_pipeline", pipeline=req.pipeline,
                                 detail=str(e), rid=req.rid)
        if dag.is_temporal():
            return RejectedFrame("temporal_pipeline", pipeline=req.pipeline,
                                 detail="serve it with the VideoEngine",
                                 rid=req.rid)
        defect = screen_frames(req.frames, set(dag.input_stages()))
        if defect is not None:
            reason, detail = defect
            return RejectedFrame(reason, pipeline=req.pipeline,
                                 detail=detail, rid=req.rid)
        return None

    def _reject(self, rej: RejectedFrame) -> RejectedFrame:
        self.metrics.frames_rejected += 1
        with trace.span("resilience.reject", engine="frame",
                        pipeline=rej.pipeline or "?", reason=rej.reason,
                        retryable=rej.retryable):
            pass
        return rej

    def _shed(self, req: FrameRequest, reason: str, now: float) -> None:
        self.metrics.frames_shed += 1
        od = overdue_s(req.deadline, now)
        self._shed_outbox.append(ShedFrame(
            reason=reason, pipeline=req.pipeline,
            priority=int(req.priority), rid=req.rid, deadline=req.deadline,
            overdue_s=od if od > float("-inf") else 0.0))
        with trace.span("resilience.shed", engine="frame",
                        pipeline=req.pipeline, reason=reason,
                        priority=int(req.priority)):
            pass

    def _submit_resilient(self, req: FrameRequest) -> bool | RejectedFrame:
        self.metrics.frames_offered += 1
        rej = self._screen(req)
        if rej is not None:
            return self._reject(rej)
        if not self._admission.allow(req.pipeline):
            return self._reject(RejectedFrame(
                "rate_limited", pipeline=req.pipeline, retryable=True,
                rid=req.rid))
        cfg = self.resilience
        now = trace.now()
        req.submitted_at = time.perf_counter()
        dl = req.deadline_s if req.deadline_s is not None \
            else cfg.default_deadline_s
        req.deadline = (now + dl) if dl is not None else None
        q = self._queue_for(req.pipeline)
        if len(q) >= q.capacity and cfg.shed_on_overload:
            victim = pick_shed_victim(
                q, int(req.priority), now,
                priority_of=lambda r: int(r.priority),
                deadline_of=lambda r: r.deadline,
                age_of=lambda r: r.submitted_at)
            if victim is not None:
                q.remove(victim)
                self._shed(victim, "overload", now)
        if not q.push(req):
            return self._reject(RejectedFrame(
                "saturated", pipeline=req.pipeline, retryable=True,
                rid=req.rid))
        self.metrics.frames_submitted += 1
        return True

    def _sweep_expired(self) -> None:
        """Drop queued work whose deadline already passed — executing it
        would burn capacity on a guaranteed SLA miss."""
        now = trace.now()
        for q in self._queues.values():
            if not q:
                continue
            live, expired = split_expired(q.drain(), now,
                                          lambda r: r.deadline)
            for r in live:
                q.push(r)
            for r in expired:
                self._shed(r, "deadline", now)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------ execution
    def _run_compiled(self, name: str, reqs: list[FrameRequest],
                      h: int, w: int, tiled: bool, rps: int, tune: bool
                      ) -> tuple[list, int]:
        """Run one batch through the fused kernel; returns (outputs,
        smem_bytes). Ends in a device synchronise, so the caller's clock
        measures execution, not enqueue."""
        th, tw = self.tile_shape
        dev = self.device
        if tiled:
            with trace.span("engine.execute", pipeline=name, profile=True):
                outs = [execute_tiled(self.cache, name, r.frames, th, tw,
                                      batch=self.max_batch,
                                      rows_per_step=rps, tune=tune,
                                      prefetch_depth=self.prefetch_depth)
                        for r in reqs]
                synchronize(dev)
            return outs, self.cache.smem_bytes()
        ex = self.cache.executor_for(name, h, w, batch=self.max_batch,
                                     rows_per_step=rps, tune=tune,
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

    def _run_reference(self, name: str,
                       reqs: list[FrameRequest]) -> tuple[list, int]:
        """The ladder's last rung: the eager PyTorch oracle on the
        engine's device. Slow — no line buffers, no fused kernel — but
        it has no plan, no executor, and no cache to fail, so it bounds
        the blast radius of every compiled-path fault at "degraded
        throughput". It is the kernel's plain version, so its pixels
        equal the kernel's."""
        dag = self.cache.dag_for(name)
        dev = self.device
        with trace.span("engine.execute", pipeline=name, reference=True):
            outs = [ref.stencil_pipeline_ref(
                dag, {n: torch.as_tensor(r.frames[n], dtype=torch.float32,
                                         device=dev)
                      for n in dag.input_stages()}) for r in reqs]
            synchronize(dev)
        return outs, 0

    @property
    def _primary_rung(self) -> str:
        return "tuned" if self.autotune else "default"

    def _execute(self, name: str, reqs: list[FrameRequest], h: int, w: int,
                 tiled: bool, rps: int) -> tuple[list, int, str]:
        """Run a batch; returns (outputs, smem_bytes, rung). Resilient
        mode descends the fallback ladder; strict mode runs the primary
        path directly (exceptions propagate to step()'s failure path)."""
        if self.resilience is None:
            outs, smem = self._run_compiled(name, reqs, h, w, tiled, rps,
                                            tune=self.autotune)
            return outs, smem, self._primary_rung
        rungs = []
        if self.autotune:
            rungs.append(("tuned",
                          lambda: self._run_compiled(name, reqs, h, w,
                                                     tiled, rps, True)))
        rungs.append(("default",
                      lambda: self._run_compiled(name, reqs, h, w,
                                                 tiled, rps, False)))
        if self.resilience.reference_fallback:
            rungs.append(("reference",
                          lambda: self._run_reference(name, reqs)))
        (outs, smem), rung = self._ladder.run(name, rungs)
        return outs, smem, rung

    # ----------------------------------------------------------------- step
    def step(self) -> list:
        """Assemble and execute one batch; flushes pending shed/expiry
        outcomes first. Returns a mix of CompletedFrame, ShedFrame, and
        FailedFrame results ([] when idle)."""
        results: list = []
        if self.resilience is not None and self.resilience.shed_expired:
            self._sweep_expired()
        if self._shed_outbox:
            results, self._shed_outbox = self._shed_outbox, []
        self._pending_gauge.set(self.pending)
        name, reqs = assemble_batch(
            self._queues, self.max_batch,
            age_of=lambda r: r.submitted_at,
            compatible=lambda a, b: a.shape == b.shape)
        if not reqs:
            return results
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
        with trace.span("engine.step", engine="frame", pipeline=name,
                        n_frames=len(reqs), tiled=tiled, rows_per_step=rps,
                        queue_wait_s=queue_wait) as sp:
            t0 = time.perf_counter()
            try:
                outs, smem, rung = self._execute(name, reqs, h, w,
                                                 tiled, rps)
            except Exception as e:  # noqa: BLE001 - structured failure:
                # the batch is already popped; losing the exception here
                # would strand it, raising would strand the *rest* of
                # the queue — so it travels as FailedFrame results
                err = repr(e)
                self.metrics.frames_failed += len(reqs)
                sp.set(failed=len(reqs), error=type(e).__name__)
                now = time.perf_counter()
                results.extend(FailedFrame(
                    pipeline=name, error=err, rid=r.rid,
                    latency_s=now - r.submitted_at) for r in reqs)
                return results
            dt = time.perf_counter() - t0
            self.metrics.observe_batch(name, len(reqs), self.max_batch, dt,
                                       smem, rows_per_step=rps)
            if rung != self._primary_rung:
                self.metrics.fallback_frames += len(reqs)
            now = time.perf_counter()
            now_obs = trace.now()
            missed = 0
            for r, out in zip(reqs, outs):
                lat = now - r.submitted_at
                self.metrics.observe_latency(lat)
                late = r.deadline is not None and now_obs > r.deadline
                if late:
                    missed += 1
                    self.metrics.observe_deadline_miss(now_obs - r.deadline)
                results.append(CompletedFrame(
                    rid=r.rid, pipeline=name, output=out, latency_s=lat,
                    rung=rung, deadline_missed=late))
            sp.set(execute_s=dt, rung=rung, delivered=len(reqs),
                   deadline_missed=missed)
        return results

    def run(self, requests: list[FrameRequest]) -> dict:
        """Submit everything (respecting backpressure), drain to
        completion. Returns {rid: output} for completed requests and
        {rid: FailedFrame} for failed ones; in resilient mode, rids that
        ended rejected or shed map to their structured outcome object
        too."""
        pending = list(requests)
        results: dict = {}
        while pending or self.pending:
            progressed = False
            while pending:
                r = self.submit(pending[0])
                if r is True:
                    pending.pop(0)
                    progressed = True
                elif isinstance(r, RejectedFrame) and not r.retryable:
                    results[pending[0].rid] = r      # permanent: drop it
                    pending.pop(0)
                    progressed = True
                else:
                    break          # backpressure/rate limit: drain first
            for c in self.step():
                progressed = True
                if isinstance(c, CompletedFrame):
                    results[c.rid] = c.output
                elif c.rid is not None:
                    results[c.rid] = c
            if not progressed:
                time.sleep(0.001)  # rate-limit window: don't spin hot
        return results

    def snapshot(self) -> dict:
        """Engine + cache telemetry in one dict (the serving plane's
        JSON view; the Prometheus view is metrics.registry)."""
        snap = self.metrics.snapshot()
        snap["pending"] = self.pending
        snap["cache"] = self.cache.snapshot()
        return snap
