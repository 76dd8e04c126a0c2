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

``pixels`` is the format of the frames the engine takes. ``"float32"``
(the default) takes frames of any float or integer type and serves
``float32(v)``. ``"unorm8"`` takes (H, W) uint8 frames, 8-bit unsigned
normalised as decoders and cameras hand them over: the pixel v stands
for ``v / 255``. They cross to the card at one byte a pixel and are
decoded there (:mod:`repro_torch.kernels.unorm8`, under an
``engine.unorm8`` span inside ``engine.assemble``), so every rung serves
the decoded frame; admission refuses a frame of another type.

**Staging ahead.** On a card, while the host is busy (the engine's own
run rule: :data:`FrameEngine.RUN` hand-overs in a row, each begun within
:data:`FrameEngine.WARM_S` of the last one's end), ``submit`` hands each
host frame, float32 or unorm8 as the engine takes them and laid out as
the stager can read it, to the engine's
:class:`~repro_torch.kernels.stage_ahead.Stager`. Its threads copy the
oldest such frames through page-locked memory to the card, at most
``2 * max_batch`` at a time, while the serving thread runs earlier
batches; the batch's hand-over (:mod:`.hand_over`) gathers them on the
card and moves every other frame by ``torch.as_tensor``. The ring holds
``2 * max_batch`` slots of the largest frame it has been given, in
page-locked memory and again on the card: at the default ``max_batch``
of 4, 66,355,200 B each for 1920x1080 float32 frames and 265,420,800 B
each for 3840x2160 float32 frames (tiled frames are staged too). It is
made at the first frame staged ahead, remade for a larger frame once no
ticket of the old one is out, and freed, its threads joined, with the
engine. A request's slots are released however it leaves the engine:
delivered, failed, shed or expired; a retry down the ladder claims them
again. A frame must not change between its ``submit`` and its result.

**Lookahead.** On a card, in strict mode, an untiled batch is launched
without waiting for it: each ``step()`` first assembles, hands over and
launches the next batch when one is queued whose frames are untiled, and
only then waits for the oldest batch in flight (an event recorded after
its launch, not a synchronise of the stream, which would wait for the
batch just launched too) and returns it. So the host's work for the next
batch overlaps the card's work for the last one, and at most two batches
are in flight. Batches come back in launch order; ``pending`` counts the
frames in flight; ``step()`` returns ``[]`` only when nothing is queued
or in flight. A batch's slots in the stager's ring go back at its
hand-over, where its frames are gathered on the current stream. Every
other batch (a CPU engine's, a resilient one's, a tiled one) runs as
before, once nothing is in flight: launched, waited for, returned in
one step.

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
from collections import deque
from time import monotonic as _now
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import h2d_span, stream_synchronize
from repro_torch.kernels import ref, stage_ahead, unorm8
from repro_torch.obs import trace
from repro_torch.resilience import (AdmissionController, FailedFrame,
                                    FallbackLadder, Priority, RejectedFrame,
                                    ResilienceConfig, ShedFrame, overdue_s,
                                    pick_shed_victim, screen_frames,
                                    split_expired)
from repro_torch.serve.scheduling import BoundedFifo, assemble_batch

from .hand_over import hand_over
from .metrics import EngineMetrics
from .plan_cache import PlanCache
from .tiling import execute_tiled, rows_per_step_for_tile

PIXELS = ("float32", "unorm8")         # the frame formats an engine takes


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


@dataclasses.dataclass(eq=False)
class _Batch:
    """One assembled batch, from its assembly to its return."""
    name: str
    reqs: list
    queue_wait: float
    tiled: bool
    rps: int                              # rows_per_step that executes
    t0: float = 0.0                       # its hand-over began
    t1: float = 0.0                       # its wait ended
    outs: list | None = None
    smem: int = 0
    rung: str = ""
    error: Exception | None = None
    ahead: bool = False                   # launched by an earlier step
    event: object = None                  # recorded after its launch
    stager: object = None                 # the ring it was gathered from


class FrameEngine:
    # The host is busy, and admission stages frames ahead, once the engine
    # has handed over RUN times in a row, each hand-over begun within
    # WARM_S of the previous one's end: from the fifth of such a run on;
    # an idle host's frames go by torch.as_tensor. The values come from a
    # sweep of idle gaps before a staging copy (PERF.md).
    WARM_S = 0.002
    RUN = 4

    def __init__(self, cache: PlanCache | None = None,
                 max_batch: int = 4, max_pending: int = 64,
                 tile_shape: tuple[int, int] = (128, 128),
                 rows_per_step: int = 8,
                 prefetch_depth: int = 1,
                 autotune: bool = False,
                 registry=None,
                 resilience: ResilienceConfig | None = None,
                 device: str | torch.device = "cuda",
                 pixels: str = "float32"):
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
        if pixels not in PIXELS:
            raise ValueError(f"pixels must be one of {PIXELS}, got "
                             f"{pixels!r}")
        self.pixels = pixels
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
        # staging ahead: the ring (made at the first frame staged ahead),
        # the frame bytes it must take, and per admitted request staged
        # ahead, id(request): (request, its stager, {input: ticket})
        self._stager: stage_ahead.Stager | None = None
        self._ring_bytes = 0
        self._ahead: dict[int, tuple] = {}
        # the run rule: _now() at the end of the latest hand-over, and how
        # many hand-overs before it followed their predecessor in WARM_S
        self._last_hand_over = -float("inf")
        self._run = 0
        # the lookahead: on a card, in strict mode (the ladder needs each
        # rung's outcome before the next batch); the batches launched and
        # not yet returned, oldest first; the events free for reuse
        self._lookahead = self.device.type == "cuda" and resilience is None
        self._inflight: deque[_Batch] = deque()
        self._events: list = []
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
        if self.pixels == "unorm8" and not all(
                unorm8.is_unorm8(f) for f in req.frames.values()):
            raise ValueError(f"request {req.rid}: a unorm8 engine takes "
                             f"uint8 frames")
        req.submitted_at = time.perf_counter()
        ok = self._queue_for(req.pipeline).push(req)
        self.metrics.frames_offered += 1
        if ok:
            self.metrics.frames_submitted += 1
            self._stage_ahead(req)
        else:
            self.metrics.frames_rejected += 1
        return ok

    # --------------------------------------------------------- stage ahead
    def _host_busy(self) -> bool:
        """Whether a hand-over begun now would be the fifth or later of a
        run: the :data:`RUN` before it each began within :data:`WARM_S`
        of the previous one's end, and the latest ended within
        :data:`WARM_S`."""
        return self._run >= self.RUN - 1 \
            and _now() - self._last_hand_over < self.WARM_S

    def _stages_ahead(self) -> bool:
        """Whether admission stages frames ahead now: on a card, while
        the host is busy, which the stager still holding earlier frames
        of this engine shows as well as the run rule. (By that rule
        alone, a step that ended late on a slow host turned staging ahead
        off; the frames then handed over inline shared the copy engine
        with the stager's and kept steps late, and in one run half the
        frames admitted went inline, at 0.75 of the fps of an engine that
        stages inline.)"""
        return self.device.type == "cuda" and (
            bool(self._ahead) or self._host_busy())

    def _stage_ahead(self, req: FrameRequest) -> None:
        """Hand ``req``'s frames to the stager when :meth:`_stages_ahead`
        and each input frame is an (h, w) host frame of the engine's pixel
        type that the stager can read as it lies; else leave them to the
        hand-over."""
        first = next(iter(req.frames.values()))
        if isinstance(first, torch.Tensor) and first.device.type != "cpu" \
                or id(req) in self._ahead or not self._stages_ahead():
            return
        shape = np.shape(first)
        if len(shape) != 2:
            return
        h, w = shape
        dtype = torch.uint8 if self.pixels == "unorm8" else torch.float32
        names = self.cache.dag_for(req.pipeline).input_stages()
        where = [stage_ahead.layout(req.frames[n], dtype) for n in names]
        if None in where:
            return
        stager = self._stager_for(h * w * dtype.itemsize)
        if stager is not None:
            self._ahead[id(req)] = (req, stager, {
                n: stager.put(req.frames[n], wh)
                for n, wh in zip(names, where)})

    def _stager_for(self, nbytes: int) -> stage_ahead.Stager | None:
        """The ring, its slots ``nbytes`` or more; None while a smaller
        ring still has tickets out or a batch gathered from it in flight
        (it takes no more frames, and is remade once they are released
        and the batches returned)."""
        self._ring_bytes = max(self._ring_bytes, nbytes)
        old = self._stager
        if old is not None and old.slot_bytes >= self._ring_bytes:
            return old
        if old is not None:
            if any(e[1] is old for e in self._ahead.values()) \
                    or any(b.stager is old for b in self._inflight):
                return None
            old.close()
        self._stager = stage_ahead.Stager(self.device, 2 * self.max_batch,
                                          self._ring_bytes)
        return self._stager

    def _tickets(self, reqs: list[FrameRequest], names) -> tuple | None:
        """``hand_over``'s ``ahead`` for ``reqs``: the ring's tickets of
        their frames (None for a frame without one), or None."""
        if not self._ahead:
            return None
        entries = [self._ahead.get(id(r)) for r in reqs]
        if not any(entries):
            return None
        s = self._stager
        return s, {n: [e[2][n] if e is not None and e[1] is s else None
                       for e in entries] for n in names}

    def _hand_over(self, name: str, reqs: list[FrameRequest],
                   slots: int) -> dict[str, torch.Tensor]:
        """``hand_over`` of ``reqs``' frames of pipeline ``name`` into
        ``slots`` slots, with their tickets, the run rule kept around
        it."""
        names = self.cache.dag_for(name).input_stages()
        self._run = self._run + 1 \
            if _now() - self._last_hand_over < self.WARM_S else 0
        out = hand_over({n: [r.frames[n] for r in reqs] for n in names},
                        slots, self.device, self.pixels,
                        self._tickets(reqs, names), pipeline=name)
        self._last_hand_over = _now()
        return out

    def _release(self, reqs) -> None:
        """Hand back the slots of ``reqs`` staged ahead."""
        if not self._ahead:
            return
        out: dict = {}
        for r in reqs:
            e = self._ahead.pop(id(r), None)
            if e is not None:
                out.setdefault(e[1], []).extend(e[2].values())
        for stager, tickets in out.items():
            stager.release(tickets)

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
        defect = screen_frames(
            req.frames, set(dag.input_stages()),
            expect_dtype=np.uint8 if self.pixels == "unorm8" else None)
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
        self._release([req])
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
        self._stage_ahead(req)
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
        """Frames queued or in flight."""
        return sum(len(q) for q in self._queues.values()) \
            + sum(len(b.reqs) for b in self._inflight)

    # ------------------------------------------------------------ execution
    def _run_compiled(self, name: str, reqs: list[FrameRequest],
                      h: int, w: int, tiled: bool, rps: int, tune: bool
                      ) -> tuple[list, int]:
        """Run one batch through the fused kernel; returns (outputs,
        smem_bytes). Ends in a synchronise of the current stream, so the
        caller's clock measures execution, not enqueue."""
        th, tw = self.tile_shape
        dev = self.device
        if tiled:
            staged = self._hand_over(name, reqs, len(reqs))
            with trace.span("engine.execute", pipeline=name):
                outs = [execute_tiled(self.cache, name,
                                      {n: t[j] for n, t in staged.items()},
                                      th, tw, batch=self.max_batch,
                                      rows_per_step=rps, tune=tune,
                                      prefetch_depth=self.prefetch_depth)
                        for j in range(len(reqs))]
                stream_synchronize(dev)
            return outs, self.cache.smem_bytes()
        ex, inputs = self._handed_over(name, reqs, h, w, rps, tune)
        with trace.span("engine.execute", pipeline=name):
            batch_out = ex(inputs)
            stream_synchronize(dev)
        return [batch_out[i] for i in range(len(reqs))], ex.smem_bytes

    def _handed_over(self, name: str, reqs: list[FrameRequest], h: int,
                     w: int, rps: int, tune: bool) -> tuple:
        """The untiled batch's executor and its inputs on the device,
        ``max_batch`` slots (idle slots are zero frames made on the
        device, not handed over)."""
        ex = self.cache.executor_for(name, h, w, batch=self.max_batch,
                                     rows_per_step=rps, tune=tune,
                                     prefetch_depth=self.prefetch_depth)
        return ex, self._hand_over(name, reqs, self.max_batch)

    def _run_reference(self, name: str,
                       reqs: list[FrameRequest]) -> tuple[list, int]:
        """The ladder's last rung: the eager PyTorch oracle on the
        engine's device. Slow — no line buffers, no fused kernel — but
        it has no plan, no executor, and no cache to fail, so it bounds
        the blast radius of every compiled-path fault at "degraded
        throughput". It is the kernel's plain version, so its pixels
        equal the kernel's. unorm8 frames are handed over and decoded
        first, as the compiled rungs' are."""
        dag = self.cache.dag_for(name)
        dev = self.device
        names = dag.input_stages()
        if self.pixels == "unorm8":
            staged = self._hand_over(name, reqs, len(reqs))
            host = ()

            def feed(j, n):
                return staged[n][j]
        else:
            host = (r.frames[n] for r in reqs for n in names)

            def feed(j, n):
                return torch.as_tensor(reqs[j].frames[n],
                                       dtype=torch.float32, device=dev)
        with h2d_span("engine.execute", host, dev, pipeline=name,
                      reference=True):
            outs = [ref.stencil_pipeline_ref(
                dag, {n: feed(j, n) for n in names})
                for j in range(len(reqs))]
            stream_synchronize(dev)
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
        """Return the oldest batch in flight, or assemble and execute one
        batch; flushes pending shed/expiry outcomes first. With the
        lookahead (module docstring) the next batch is launched before
        the wait. Returns a mix of CompletedFrame, ShedFrame, and
        FailedFrame results ([] when idle)."""
        results: list = []
        if self.resilience is not None and self.resilience.shed_expired:
            self._sweep_expired()
        if self._shed_outbox:
            results, self._shed_outbox = self._shed_outbox, []
        self._pending_gauge.set(self.pending)
        fresh = None
        if not self._inflight:
            fresh = self._assemble()
            if fresh is None:
                return results
            if not self._lookahead or fresh.tiled:
                self._step_now(fresh, results)
                return results
            self._inflight.append(fresh)
        oldest = self._inflight[0]
        oldest.ahead = fresh is None
        nxt = self._assemble() if self._next_goes_ahead() else None
        with self._step_span(oldest) as sp:
            if fresh is not None:
                self._launch(fresh, wait=None if nxt else fresh)
            if nxt is not None:
                self._inflight.append(nxt)
                self._launch(nxt, wait=oldest)
            elif fresh is None:
                self._launch(None, wait=oldest)
            self._inflight.popleft()
            done = [oldest]
            if nxt is not None and nxt.error is not None:
                done.append(self._inflight.pop())
            self._deliver(done, sp, results)
        return results

    def _assemble(self) -> _Batch | None:
        """Pop the next batch (``assemble_batch``), or None when idle."""
        name, reqs = assemble_batch(
            self._queues, self.max_batch,
            age_of=lambda r: r.submitted_at,
            compatible=lambda a, b: a.shape == b.shape)
        if not reqs:
            return None
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
        return _Batch(name, reqs, queue_wait, tiled, rps)

    def _next_goes_ahead(self) -> bool:
        """Whether the batch :meth:`_assemble` would pop next may be
        launched ahead: the lookahead is on, and its head frame, the
        oldest head of the queues, is untiled."""
        if not self._lookahead:
            return False
        heads = [q.peek() for q in self._queues.values() if q]
        if not heads:
            return False
        h, w = min(heads, key=lambda r: r.submitted_at).shape
        th, tw = self.tile_shape
        return h <= th and w <= tw

    def _step_span(self, b: _Batch):
        return trace.span("engine.step", engine="frame", pipeline=b.name,
                          n_frames=len(b.reqs), tiled=b.tiled,
                          rows_per_step=b.rps, queue_wait_s=b.queue_wait)

    def _step_now(self, b: _Batch, results: list) -> None:
        """Execute ``b`` and wait for it, down the ladder in resilient
        mode, and deliver it."""
        with self._step_span(b) as sp:
            b.t0 = time.perf_counter()
            h, w = b.reqs[0].shape
            try:
                b.outs, b.smem, b.rung = self._execute(b.name, b.reqs, h, w,
                                                       b.tiled, b.rps)
            except Exception as e:  # noqa: BLE001 - structured failure:
                # the batch is already popped; losing the exception here
                # would strand it, raising would strand the *rest* of
                # the queue — so it travels as FailedFrame results
                b.error = e
            b.t1 = time.perf_counter()
            self._release(b.reqs)
            self._deliver([b], sp, results)

    def _launch(self, b: _Batch | None, wait: _Batch | None) -> None:
        """Hand ``b`` over and launch its executor call without waiting
        for it (its slots in the ring go back at once: the gather is
        queued), then wait for ``wait``'s call, in one ``engine.execute``
        span. A failure of either is kept on its batch (structured
        failure, as in :meth:`_step_now`)."""
        if b is not None:
            b.t0 = time.perf_counter()
            b.rung = self._primary_rung
            if any(id(r) in self._ahead for r in b.reqs):
                b.stager = self._stager
            h, w = b.reqs[0].shape
            try:
                ex, inputs = self._handed_over(b.name, b.reqs, h, w, b.rps,
                                               self.autotune)
            except Exception as e:  # noqa: BLE001 - see _step_now
                b.error = e
            self._release(b.reqs)
            if b.error is not None:
                b = None
        if wait is not None and wait.error is not None:
            wait = None
        if b is None and wait is None:
            return
        with trace.span("engine.execute", pipeline=(b or wait).name):
            if b is not None:
                try:
                    out = ex(inputs)
                    b.outs = [out[i] for i in range(len(b.reqs))]
                    b.smem = ex.smem_bytes
                    b.event = self._record()
                except Exception as e:  # noqa: BLE001 - see _step_now
                    b.error = e
            if wait is not None:
                self._wait(wait)

    def _record(self):
        """An event recorded on the device's current stream: one of the
        engine's, reused once its batch is returned; None on the CPU,
        which has computed the batch already."""
        if self.device.type != "cuda":
            return None
        ev = self._events.pop() if self._events else torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _wait(self, b: _Batch) -> None:
        """Wait until ``b``'s executor call has run; an error the wait
        raises fails ``b``."""
        if b.event is not None:
            try:
                b.event.synchronize()
            except Exception as e:  # noqa: BLE001 - see _step_now
                b.error = e
            self._events.append(b.event)
            b.event = None
        b.t1 = time.perf_counter()

    def _deliver(self, batches: list[_Batch], sp, results: list) -> None:
        """Append ``batches``' results to ``results`` in order: a failed
        batch's as FailedFrame results, the others' frames as
        CompletedFrame ones; the step's span ``sp`` says what it returned
        (``launched_ahead``: of the frames delivered, those an earlier
        step launched)."""
        failed = 0
        for b in batches:
            if b.error is not None:
                failed += len(b.reqs)
                self.metrics.frames_failed += len(b.reqs)
                sp.set(failed=failed, error=type(b.error).__name__)
                now = time.perf_counter()
                results.extend(FailedFrame(
                    pipeline=b.name, error=repr(b.error), rid=r.rid,
                    latency_s=now - r.submitted_at) for r in b.reqs)
                continue
            dt = b.t1 - b.t0
            self.metrics.observe_batch(b.name, len(b.reqs), self.max_batch,
                                       dt, b.smem, rows_per_step=b.rps)
            if b.rung != self._primary_rung:
                self.metrics.fallback_frames += len(b.reqs)
            now = time.perf_counter()
            now_obs = trace.now()
            missed = 0
            for r, out in zip(b.reqs, b.outs):
                lat = now - r.submitted_at
                self.metrics.observe_latency(lat)
                late = r.deadline is not None and now_obs > r.deadline
                if late:
                    missed += 1
                    self.metrics.observe_deadline_miss(now_obs - r.deadline)
                results.append(CompletedFrame(
                    rid=r.rid, pipeline=b.name, output=out, latency_s=lat,
                    rung=b.rung, deadline_missed=late))
            sp.set(execute_s=dt, rung=b.rung, delivered=len(b.reqs),
                   deadline_missed=missed,
                   launched_ahead=len(b.reqs) if b.ahead else 0)

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
