"""VideoEngine: multiplexed streaming of temporal pipelines.

The video analogue of imaging.FrameEngine — but where the frame engine
treats every request as independent, a video stream is *stateful*: each
temporal producer's last d-1 frames live in a device-resident frame ring
that must follow the stream, frame order matters, and two streams of the
same pipeline must never see each other's history. The engine therefore
splits the world in two:

  * **executors are shared** — one VideoExecutor per (pipeline, shape,
    chunk, row group) in the PlanCache, stateless across streams
    (history is an explicit argument/result, see kernels.VideoExecutor);
  * **state is per-session** — a VideoSession owns its frame rings, its
    FIFO of pending frames (bounded: a full queue refuses, backpressure
    to the caller), its delivery counter (outputs are emitted in
    submission order), and its warm-up accounting.

Warm-up semantics: a fresh session's frame rings are zeros, so the first
``warmup_frames`` outputs (the DAG's cumulative temporal extent) are
computed against zero history — valid, deterministic, equal to the
multi-frame reference, but flagged ``warm=False`` so a caller who wants
only fully-warmed output can drop them.

``step()`` serves the session whose head frame waited longest, advancing
up to ``chunk`` frames in one executor call (one kernel launch) when the
pipeline's temporal taps are input-only, and frame-at-a-time for
pipelines with internal temporal producers. Frames arrive as numpy
arrays; a call stacks them and copies them to the device once.

**Resilient mode** (``resilience=ResilienceConfig(...)``) adds the
serving control plane: malformed/unknown-stream frames come back as
structured :class:`~repro_torch.resilience.RejectedFrame` results
instead of raising (screened on the host, before any copy to the card),
per-stream token buckets rate-limit admission, saturated queues shed the
most-expired resident, deadlines sweep expired work, and execution
descends a fallback ladder (tuned → default → reference). The reference
rung is the interesting one for a *stateful* engine: each session keeps
a host-side window of its last ``warmup_frames`` raw input frames, so
the eager PyTorch oracle (``execute_reference_video``, on the engine's
device) can recompute the stream's tail and hand back both the outputs
and a rebuilt frame-ring state — the kernel resumes the stream exactly
where the oracle left it. Dropped (shed) frames simply never happened to
the stream: rings and history advance only on served frames, which is
precisely live-video frame-dropping semantics. Every result names its
rung and ``metrics.fallback_frames`` counts the frames served off the
primary one.

In both modes an executor exception can never strand queued work:
frames that reached the executor but could not be served are delivered
as structured :class:`FailedFrame` results and the session state is
left at the last successfully served frame.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import synchronize
from repro_torch.core.algorithms import execute_reference_video
from repro_torch.imaging.metrics import EngineMetrics
from repro_torch.imaging.plan_cache import PlanCache
from repro_torch.imaging.tiling import rows_per_step_for_tile
from repro_torch.kernels import ref
from repro_torch.kernels.stencil_pipeline import init_frame_state
from repro_torch.obs import trace
from repro_torch.resilience import (AdmissionController, CancelledFrame,
                                    FailedFrame, FallbackLadder,
                                    LadderExhausted, Priority,
                                    RejectedFrame, ResilienceConfig,
                                    ShedFrame, overdue_s, pick_shed_victim,
                                    screen_frames, split_expired)
from repro_torch.serve.scheduling import BoundedFifo, assemble_batch


@dataclasses.dataclass
class VideoFrame:
    """One submitted frame of one stream (inputs keyed by stage name)."""
    stream: int
    frames: Mapping[str, np.ndarray]
    submitted_at: float = 0.0             # stamped by the engine
    priority: int = Priority.NORMAL       # stamped from the session
    deadline_s: float | None = None       # relative SLA; None = config's
    deadline: float | None = None         # absolute (obs clock), stamped
    rid: int | None = None                # optional client tag, echoed in
                                          # every outcome for accounting


@dataclasses.dataclass
class CompletedVideoFrame:
    stream: int
    pipeline: str
    index: int                            # position in the stream, from 0
    output: torch.Tensor                  # (H, W) on the engine's device
    warm: bool                            # False while zero history shows
    latency_s: float
    rung: str = "default"                 # ladder rung that served it
    deadline_missed: bool = False
    rid: int | None = None                # echo of VideoFrame.rid


@dataclasses.dataclass
class VideoSession:
    """Per-stream serving state: the part that must NOT be shared."""
    sid: int
    pipeline: str
    h: int
    w: int
    state: dict[str, torch.Tensor]        # frame rings {producer: (d-1,h,w)}
    queue: BoundedFifo
    warmup_frames: int
    inputs: frozenset                     # required input-stage names
    priority: int = Priority.NORMAL
    # resilient mode, temporal DAGs only: last ``warmup_frames`` raw
    # input frames (oldest -> newest, float32 numpy on the host) per
    # input stage — the window the reference rung replays to serve off
    # the compiled path
    history: dict[str, deque] | None = None
    submitted: int = 0
    delivered: int = 0
    opened_at: float = dataclasses.field(
        default_factory=time.perf_counter)
    first_warm_at: float | None = None


class VideoEngine:
    def __init__(self, cache: PlanCache | None = None,
                 chunk: int = 4, max_pending: int = 64,
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
        self.chunk = chunk
        self.max_pending = max_pending
        self.rows_per_step = rows_per_step
        self.prefetch_depth = prefetch_depth
        # opt-in: stream through the cache's autotuned memory config (one
        # memoized design-space search per (pipeline, width))
        self.autotune = autotune
        self.resilience = resilience
        self._sessions: dict[int, VideoSession] = {}
        self._ids = itertools.count()
        self.metrics = EngineMetrics(registry=registry,
                                     prefix="video_engine")
        self.warmup_latency_s = self.metrics.registry.histogram(
            "video_engine_warmup_latency_s",
            help="stream open -> first fully-warm output, seconds")
        # live backlog gauge for the telemetry plane (see FrameEngine)
        self._pending_gauge = self.metrics.registry.gauge(
            "video_engine_pending_frames",
            help="frames admitted but not yet served across streams")
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

    # ------------------------------------------------------------- streams
    def open_stream(self, pipeline: str, h: int, w: int,
                    priority: int = Priority.NORMAL) -> int:
        """Create a session: zeroed frame rings on the device, empty
        queue. Executors are built lazily on the first step — opening a
        stream costs only the zero-state allocation."""
        dag = self.cache.dag_for(pipeline)
        sid = next(self._ids)
        warmup = dag.cumulative_extent(temporal=True)[0]
        history = None
        if self.resilience is not None and dag.is_temporal():
            history = {name: deque(maxlen=warmup)
                       for name in dag.input_stages()}
        self._sessions[sid] = VideoSession(
            sid=sid, pipeline=pipeline, h=h, w=w,
            state=init_frame_state(dag.temporal_depths(), h, w,
                                   self.device),
            queue=BoundedFifo(self.max_pending),
            warmup_frames=warmup,
            inputs=frozenset(dag.input_stages()),
            priority=int(priority), history=history)
        return sid

    def close_stream(self, sid: int,
                     cancel: bool = False) -> list[CancelledFrame]:
        """Tear down a session. A queue with undelivered frames refuses
        (raises) by default — closing must not silently race in-flight
        work. ``cancel=True`` drains those frames as structured
        :class:`CancelledFrame` results instead (they count as
        cancelled, not lost)."""
        s = self._sessions[sid]
        cancelled: list[CancelledFrame] = []
        if s.queue:
            if not cancel:
                raise ValueError(f"stream {sid} closed with {len(s.queue)} "
                                 f"undelivered frames")
            dropped = s.queue.drain()
            self.metrics.frames_cancelled += len(dropped)
            cancelled = [CancelledFrame(pipeline=s.pipeline, stream=sid,
                                        rid=f.rid)
                         for f in dropped]
            with trace.span("resilience.cancel", engine="video",
                            stream=sid, pipeline=s.pipeline,
                            n_frames=len(dropped)):
                pass
        if self._admission is not None:
            self._admission.forget(sid)
        del self._sessions[sid]
        return cancelled

    @property
    def pending(self) -> int:
        return sum(len(s.queue) for s in self._sessions.values())

    # ----------------------------------------------------------- admission
    def submit(self, frame: VideoFrame) -> bool | RejectedFrame:
        """Enqueue one frame; False = stream saturated (backpressure).
        Strict mode raises on malformed frames here, at admission;
        resilient mode returns a falsy RejectedFrame for every refusal
        instead."""
        if self.resilience is not None:
            return self._submit_resilient(frame)
        s = self._sessions.get(frame.stream)
        if s is None:
            raise KeyError(f"unknown stream {frame.stream}")
        if not s.inputs <= set(frame.frames):
            raise ValueError(f"stream {s.sid}: pipeline {s.pipeline!r} "
                             f"needs inputs {sorted(s.inputs)}, got "
                             f"{sorted(frame.frames)}")
        for n in s.inputs:
            if tuple(np.shape(frame.frames[n])) != (s.h, s.w):
                raise ValueError(
                    f"stream {s.sid}: frame shape "
                    f"{tuple(np.shape(frame.frames[n]))} != ({s.h}, {s.w})")
        frame.submitted_at = time.perf_counter()
        frame.priority = int(s.priority)
        self.metrics.frames_offered += 1
        ok = s.queue.push(frame)
        if ok:
            s.submitted += 1
            self.metrics.frames_submitted += 1
        else:
            self.metrics.frames_rejected += 1
        return ok

    def _reject(self, rej: RejectedFrame) -> RejectedFrame:
        self.metrics.frames_rejected += 1
        with trace.span("resilience.reject", engine="video",
                        pipeline=rej.pipeline or "?", reason=rej.reason,
                        retryable=rej.retryable):
            pass
        return rej

    def _shed(self, frame: VideoFrame, reason: str, now: float,
              s: VideoSession) -> None:
        self.metrics.frames_shed += 1
        od = overdue_s(frame.deadline, now)
        self._shed_outbox.append(ShedFrame(
            reason=reason, pipeline=s.pipeline,
            priority=int(frame.priority), stream=s.sid, rid=frame.rid,
            deadline=frame.deadline,
            overdue_s=od if od > float("-inf") else 0.0))
        with trace.span("resilience.shed", engine="video",
                        pipeline=s.pipeline, stream=s.sid, reason=reason,
                        priority=int(frame.priority)):
            pass

    def _submit_resilient(self, frame: VideoFrame) -> bool | RejectedFrame:
        self.metrics.frames_offered += 1
        s = self._sessions.get(frame.stream)
        if s is None:
            return self._reject(RejectedFrame(
                "unknown_stream", stream=frame.stream,
                detail=f"no open stream {frame.stream}", rid=frame.rid))
        defect = screen_frames(frame.frames, s.inputs,
                               expect_shape=(s.h, s.w))
        if defect is not None:
            reason, detail = defect
            return self._reject(RejectedFrame(
                reason, pipeline=s.pipeline, detail=detail,
                stream=s.sid, rid=frame.rid))
        if not self._admission.allow(s.sid):
            return self._reject(RejectedFrame(
                "rate_limited", pipeline=s.pipeline, retryable=True,
                stream=s.sid, rid=frame.rid))
        cfg = self.resilience
        now = trace.now()
        frame.submitted_at = time.perf_counter()
        frame.priority = int(s.priority)
        dl = frame.deadline_s if frame.deadline_s is not None \
            else cfg.default_deadline_s
        frame.deadline = (now + dl) if dl is not None else None
        q = s.queue
        if len(q) >= q.capacity and cfg.shed_on_overload:
            # within one stream every frame shares the session priority,
            # so eviction here only ever claims an expired resident —
            # classic live-video frame dropping, never reordering
            victim = pick_shed_victim(
                q, int(frame.priority), now,
                priority_of=lambda f: int(f.priority),
                deadline_of=lambda f: f.deadline,
                age_of=lambda f: f.submitted_at)
            if victim is not None:
                q.remove(victim)
                self._shed(victim, "overload", now, s)
        if not q.push(frame):
            return self._reject(RejectedFrame(
                "saturated", pipeline=s.pipeline, retryable=True,
                stream=s.sid, rid=frame.rid))
        s.submitted += 1
        self.metrics.frames_submitted += 1
        return True

    def _sweep_expired(self) -> None:
        now = trace.now()
        for s in self._sessions.values():
            if not s.queue:
                continue
            live, expired = split_expired(s.queue.drain(), now,
                                          lambda f: f.deadline)
            for f in live:
                s.queue.push(f)
            for f in expired:
                self._shed(f, "deadline", now, s)

    # ------------------------------------------------------------ execution
    @property
    def _primary_rung(self) -> str:
        return "tuned" if self.autotune else "default"

    def _run_chunk(self, s: VideoSession, frames: list[VideoFrame],
                   n: int, rps: int, tune: bool):
        """Full-chunk executor call (one launch). Returns (outs,
        new_state, smem_bytes); does NOT touch ``s.state`` — the caller
        commits state only on success, so a failed rung leaves the
        stream resumable."""
        ex = self.cache.video_executor_for(s.pipeline, s.h, s.w, chunk=n,
                                           rows_per_step=rps, tune=tune,
                                           prefetch_depth=self.prefetch_depth)
        with trace.span("engine.assemble", pipeline=s.pipeline):
            ins = {name: torch.as_tensor(
                np.stack([np.asarray(f.frames[name], np.float32)
                          for f in frames]), device=self.device)
                for name in s.inputs}
        with trace.span("engine.execute", pipeline=s.pipeline,
                        profile=True):
            out, new_state = ex(ins, s.state)
            synchronize(self.device)
        return [out[i] for i in range(n)], new_state, ex.smem_bytes

    def _run_frame(self, s: VideoSession, f: VideoFrame, rps: int,
                   tune: bool):
        """Single-frame executor call; same no-state-mutation contract."""
        ex = self.cache.video_executor_for(s.pipeline, s.h, s.w, chunk=None,
                                           rows_per_step=rps, tune=tune,
                                           prefetch_depth=self.prefetch_depth)
        with trace.span("engine.execute", pipeline=s.pipeline,
                        profile=True):
            out, new_state = ex({n: np.asarray(f.frames[n], np.float32)
                                 for n in s.inputs}, s.state)
            synchronize(self.device)
        return [out], new_state, ex.smem_bytes

    def _reference_serve(self, s: VideoSession, frames: list[VideoFrame]):
        """The ladder's reference rung for a *stateful* stream: replay
        the session's host-side input window plus the new frames through
        the eager oracle on the engine's device, return the tail outputs
        and a frame-ring state rebuilt from the oracle's end-of-window
        history. Input producers resync bit for bit (the rings hold raw
        past inputs); internal temporal producers are recomputed by the
        kernel's plain version.
        """
        dag = self.cache.dag_for(s.pipeline)
        dev = self.device
        with trace.span("engine.execute", pipeline=s.pipeline,
                        reference=True):
            if not dag.is_temporal():
                outs = [ref.stencil_pipeline_ref(
                    dag, {k: torch.as_tensor(f.frames[k],
                                             dtype=torch.float32,
                                             device=dev)
                          for k in s.inputs}) for f in frames]
                synchronize(dev)
                return outs, dict(s.state), 0
            videos = {
                k: torch.as_tensor(np.stack(
                    list(s.history[k])
                    + [np.asarray(f.frames[k], np.float32)
                       for f in frames]), device=dev)
                for k in s.inputs}
            out, hist = execute_reference_video(dag, videos,
                                                return_history=True)
            new_state = self._state_from_history(
                dag.temporal_depths(), hist, s.h, s.w, dev)
            outs = [out[t] for t in range(out.shape[0] - len(frames),
                                          out.shape[0])]
            synchronize(dev)
        return outs, new_state, 0

    @staticmethod
    def _state_from_history(depths: dict[str, int], hist: dict,
                            h: int, w: int, device: torch.device
                            ) -> dict[str, torch.Tensor]:
        """Frame rings from a reference history: newest first, (d-1, h,
        w) float32 on ``device`` (the layout of ``init_frame_state``),
        zero-padded up to d-1 when the stream is younger than its
        temporal extent."""
        state = {}
        for p, d in depths.items():
            fr = [torch.as_tensor(x, dtype=torch.float32, device=device)
                  for x in hist.get(p, [])][:d - 1]
            fr += [torch.zeros((h, w), dtype=torch.float32,
                               device=device)] * (d - 1 - len(fr))
            state[p] = torch.stack(fr) if fr else \
                torch.zeros((0, h, w), dtype=torch.float32, device=device)
        return state

    def _remember(self, s: VideoSession, frames: list[VideoFrame]) -> None:
        """Append served frames to the session's reference window. Only
        served frames: the window must mirror the effective stream the
        device rings saw, and shed/failed frames never happened to it."""
        if s.history is None:
            return
        for k in s.inputs:
            for f in frames:
                s.history[k].append(np.asarray(f.frames[k], np.float32))

    def _rungs(self, s: VideoSession, frames: list[VideoFrame],
               make_compiled):
        rungs = []
        if self.autotune:
            rungs.append(("tuned", make_compiled(True)))
        rungs.append(("default", make_compiled(False)))
        if self.resilience.reference_fallback:
            rungs.append(("reference",
                          lambda: self._reference_serve(s, frames)))
        return rungs

    def _execute_stream(self, s: VideoSession, frames: list[VideoFrame]):
        """Serve ``frames`` (in order) against the session. Returns
        (served, failed, smem, rps) with served = [(frame, out, rung)]
        and failed = [(frame, error_str)]; session state advances only
        over the served frames."""
        n = len(frames)
        dag = self.cache.dag_for(s.pipeline)
        rps = rows_per_step_for_tile(s.h, self.rows_per_step)
        chunkable = all(p in s.inputs for p in dag.temporal_depths())
        use_chunk = n == self.chunk and n > 1 and chunkable
        served: list = []
        failed: list = []
        smem = 0
        if self.resilience is None:
            # strict mode: primary path only, but an executor exception
            # becomes structured failures for the unserved frames
            # instead of escaping with the batch already popped
            try:
                if use_chunk:
                    outs, new_state, smem = self._run_chunk(
                        s, frames, n, rps, self.autotune)
                    s.state = new_state
                    served = [(f, o, self._primary_rung)
                              for f, o in zip(frames, outs)]
                else:
                    for f in frames:
                        outs, new_state, smem = self._run_frame(
                            s, f, rps, self.autotune)
                        s.state = new_state
                        served.append((f, outs[0], self._primary_rung))
            except Exception as e:  # noqa: BLE001 - structured failure
                err = repr(e)
                failed = [(f, err) for f in frames[len(served):]]
            return served, failed, smem, rps

        if use_chunk:
            rungs = self._rungs(
                s, frames,
                lambda tune: (lambda: self._run_chunk(s, frames, n, rps,
                                                      tune)))
            try:
                (outs, new_state, smem), rung = self._ladder.run(
                    (s.pipeline, "chunk"), rungs)
            except LadderExhausted as e:
                return [], [(f, repr(e)) for f in frames], 0, rps
            s.state = new_state
            self._remember(s, frames)
            served = [(f, o, rung) for f, o in zip(frames, outs)]
            return served, failed, smem, rps

        for f in frames:
            rungs = self._rungs(
                s, [f],
                lambda tune, f=f: (lambda: self._run_frame(s, f, rps,
                                                           tune)))
            try:
                (outs, new_state, sm), rung = self._ladder.run(
                    (s.pipeline, "frame"), rungs)
            except LadderExhausted as e:
                failed.append((f, repr(e)))
                continue    # state untouched: the stream skips this frame
            s.state = new_state
            smem = max(smem, sm)
            self._remember(s, [f])
            served.append((f, outs[0], rung))
        return served, failed, smem, rps

    # ----------------------------------------------------------------- step
    def step(self) -> list:
        """Serve up to ``chunk`` frames of the neediest stream; flushes
        pending shed outcomes first. Returns a mix of
        CompletedVideoFrame, ShedFrame, and FailedFrame ([] when idle).
        """
        results: list = []
        if self.resilience is not None and self.resilience.shed_expired:
            self._sweep_expired()
        if self._shed_outbox:
            results, self._shed_outbox = self._shed_outbox, []
        self._pending_gauge.set(self.pending)
        live = {sid: s.queue for sid, s in self._sessions.items()}
        sid, frames = assemble_batch(live, self.chunk,
                                     age_of=lambda f: f.submitted_at)
        if not frames:
            return results
        s = self._sessions[sid]
        n = len(frames)
        queue_wait = (time.perf_counter()
                      - min(f.submitted_at for f in frames))
        self.metrics.observe_queue_wait(queue_wait)
        with trace.span("engine.step", engine="video", pipeline=s.pipeline,
                        stream=sid, n_frames=n,
                        queue_wait_s=queue_wait) as sp:
            t0 = time.perf_counter()
            served, failed, smem, rps = self._execute_stream(s, frames)
            dt = time.perf_counter() - t0
            sp.set(execute_s=dt, delivered=len(served), failed=len(failed))
        if served:
            self.metrics.observe_batch(s.pipeline, len(served), self.chunk,
                                       dt, smem, rows_per_step=rps)
            self.metrics.fallback_frames += sum(
                1 for _, _, rung in served if rung != self._primary_rung)
        if failed:
            self.metrics.frames_failed += len(failed)
        now = time.perf_counter()
        now_obs = trace.now()
        for f, out, rung in served:
            idx = s.delivered
            s.delivered += 1
            warm = idx >= s.warmup_frames
            if warm and s.first_warm_at is None:
                s.first_warm_at = now
                self.warmup_latency_s.observe(now - s.opened_at)
            lat = now - f.submitted_at
            self.metrics.observe_latency(lat)
            late = f.deadline is not None and now_obs > f.deadline
            if late:
                self.metrics.observe_deadline_miss(now_obs - f.deadline)
            results.append(CompletedVideoFrame(
                stream=sid, pipeline=s.pipeline, index=idx, output=out,
                warm=warm, latency_s=lat, rung=rung, deadline_missed=late,
                rid=f.rid))
        for f, err in failed:
            results.append(FailedFrame(
                pipeline=s.pipeline, error=err, stream=sid, rid=f.rid,
                latency_s=now - f.submitted_at))
        return results

    def run(self, streams: Mapping[int, list[Mapping[str, np.ndarray]]]
            ) -> dict[int, list[torch.Tensor]]:
        """Feed whole streams (respecting backpressure), drain to the end.
        Returns outputs per stream in frame order. ``step()`` serves the
        globally neediest stream, so frames already queued on sessions
        *outside* ``streams`` may complete during the drain; they are
        returned under their own stream id rather than dropped, and only
        the requested streams' queues gate termination. In resilient
        mode, permanently rejected frames are dropped from the feed
        (their structured outcomes are not collected here — drive
        ``submit``/``step`` directly for per-frame accounting)."""
        pending = {sid: list(frames) for sid, frames in streams.items()}
        results: dict[int, list] = {sid: [] for sid in streams}

        def queued(sid: int) -> bool:
            s = self._sessions.get(sid)
            return bool(s and s.queue)

        while any(pending.values()) or any(queued(sid) for sid in streams):
            progressed = False
            for sid, frames in pending.items():
                while frames:
                    r = self.submit(VideoFrame(sid, frames[0]))
                    if r is True:
                        frames.pop(0)
                        progressed = True
                    elif isinstance(r, RejectedFrame) and not r.retryable:
                        frames.pop(0)       # permanent: skip the frame
                        progressed = True
                    else:
                        break
            for c in self.step():
                progressed = True
                if isinstance(c, CompletedVideoFrame):
                    results.setdefault(c.stream, []).append(c.output)
            if not progressed:
                time.sleep(0.001)  # rate-limit window: don't spin hot
        return results

    def snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["warmup_latency"] = self.warmup_latency_s.snapshot()
        snap["open_streams"] = len(self._sessions)
        snap["pending"] = self.pending
        snap["cache"] = self.cache.snapshot()
        return snap
