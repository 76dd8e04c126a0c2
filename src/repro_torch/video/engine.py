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

Strict mode only: malformed frames raise at ``submit()``, and an
executor exception comes back as structured :class:`FailedFrame`
results with the session state left at the last served frame. (The
reference engine's resilient mode — screening, rate limits, deadlines,
the fallback ladder — is not ported yet; passing ``resilience`` raises.)
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import synchronize
from repro_torch.imaging.metrics import EngineMetrics
from repro_torch.imaging.plan_cache import PlanCache
from repro_torch.imaging.tiling import rows_per_step_for_tile
from repro_torch.kernels.stencil_pipeline import init_frame_state
from repro_torch.obs import trace
from repro_torch.resilience import CancelledFrame, FailedFrame, Priority
from repro_torch.serve.scheduling import BoundedFifo, assemble_batch


@dataclasses.dataclass
class VideoFrame:
    """One submitted frame of one stream (inputs keyed by stage name)."""
    stream: int
    frames: Mapping[str, np.ndarray]
    submitted_at: float = 0.0             # stamped by the engine
    priority: int = Priority.NORMAL       # stamped from the session
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
    rung: str = "default"                 # "tuned" under autotune
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
                 resilience=None,
                 device: str | torch.device = "cuda"):
        # ``registry``: a shared obs.MetricsRegistry for the serving
        # telemetry plane; default = a private one per engine. A cache
        # constructed here joins the same registry and runs on ``device``
        # (a given cache keeps its own device).
        if resilience is not None:
            raise NotImplementedError(
                "the VideoEngine's resilient mode is not ported yet; "
                "pass resilience=None")
        self.cache = cache if cache is not None else \
            PlanCache(registry=registry, device=device)
        self.chunk = chunk
        self.max_pending = max_pending
        self.rows_per_step = rows_per_step
        self.prefetch_depth = prefetch_depth
        # opt-in: stream through the cache's autotuned memory config (one
        # memoized design-space search per (pipeline, width))
        self.autotune = autotune
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
        self._sessions[sid] = VideoSession(
            sid=sid, pipeline=pipeline, h=h, w=w,
            state=init_frame_state(dag.temporal_depths(), h, w,
                                   self.device),
            queue=BoundedFifo(self.max_pending),
            warmup_frames=dag.cumulative_extent(temporal=True)[0],
            inputs=frozenset(dag.input_stages()),
            priority=int(priority))
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
        del self._sessions[sid]
        return cancelled

    @property
    def pending(self) -> int:
        return sum(len(s.queue) for s in self._sessions.values())

    # ----------------------------------------------------------- admission
    def submit(self, frame: VideoFrame) -> bool:
        """Enqueue one frame; False = stream saturated (backpressure).
        Malformed frames raise here, at admission."""
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

    # ------------------------------------------------------------ execution
    @property
    def _rung(self) -> str:
        return "tuned" if self.autotune else "default"

    def _run_chunk(self, s: VideoSession, frames: list[VideoFrame],
                   n: int, rps: int):
        """Full-chunk executor call (one launch). Returns (outs,
        new_state, smem_bytes); does NOT touch ``s.state`` — the caller
        commits state only on success, so a failed call leaves the
        stream resumable."""
        ex = self.cache.video_executor_for(s.pipeline, s.h, s.w, chunk=n,
                                           rows_per_step=rps,
                                           tune=self.autotune,
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

    def _run_frame(self, s: VideoSession, f: VideoFrame, rps: int):
        """Single-frame executor call; same no-state-mutation contract."""
        ex = self.cache.video_executor_for(s.pipeline, s.h, s.w, chunk=None,
                                           rows_per_step=rps,
                                           tune=self.autotune,
                                           prefetch_depth=self.prefetch_depth)
        with trace.span("engine.execute", pipeline=s.pipeline,
                        profile=True):
            out, new_state = ex({n: np.asarray(f.frames[n], np.float32)
                                 for n in s.inputs}, s.state)
            synchronize(self.device)
        return out, new_state, ex.smem_bytes

    def _execute_stream(self, s: VideoSession, frames: list[VideoFrame]):
        """Serve ``frames`` (in order) against the session. Returns
        (served, failed, smem, rps) with served = [(frame, out)] and
        failed = [(frame, error_str)]; session state advances only over
        the served frames."""
        n = len(frames)
        dag = self.cache.dag_for(s.pipeline)
        rps = rows_per_step_for_tile(s.h, self.rows_per_step)
        chunkable = all(p in s.inputs for p in dag.temporal_depths())
        served: list = []
        smem = 0
        try:
            if n == self.chunk and n > 1 and chunkable:
                outs, new_state, smem = self._run_chunk(s, frames, n, rps)
                s.state = new_state
                served = list(zip(frames, outs))
            else:
                for f in frames:
                    out, new_state, smem = self._run_frame(s, f, rps)
                    s.state = new_state
                    served.append((f, out))
        except Exception as e:  # noqa: BLE001 - structured failure: the
            # frames are already popped; raising would strand them
            err = repr(e)
            return served, [(f, err) for f in frames[len(served):]], \
                smem, rps
        return served, [], smem, rps

    # ----------------------------------------------------------------- step
    def step(self) -> list:
        """Serve up to ``chunk`` frames of the neediest stream. Returns
        CompletedVideoFrame and FailedFrame results ([] when idle)."""
        self._pending_gauge.set(self.pending)
        live = {sid: s.queue for sid, s in self._sessions.items()}
        sid, frames = assemble_batch(live, self.chunk,
                                     age_of=lambda f: f.submitted_at)
        if not frames:
            return []
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
        if failed:
            self.metrics.frames_failed += len(failed)
        now = time.perf_counter()
        results: list = []
        for f, out in served:
            idx = s.delivered
            s.delivered += 1
            warm = idx >= s.warmup_frames
            if warm and s.first_warm_at is None:
                s.first_warm_at = now
                self.warmup_latency_s.observe(now - s.opened_at)
            lat = now - f.submitted_at
            self.metrics.observe_latency(lat)
            results.append(CompletedVideoFrame(
                stream=sid, pipeline=s.pipeline, index=idx, output=out,
                warm=warm, latency_s=lat, rung=self._rung, rid=f.rid))
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
        the requested streams' queues gate termination."""
        pending = {sid: list(frames) for sid, frames in streams.items()}
        results: dict[int, list] = {sid: [] for sid in streams}

        def queued(sid: int) -> bool:
            s = self._sessions.get(sid)
            return bool(s and s.queue)

        while any(pending.values()) or any(queued(sid) for sid in streams):
            for sid, frames in pending.items():
                while frames and self.submit(VideoFrame(sid, frames[0])):
                    frames.pop(0)
            for c in self.step():
                if isinstance(c, CompletedVideoFrame):
                    results.setdefault(c.stream, []).append(c.output)
        return results

    def snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["warmup_latency"] = self.warmup_latency_s.snapshot()
        snap["open_streams"] = len(self._sessions)
        snap["pending"] = self.pending
        snap["cache"] = self.cache.snapshot()
        return snap
