"""Two clocks for one call on the card: per call, and the device's own.

  * :func:`event_ms` — CUDA events around back-to-back calls: what a
    caller waits per call, host overhead (Python, ctypes, the launch)
    included whenever the host issues calls slower than the card runs
    them;
  * :func:`device_ms` — the device time of every kernel (and copy) the
    calls launch, from ``torch.profiler``, summed and divided by the
    call count: the card's own time, with no host time and no gaps
    (:func:`graph_ms`, a CUDA graph's replay, where the profiler keeps
    dropping the trace).

Both warm up first and need an NVIDIA GPU.
"""
from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def graph_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around the replay
    of a CUDA graph that holds ``iters`` calls: device time with the host
    taken out, gaps between the calls' kernels included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return event_ms(graph.replay, iters=3, warmup=1) / iters


def device_ms(fn, iters: int, warmup: int = 2,
              attempts: int = 3) -> tuple[float, dict]:
    """(device milliseconds per call, {kernel name: ms per call}) of
    ``fn`` over ``iters`` calls under the profiler. Every kernel ``fn``
    launches must show at least once per call: a trace that lost events
    (the profiler drops some, or all, now and then) is taken again, up
    to ``attempts`` times; then the calls are timed by :func:`graph_ms`
    instead, reported as {"cuda graph replay": ms}."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, counts = {}, []
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and _device_us(evt) > 0:
                by_name[evt.key] = _device_us(evt) / 1e3 / iters
                counts.append(evt.count)
        if by_name and min(counts) >= iters:
            return sum(by_name.values()), by_name
    ms = graph_ms(fn, iters)
    return ms, {"cuda graph replay": ms}
