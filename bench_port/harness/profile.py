"""What the device did in the traced window, from ``torch.profiler``.

Every interval is (start_ns, end_ns) on the profiler's clock. Device
activity is every CUDA event of the trace that is not a user annotation
(kernels, copies, sets). Busy time is the union of those intervals, not
their sum, so overlapping work counts once.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[int, int]
    # device activity clipped to the window: (name, start, end, correlation)
    ops: list
    # host user annotations (record_function): (name, start, end)
    marks: list
    # other host events (operators, runtime calls): (name, start, end)
    host: list
    # correlation id -> start of the runtime call that launched the work
    launched_at: dict
    # device-side copies of the annotations: (name, start, end)
    device_marks: list = dataclasses.field(default_factory=list)


def from_events(events, window_mark: str = "bench.window") -> DeviceTrace:
    """Sort the profiler's raw events (``prof.profiler.kineto_results
    .events()``, or stand-ins with the same methods). The window is the
    host annotation ``window_mark``."""
    ops, marks, host, launched, dmarks = [], [], [], {}, []
    window = None
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        on_device = "CUDA" in str(e.device_type())
        if e.is_user_annotation():
            if on_device:
                dmarks.append((name, start, end))
            else:
                marks.append((name, start, end))
                if name == window_mark:
                    window = (start, end)
            continue
        if on_device:
            ops.append((name, start, end, e.correlation_id()))
        else:
            host.append((name, start, end))
            if name.startswith("cu"):
                # a runtime or driver call: its correlation id is the one
                # of the device work it launched
                launched.setdefault(e.correlation_id(), start)
    if window is None:
        raise ValueError(f"the trace holds no {window_mark!r} annotation")
    lo, hi = window
    ops = [(n, max(s, lo), min(t, hi), c) for n, s, t, c in ops
           if t > lo and s < hi]
    return DeviceTrace(window, sorted(ops, key=lambda o: o[1]),
                       sorted(marks, key=lambda m: m[1]),
                       sorted(host, key=lambda h: h[1]), launched,
                       sorted(dmarks, key=lambda m: m[1]))


def union(intervals) -> list[tuple[int, int]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def window_s(tr: DeviceTrace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def busy_s(tr: DeviceTrace) -> float:
    return sum(t - s for s, t in union((o[1], o[2]) for o in tr.ops)) / 1e9


def by_name(tr: DeviceTrace, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    tot: dict = defaultdict(int)
    for name, s, t, _ in tr.ops:
        tot[name] += t - s
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def device_seconds(tr: DeviceTrace, prefix: str) -> float:
    """Device time of the operations whose name starts with ``prefix``."""
    return sum(t - s for name, s, t, _ in tr.ops
               if name.startswith(prefix)) / 1e9


def _innermost(intervals, starts, p: int, scan: int = 256):
    """The name of the latest-starting interval that covers ``p``."""
    j = bisect.bisect_right(starts, p)
    for name, s, t in reversed(intervals[max(0, j - scan):j]):
        if t >= p:
            return name
    return None


def idle_gaps(tr: DeviceTrace, n: int = 10) -> list[list]:
    """Idle device time grouped by what the host was doing in the middle
    of each gap (its innermost annotation, then its innermost operator or
    runtime call): the ``n`` largest groups, [what, seconds]."""
    lo, hi = tr.window
    busy = union((o[1], o[2]) for o in tr.ops)
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    mark_starts = [m[1] for m in tr.marks]
    host_starts = [h[1] for h in tr.host]
    tot: dict = defaultdict(int)
    for s, t in gaps:
        mid = (s + t) // 2
        # the window's own annotation starts too far back for the scan
        mark = _innermost(tr.marks, mark_starts, mid) or "bench.window"
        op = _innermost(tr.host, host_starts, mid)
        tot[f"{mark} / {op}" if op else mark] += t - s
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[what, ns / 1e9] for what, ns in top]


def kernels_launched_in(tr: DeviceTrace, mark: str) -> list:
    """Device kernels (no copies, no sets) whose launch on the host fell
    inside an annotation named ``mark``, whatever their own names. A
    kernel whose launching call the trace lacks counts where it ran
    inside the annotation's device-side copy."""
    host = [(s, t) for name, s, t in tr.marks if name == mark]
    dev = [(s, t) for name, s, t in tr.device_marks if name == mark]
    out = []
    for op in tr.ops:
        if op[0].startswith(("Memcpy", "Memset")):
            continue
        at = tr.launched_at.get(op[3])
        if _inside(host, at) if at is not None else _inside(dev, op[1]):
            out.append(op)
    return out


def _inside(spans, p: int) -> bool:
    """Whether ``p`` lies in one of the sorted, disjoint ``spans``."""
    j = bisect.bisect_right(spans, (p, float("inf"))) - 1
    return j >= 0 and spans[j][1] >= p
