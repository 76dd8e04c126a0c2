"""Readings of the program's own spans (``repro_torch.obs.trace``): each
event has ``name``, ``ts_ns``, ``dur_ns``, ``tid``, ``depth`` and
``attrs``."""
from __future__ import annotations

import bisect

STEP = "engine.step"
STEP_PARTS = ("engine.assemble", "engine.execute")


def step_self_ns(events) -> list[int]:
    """Per ``engine.step`` span, its duration minus the time its direct
    ``engine.assemble`` and ``engine.execute`` children cover."""
    kids = sorted((e.ts_ns, e.ts_ns + e.dur_ns, e.tid, e.depth)
                  for e in events if e.name in STEP_PARTS)
    starts = [k[0] for k in kids]
    out = []
    for e in events:
        if e.name != STEP:
            continue
        end = e.ts_ns + e.dur_ns
        covered, cur = 0, e.ts_ns
        j = bisect.bisect_left(starts, e.ts_ns)
        while j < len(kids) and kids[j][0] < end:
            s, t, tid, depth = kids[j]
            j += 1
            if tid != e.tid or depth != e.depth + 1:
                continue
            s, t = max(s, cur), min(t, end)
            if t > s:
                covered += t - s
                cur = t
        out.append(e.dur_ns - covered)
    return out


def frames_served(events) -> int:
    """Frames the engine delivered in the traced steps."""
    return sum(int(e.attrs.get("delivered", 0)) for e in events
               if e.name == STEP)


def executor_calls(events) -> int:
    """Calls of a compiled executor (``engine.execute`` spans off the
    reference rung): one kernel launch each."""
    return sum(1 for e in events
               if e.name == "engine.execute" and not e.attrs.get("reference"))
