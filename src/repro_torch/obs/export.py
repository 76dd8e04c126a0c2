"""Trace export: Chrome/Perfetto ``trace_event`` JSON + flame summary.

The interchange layer between the in-process ring buffer (obs.trace) and
the tools that read timelines:

  * :func:`to_chrome_trace` — events -> the Trace Event Format dict
    (``ph: "X"`` complete events, µs timestamps, one ``pid``, real
    thread ids, span attributes under ``args``). Loadable directly in
    ``ui.perfetto.dev`` or ``chrome://tracing``.
  * :func:`validate_trace` — the schema check CI gates emitted traces
    on: returns a list of human-readable errors (empty = valid). Kept
    deliberately structural (required keys, types, non-negative times)
    so it validates traces round-tripped through JSON files, not just
    live objects.
  * :func:`flame_summary` — aggregate text view: per span name, call
    count, total/self wall time, mean and p95 duration. Self time
    subtracts each span's *immediate* children (per-thread timestamp
    containment), so "where did the milliseconds go" reads off the top
    row even when spans nest five deep.
  * :func:`memtrace_counter_events` / :func:`merge_counter_tracks` —
    render a ``memtrace/v1`` artifact (:mod:`repro_torch.obs.memtrace`,
    the JAX package's schema) as Perfetto **counter tracks**
    (``ph: "C"``) and lay them over the engine spans
    of an existing trace, so per-buffer occupancy and per-stage port
    pressure read on the same timeline as the wall-clock work.
"""
from __future__ import annotations

import bisect
import json
import os

import numpy as np

from .trace import TraceEvent

SCHEMA = "obs_trace/v1"

# backoff-delay buckets for the SLO view's retry histogram (seconds)
BACKOFF_BUCKETS_S = (0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25)


# ------------------------------------------------------------------ export
def to_chrome_trace(events: list[TraceEvent],
                    process_name: str = "repro_torch") -> dict:
    """Render completed spans as a Chrome/Perfetto trace dict."""
    pid = os.getpid()
    trace_events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for e in events:
        args = {k: _jsonable(v) for k, v in e.attrs.items()}
        args["depth"] = e.depth
        if e.parent is not None:
            args["parent"] = e.parent
        trace_events.append({
            "name": e.name, "ph": "X", "cat": "repro_torch",
            "ts": e.ts_ns / 1e3, "dur": e.dur_ns / 1e3,
            "pid": pid, "tid": e.tid, "args": args,
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA}}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return str(v)


def write_trace(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def export_global_trace(path: str,
                        process_name: str = "repro_torch") -> dict:
    """Drain the process-global tracer into a validated trace file — the
    backend of a ``--trace out.json`` flag. Raises ValueError if the
    emitted trace fails its own schema check (a trace we cannot validate
    must never become an artifact)."""
    from . import trace
    data = to_chrome_trace(trace.events(), process_name=process_name)
    errs = validate_trace(data)
    if errs:
        raise ValueError("emitted trace failed schema check: "
                         + "; ".join(errs))
    write_trace(path, data)
    return data


# ---------------------------------------------------------------- validate
def validate_trace(data) -> list[str]:
    """Structural schema check; returns error strings (empty = valid)."""
    errs: list[str] = []
    if not isinstance(data, dict):
        return [f"trace must be a dict, got {type(data).__name__}"]
    evs = data.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list 'traceEvents'"]
    schema = (data.get("otherData") or {}).get("schema")
    if schema != SCHEMA:
        errs.append(f"otherData.schema is {schema!r}, expected {SCHEMA!r}")
    if not any(isinstance(e, dict) and e.get("ph") == "X" for e in evs):
        errs.append("trace contains no complete ('X') span events")
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not a dict")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "C"):
            errs.append(f"{where}: ph must be 'X', 'M' or 'C', got {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"{where}: missing span name")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), int):
                errs.append(f"{where}: {k} must be an int")
        if "args" in e and not isinstance(e["args"], dict):
            errs.append(f"{where}: args must be a dict")
        if ph == "X":
            for k in ("ts", "dur"):
                v = e.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    errs.append(f"{where}: {k} must be a number >= 0, "
                                f"got {v!r}")
        elif ph == "C":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"{where}: ts must be a number >= 0, got {ts!r}")
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"{where}: counter args must be a non-empty "
                            f"dict of numeric series")
    return errs


# ---------------------------------------------------------- counter tracks
def memtrace_counter_events(mt: dict, t0_us: float, t1_us: float,
                            pid: int, tid: int = 0) -> list[dict]:
    """Render one ``memtrace/v1`` dict as Perfetto counter events.

    The memtrace lives in the *cycle* domain; the trace in wall-clock µs.
    Cycles ``[0, mt['cycles'])`` are mapped linearly onto
    ``[t0_us, t1_us]`` so the fill ramp, steady state, and drain of one
    simulated frame read against the span that executed it. Emits one
    track per buffer (``mem:<pipeline>:<buffer>``, series ``occupancy``
    and ``capacity``) and one derived pressure track per stage
    (``port:<pipeline>:<stage>``, series ``pressure`` where 1.0 = every
    port busy on the worst block).
    """
    cycles = max(int(mt.get("cycles", 1)), 1)
    scale = (t1_us - t0_us) / cycles
    pipeline = mt.get("pipeline", "?")
    evs: list[dict] = []

    def counter(name: str, t_cycles, series: dict) -> None:
        for i, tc in enumerate(t_cycles):
            evs.append({
                "name": name, "ph": "C", "cat": "memtrace",
                "ts": t0_us + tc * scale, "pid": pid, "tid": tid,
                "args": {k: float(v[i]) for k, v in series.items()},
            })

    for b in mt.get("buffers", []):
        cap = [b["capacity"]] * len(b["t"])
        counter(f"mem:{pipeline}:{b['name']} ({b.get('unit', 'lines')})",
                b["t"], {"occupancy": b["occupancy"], "capacity": cap})
    for st in mt.get("stages", []):
        counter(f"port:{pipeline}:{st['stage']}",
                st["t"], {"pressure": st["port_pressure"]})
    return evs


def merge_counter_tracks(data: dict, memtraces: list[dict]) -> dict:
    """Overlay memtrace counter tracks onto an ``obs_trace/v1`` dict.

    Each memtrace is anchored to the first ``engine.execute`` span whose
    ``pipeline`` attribute matches (fallback: first ``executor.call``
    with the same pipeline; last resort: the whole trace extent), so one
    simulated frame's counters sit exactly under one executed frame's
    span. Mutates and returns ``data``; the result still validates
    under :func:`validate_trace`.
    """
    spans = _span_rows(data)
    if spans:
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e["dur"] for e in spans)
    else:
        lo, hi = 0.0, 1.0
    pid = next((e.get("pid") for e in spans), os.getpid())
    for mt in memtraces:
        pipe = mt.get("pipeline")
        anchor = None
        for name in ("engine.execute", "executor.call"):
            anchor = next(
                (e for e in spans if e["name"] == name
                 and (e.get("args") or {}).get("pipeline") == pipe), None)
            if anchor is not None:
                break
        t0, t1 = ((anchor["ts"], anchor["ts"] + anchor["dur"])
                  if anchor is not None else (lo, hi))
        if t1 <= t0:
            t1 = t0 + 1.0
        data["traceEvents"].extend(
            memtrace_counter_events(mt, t0, t1, pid=pid))
    return data


# --------------------------------------------------------------------- slo
def slo_summary(data: dict) -> dict:
    """SLO view of a trace: the control-plane story the flame summary
    cannot tell. Reads the resilience spans (``resilience.reject/shed/
    retry/fallback``) and the engines' ``engine.step`` delivery
    attributes to compute the deadline-miss rate, the shed and reject
    breakdowns by reason, the retry/backoff-delay histogram, and the
    fallback count by rung — all from a trace *file*, no live process
    needed."""
    delivered = missed = failed = 0
    rejects: dict[str, int] = {}
    sheds: dict[str, int] = {}
    fallbacks: dict[str, int] = {}
    delays: list[float] = []
    for e in _span_rows(data):
        a = e.get("args") or {}
        name = e["name"]
        if name == "engine.step":
            delivered += int(a.get("delivered", a.get("n_frames", 0)))
            missed += int(a.get("deadline_missed", 0))
            failed += int(a.get("failed", 0))
        elif name == "resilience.reject":
            r = str(a.get("reason", "?"))
            rejects[r] = rejects.get(r, 0) + 1
        elif name == "resilience.shed":
            r = str(a.get("reason", "?"))
            sheds[r] = sheds.get(r, 0) + 1
        elif name == "resilience.retry":
            delays.append(float(a.get("delay_s", 0.0)))
        elif name == "resilience.fallback":
            r = str(a.get("rung", "?"))
            fallbacks[r] = fallbacks.get(r, 0) + 1
    counts = [0] * (len(BACKOFF_BUCKETS_S) + 1)
    for d in delays:
        counts[bisect.bisect_left(BACKOFF_BUCKETS_S, d)] += 1
    buckets = {f"le_{b:g}s": c for b, c in zip(BACKOFF_BUCKETS_S, counts)}
    buckets["inf"] = counts[-1]
    return {
        "delivered": delivered,
        "deadline_missed": missed,
        "deadline_miss_rate": missed / delivered if delivered else 0.0,
        "failed": failed,
        "rejected": {"total": sum(rejects.values()), "by_reason": rejects},
        "shed": {"total": sum(sheds.values()), "by_reason": sheds},
        "retries": {
            "count": len(delays),
            "backoff_mean_s": float(np.mean(delays)) if delays else 0.0,
            "backoff_max_s": float(np.max(delays)) if delays else 0.0,
            "backoff_buckets": buckets,
        },
        "fallbacks": {"total": sum(fallbacks.values()),
                      "by_rung": fallbacks},
    }


def slo_text(data: dict) -> str:
    """Terminal rendering of :func:`slo_summary`."""
    s = slo_summary(data)

    def reasons(d: dict) -> str:
        items = sorted(d.items(), key=lambda kv: -kv[1])
        return ", ".join(f"{k}={v}" for k, v in items) or "-"

    lines = [
        "SLO summary",
        f"  delivered            {s['delivered']}",
        f"  deadline missed      {s['deadline_missed']} "
        f"({100.0 * s['deadline_miss_rate']:.2f}%)",
        f"  failed               {s['failed']}",
        f"  rejected             {s['rejected']['total']} "
        f"({reasons(s['rejected']['by_reason'])})",
        f"  shed                 {s['shed']['total']} "
        f"({reasons(s['shed']['by_reason'])})",
        f"  fallback descents    {s['fallbacks']['total']} "
        f"(from: {reasons(s['fallbacks']['by_rung'])})",
        f"  retries              {s['retries']['count']} "
        f"(mean backoff {1e3 * s['retries']['backoff_mean_s']:.2f} ms, "
        f"max {1e3 * s['retries']['backoff_max_s']:.2f} ms)",
    ]
    if s["retries"]["count"]:
        lines.append("  backoff histogram    "
                     + ", ".join(f"{k}={v}" for k, v in
                                 s["retries"]["backoff_buckets"].items()
                                 if v))
    return "\n".join(lines)


# ------------------------------------------------------------------- flame
def _span_rows(data: dict) -> list[dict]:
    return [e for e in data.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"]


def _self_times_us(spans: list[dict]) -> list[float]:
    """Self time per span: dur minus immediate children, by per-thread
    interval containment. Input order is arbitrary; output aligns with
    the input list."""
    self_us = [float(e.get("dur", 0.0)) for e in spans]
    by_tid: dict[int, list[int]] = {}
    for i, e in enumerate(spans):
        by_tid.setdefault(e.get("tid", 0), []).append(i)
    for idxs in by_tid.values():
        # sort by start asc, then duration desc so parents precede children
        idxs.sort(key=lambda i: (spans[i]["ts"], -spans[i]["dur"]))
        stack: list[int] = []
        for i in idxs:
            ts, dur = spans[i]["ts"], spans[i]["dur"]
            while stack and ts >= (spans[stack[-1]]["ts"]
                                   + spans[stack[-1]]["dur"]):
                stack.pop()
            if stack:
                self_us[stack[-1]] -= dur
            stack.append(i)
    return self_us


def flame_summary(data: dict, top: int = 20) -> str:
    """Aggregate per-name text summary, hottest self-time first."""
    spans = _span_rows(data)
    if not spans:
        return "(no spans)"
    self_us = _self_times_us(spans)
    agg: dict[str, dict] = {}
    for e, s in zip(spans, self_us):
        a = agg.setdefault(e["name"], {"n": 0, "total": 0.0, "self": 0.0,
                                       "durs": []})
        a["n"] += 1
        a["total"] += e["dur"]
        a["self"] += s
        a["durs"].append(e["dur"])
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["self"])[:top]
    wall = (max(e["ts"] + e["dur"] for e in spans)
            - min(e["ts"] for e in spans))
    out = [f"{'span':<28} {'count':>6} {'total ms':>10} {'self ms':>10} "
           f"{'self %':>7} {'mean ms':>9} {'p95 ms':>9}"]
    for name, a in rows:
        durs = np.asarray(a["durs"])
        out.append(
            f"{name:<28} {a['n']:>6} {a['total'] / 1e3:>10.2f} "
            f"{a['self'] / 1e3:>10.2f} "
            f"{100.0 * a['self'] / wall if wall else 0.0:>6.1f}% "
            f"{float(durs.mean()) / 1e3:>9.3f} "
            f"{float(np.percentile(durs, 95)) / 1e3:>9.3f}")
    out.append(f"{'(trace wall)':<28} {'':>6} {wall / 1e3:>10.2f}")
    return "\n".join(out)
