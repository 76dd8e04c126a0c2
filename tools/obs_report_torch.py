"""Render the PyTorch port's obs artifacts: traces, perf attribution,
memtraces, alerts.

    PYTHONPATH=src python tools/obs_report_torch.py trace.json
    PYTHONPATH=src python tools/obs_report_torch.py trace.json --top 30
    PYTHONPATH=src python tools/obs_report_torch.py trace.json --validate
    PYTHONPATH=src python tools/obs_report_torch.py trace.json --slo
    PYTHONPATH=src python tools/obs_report_torch.py trace.json --out clean.json
    PYTHONPATH=src python tools/obs_report_torch.py report.json --perf
    PYTHONPATH=src python tools/obs_report_torch.py memtrace.json --memtrace
    PYTHONPATH=src python tools/obs_report_torch.py snapshot.json --alerts
    PYTHONPATH=src python tools/obs_report_torch.py --diff A.json B.json

The twin of ``tools/obs_report.py`` over ``repro_torch.obs`` and
``repro_torch.perf.attribution``: the same renderers, flags and exit codes,
and the same schemas, so it reads the JAX package's artifacts as well as
the port's. Input is any schema-stamped obs artifact; the stamp picks the
renderer (a flag forces it):

  * ``obs_trace/v1`` — span trace (``repro_torch.obs.export``; the
    examples' ``trace_serving.json``). Default: aggregate flame summary
    (per span name: call count, total/self wall time, mean, p95).
    ``--slo`` switches to the control-plane view (deadline misses,
    shed/reject breakdown, retry histogram). ``--out`` re-writes the trace
    normalized for ui.perfetto.dev / chrome://tracing.
  * ``perf_report/v1`` — model-vs-measured attribution table
    (``repro_torch.perf.attribution.build_report``; ``--perf`` forces it).
  * ``memtrace/v1`` — cycle-level buffer table from
    ``PlanCache.memtrace_for``: per buffer the allocation (the port's: the
    rows of its shared-memory ring), simulated peak occupancy, waste
    fraction, worst port pressure, and conflict-stall cycles
    (``--memtrace`` forces it).
  * ``telemetry/v1`` — a ``TelemetryCollector`` snapshot (the HTTP
    ``/snapshot`` payload or the chaos harness's telemetry section): the
    SLO alert table with firing state and recent transitions
    (``--alerts`` forces it; exit 1 when an alert is firing).

``--diff A B`` compares two ``perf_report/v1`` artifacts pipeline by
pipeline — throughput / efficiency / execute-fraction deltas with cells
beyond ``--tol`` highlighted.

``--validate`` exits nonzero if the file fails its schema check (trace,
perf report, and memtrace alike).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.obs import export, memtrace, telemetry  # noqa: E402
from repro_torch.perf import attribution  # noqa: E402


def _render_perf(path: str, data: dict, validate_only: bool) -> int:
    errs = attribution.validate_perf_report(data)
    if errs:
        print(f"{path}: INVALID perf_report ({len(errs)} schema errors)")
        for e in errs[:20]:
            print(f"  - {e}")
        return 1
    if validate_only:
        n = len(data["pipelines"])
        print(f"{path}: valid perf_report/v1 ({n} pipelines)")
        return 0
    print(attribution.perf_text(data))
    return 0


def _render_memtrace(path: str, data: dict, validate_only: bool) -> int:
    errs = memtrace.validate_memtrace(data)
    if errs:
        print(f"{path}: INVALID memtrace ({len(errs)} schema errors)")
        for e in errs[:20]:
            print(f"  - {e}")
        return 1
    if validate_only:
        n = len(data["buffers"])
        print(f"{path}: valid memtrace/v1 ({data['pipeline']}, "
              f"{n} buffers)")
        return 0
    print(memtrace.memtrace_text(data))
    return 0


def _render_alerts(path: str, data: dict) -> int:
    alerts = data.get("alerts")
    if alerts is None:
        print(f"{path}: no 'alerts' section "
              f"(schema {data.get('schema')!r})")
        return 1
    print(telemetry.alerts_text(alerts))
    return 1 if any(a.get("firing") for a in alerts) else 0


def _render_diff(path_a: str, path_b: str, tol: float) -> int:
    out = []
    for p in (path_a, path_b):
        with open(p) as f:
            data = json.load(f)
        errs = attribution.validate_perf_report(data)
        if errs:
            print(f"{p}: INVALID perf_report ({len(errs)} schema errors)")
            for e in errs[:10]:
                print(f"  - {e}")
            return 1
        out.append(data)
    diff = attribution.perf_diff(out[0], out[1], tol=tol)
    print(f"perf diff: A={path_a}  B={path_b}")
    print(attribution.perf_diff_text(diff))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Flame/SLO/perf/memtrace/alert summary + validation "
                    "for obs artifacts")
    ap.add_argument("trace", nargs="?", default=None,
                    help="artifact JSON: an obs trace, perf report, "
                         "memtrace, or telemetry snapshot")
    ap.add_argument("--top", type=int, default=20,
                    help="rows in the flame summary")
    ap.add_argument("--out", default=None, metavar="OUT_JSON",
                    help="write a normalized copy of the trace here")
    ap.add_argument("--validate", action="store_true",
                    help="exit nonzero if the file fails its schema check")
    ap.add_argument("--slo", action="store_true",
                    help="print the SLO summary (deadline misses, "
                         "shed/reject breakdown, retry histogram) instead "
                         "of the flame summary")
    ap.add_argument("--perf", action="store_true",
                    help="render the file as a perf_report/v1 attribution "
                         "table")
    ap.add_argument("--memtrace", action="store_true",
                    help="render the file as a memtrace/v1 buffer table")
    ap.add_argument("--alerts", action="store_true",
                    help="render the SLO alert table of a telemetry "
                         "snapshot (exit 1 if any alert is firing)")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="compare two perf_report/v1 artifacts pipeline "
                         "by pipeline")
    ap.add_argument("--tol", type=float, default=0.10,
                    help="relative fps delta beyond which --diff flags a "
                         "cell (default 0.10)")
    args = ap.parse_args(argv)

    if args.diff is not None:
        return _render_diff(args.diff[0], args.diff[1], args.tol)
    if args.trace is None:
        ap.error("an artifact file is required (or use --diff A B)")

    with open(args.trace) as f:
        raw = json.load(f)
    schema = raw.get("schema") if isinstance(raw, dict) else None
    if args.perf or schema == attribution.PERF_SCHEMA:
        return _render_perf(args.trace, raw, args.validate)
    if args.memtrace or schema == memtrace.MEMTRACE_SCHEMA:
        return _render_memtrace(args.trace, raw, args.validate)
    if args.alerts or schema == telemetry.TELEMETRY_SCHEMA:
        return _render_alerts(args.trace, raw)

    data = export.load_trace(args.trace)
    errs = export.validate_trace(data)
    if errs:
        print(f"{args.trace}: INVALID ({len(errs)} schema errors)")
        for e in errs[:20]:
            print(f"  - {e}")
        if args.validate:
            return 1
    elif args.validate:
        n = sum(1 for e in data["traceEvents"] if e.get("ph") == "X")
        n_c = sum(1 for e in data["traceEvents"] if e.get("ph") == "C")
        names = sorted({e["name"] for e in data["traceEvents"]
                        if e.get("ph") == "X"})
        counters = f", {n_c} counter samples" if n_c else ""
        print(f"{args.trace}: valid ({n} spans{counters}: "
              f"{', '.join(names)})")
        return 0

    if args.slo:
        print(export.slo_text(data))
    else:
        print(export.flame_summary(data, top=args.top))

    if args.out:
        export.write_trace(args.out, data)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
