"""Join predicted and measured performance into an attribution report.

The output is the ``perf_report/v1`` artifact of the JAX package: per
pipeline, the analytic model's cycles/bytes/power next to the measured
fps / counted launch bytes / trace time-split, reduced to ratios a
reader (or the regression gate) can read at a glance:

  * **efficiency** — achieved / predicted throughput. Cycles only turn
    into seconds through a clock, and the generated accelerator has no
    clock on a GPU, so the report calibrates an *effective clock* from
    the run itself: the pipeline with the highest ``cycles_per_frame x
    fps`` product defines ``clock_hz`` (its efficiency is exactly 1.0);
    every other pipeline's efficiency is its achieved pixel rate
    relative to that calibration. This makes efficiency a
    machine-independent, within-run measure of how far each pipeline
    falls short of the analytic steady state.
  * **bytes amplification** — the launch's counted bytes loaded and
    stored per frame (:func:`repro_torch.perf.measure.executor_cost`)
    over the model's bytes moved per frame (device memory plus
    line-buffer traffic).
  * **time fractions** — assemble / execute / engine-other shares of
    the engine step (from the obs trace), normalized by
    :func:`repro_torch.perf.model.exact_fractions` so they provably sum
    to 1.
  * **bound** — the DMA-bound vs compute-bound roofline classification
    (:func:`repro_torch.perf.measure.classify`) per pipeline.

The report's ``config`` is the caller's: on the card it records the
card's name and power limit (:func:`repro_torch.perf.measure.card_info`)
and where the peaks came from. ``validate_perf_report`` is the schema
gate over the emitted artifact.
"""
from __future__ import annotations

import math

from .measure import MeasuredPerf, Peaks, classify
from .model import PerfModel, exact_fractions

PERF_SCHEMA = "perf_report/v1"
FRACTION_TOL = 1e-9


def effective_clock_hz(pairs: list[tuple[PerfModel, MeasuredPerf]]) -> float:
    """Within-run clock calibration: the best achieved cycles/sec."""
    rates = [m.cycles_per_frame * meas.fps for m, meas in pairs]
    return max(rates) if rates else 0.0


def attribute(model: PerfModel, meas: MeasuredPerf, clock_hz: float,
              peaks: Peaks, breakdown: dict | None = None) -> dict:
    """One pipeline's joined model-vs-measured entry."""
    predicted_fps = (model.predicted_fps(clock_hz) if clock_hz else 0.0)
    entry = {
        "pipeline": model.pipeline,
        "h": model.h, "w": model.w,
        "model": model.to_dict(),
        "measured": meas.to_dict(),
        "predicted_fps": predicted_fps,
        "efficiency": meas.fps / predicted_fps if predicted_fps else 0.0,
        "bytes_amplification": (
            meas.bytes_per_frame / model.bytes_per_frame
            if meas.bytes_per_frame is not None and model.bytes_per_frame
            else None),
    }
    if meas.flops_per_frame is not None and meas.bytes_per_frame is not None:
        entry["roofline"] = classify(meas.flops_per_frame,
                                     meas.bytes_per_frame, peaks)
    else:  # cost analysis unavailable: fall back to the model's traffic
        entry["roofline"] = classify(0.0, float(model.bytes_per_frame),
                                     peaks)
        entry["roofline"]["from_model_traffic"] = True
    if breakdown is not None:
        other = max(breakdown["step_s"] - breakdown["assemble_s"]
                    - breakdown["execute_s"], 0.0)
        entry["step_breakdown"] = breakdown
        entry["time_fractions"] = exact_fractions({
            "assemble": breakdown["assemble_s"],
            "execute": breakdown["execute_s"],
            "engine_other": other,
        })
    return entry


def build_report(entries: list[dict], config: dict, peaks: Peaks,
                 clock_hz: float) -> dict:
    """Assemble the schema-stamped ``perf_report/v1`` artifact."""
    bounds = [e["roofline"]["bound"] for e in entries]
    effs = [e["efficiency"] for e in entries if e["efficiency"] > 0]
    amps = [e["bytes_amplification"] for e in entries
            if e.get("bytes_amplification")]
    summary = {
        "n_pipelines": len(entries),
        "dma_bound": sum(1 for b in bounds if b == "dma"),
        "compute_bound": sum(1 for b in bounds if b == "compute"),
        "efficiency_geomean": (math.exp(sum(map(math.log, effs)) / len(effs))
                               if effs else 0.0),
        "efficiency_worst": min(effs) if effs else 0.0,
        "bytes_amplification_geomean": (
            math.exp(sum(map(math.log, amps)) / len(amps)) if amps else None),
    }
    return {"schema": PERF_SCHEMA, "config": config,
            "peaks": peaks.to_dict(), "clock_hz": clock_hz,
            "pipelines": entries, "summary": summary}


# ---------------------------------------------------------------- schema
_ENTRY_KEYS = ("pipeline", "h", "w", "model", "measured", "predicted_fps",
               "efficiency", "roofline")
_MODEL_KEYS = ("cycles_per_frame", "bytes_per_frame", "hbm_bytes_per_frame",
               "sram_bytes_per_frame", "power_total", "port_slack")
_MEASURED_KEYS = ("fps", "wall_s", "frames")


def _check_fractions(errs: list[str], where: str, fr) -> None:
    if not isinstance(fr, dict):
        errs.append(f"{where}: fractions must be a dict")
        return
    for k, v in fr.items():
        if not isinstance(v, (int, float)) or v < 0 or v > 1:
            errs.append(f"{where}[{k}]: fraction must be in [0, 1], "
                        f"got {v!r}")
    if fr and abs(math.fsum(fr.values()) - 1.0) > FRACTION_TOL:
        errs.append(f"{where}: fractions sum to "
                    f"{math.fsum(fr.values())!r}, expected 1.0")


def validate_perf_report(data) -> list[str]:
    """Structural schema check; returns error strings (empty = valid)."""
    errs: list[str] = []
    if not isinstance(data, dict):
        return [f"report must be a dict, got {type(data).__name__}"]
    if data.get("schema") != PERF_SCHEMA:
        errs.append(f"schema is {data.get('schema')!r}, "
                    f"expected {PERF_SCHEMA!r}")
    pipes = data.get("pipelines")
    if not isinstance(pipes, list) or not pipes:
        return errs + ["missing or empty 'pipelines' list"]
    if not isinstance(data.get("clock_hz"), (int, float)) \
            or data["clock_hz"] <= 0:
        errs.append("clock_hz must be a positive number")
    for i, e in enumerate(pipes):
        where = f"pipelines[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not a dict")
            continue
        for k in _ENTRY_KEYS:
            if k not in e:
                errs.append(f"{where}: missing key {k!r}")
        if not isinstance(e.get("efficiency"), (int, float)) \
                or e.get("efficiency", -1) < 0:
            errs.append(f"{where}: efficiency must be a number >= 0")
        roof = e.get("roofline")
        if not isinstance(roof, dict) \
                or roof.get("bound") not in ("dma", "compute"):
            errs.append(f"{where}: roofline.bound must be 'dma' or "
                        f"'compute'")
        m = e.get("model")
        if isinstance(m, dict):
            for k in _MODEL_KEYS:
                if not isinstance(m.get(k), (int, float)):
                    errs.append(f"{where}.model: missing numeric {k!r}")
            for fk in ("traffic_fractions", "sram_fractions",
                       "power_fractions"):
                if fk in m:
                    _check_fractions(errs, f"{where}.model.{fk}", m[fk])
        elif m is not None:
            errs.append(f"{where}: model must be a dict")
        meas = e.get("measured")
        if isinstance(meas, dict):
            for k in _MEASURED_KEYS:
                if not isinstance(meas.get(k), (int, float)):
                    errs.append(f"{where}.measured: missing numeric {k!r}")
        elif meas is not None:
            errs.append(f"{where}: measured must be a dict")
        if "time_fractions" in e:
            _check_fractions(errs, f"{where}.time_fractions",
                             e["time_fractions"])
    return errs


# ---------------------------------------------------------------- render
def perf_text(data: dict) -> str:
    """Terminal table of a ``perf_report/v1`` dict."""
    rows = [f"{'pipeline':>14} {'h':>4} {'w':>5} {'cyc/frame':>10} "
            f"{'pred f/s':>9} {'meas f/s':>9} {'eff':>6} {'bytes x':>8} "
            f"{'bound':>8} {'slack':>5} {'exec %':>7}"]
    for e in data.get("pipelines", []):
        m, meas = e["model"], e["measured"]
        amp = e.get("bytes_amplification")
        tf = e.get("time_fractions") or {}
        rows.append(
            f"{e['pipeline']:>14} {e['h']:>4} {e['w']:>5} "
            f"{m['cycles_per_frame']:>10} {e['predicted_fps']:>9.1f} "
            f"{meas['fps']:>9.1f} {e['efficiency']:>6.2f} "
            + (f"{amp:>8.2f} " if amp is not None else f"{'-':>8} ")
            + f"{e['roofline']['bound']:>8} {m['port_slack']:>5} "
            + (f"{100 * tf.get('execute', 0):>6.1f}%"
               if tf else f"{'-':>7}"))
    s = data.get("summary", {})
    rows.append(
        f"summary: {s.get('n_pipelines', 0)} pipelines, "
        f"{s.get('dma_bound', 0)} dma-bound / "
        f"{s.get('compute_bound', 0)} compute-bound, "
        f"efficiency geomean {s.get('efficiency_geomean', 0):.2f} "
        f"(worst {s.get('efficiency_worst', 0):.2f}), "
        f"clock {data.get('clock_hz', 0) / 1e6:.2f} Mpx/s")
    return "\n".join(rows)


# ------------------------------------------------------------------ diff
def _rel(a: float, b: float) -> float:
    return (b - a) / a if a else 0.0


def perf_diff(a: dict, b: dict, tol: float = 0.10) -> dict:
    """Pipeline-by-pipeline comparison of two ``perf_report/v1`` dicts.

    The regression-triage view between two runs: for every
    (pipeline, h, w) cell present in both reports, the relative deltas
    of measured fps, predicted fps, efficiency, bytes amplification,
    and the execute time fraction, flagged when the throughput moves by
    more than ``tol`` in either direction. Cells present in only one
    report surface as added/removed rather than silently dropping.
    """
    def key(e):
        return (e["pipeline"], e["h"], e["w"])

    ea = {key(e): e for e in a.get("pipelines", [])}
    eb = {key(e): e for e in b.get("pipelines", [])}
    rows: list[dict] = []
    for k in sorted(set(ea) | set(eb)):
        pipeline, h, w = k
        if k not in eb:
            rows.append({"pipeline": pipeline, "h": h, "w": w,
                         "status": "removed"})
            continue
        if k not in ea:
            rows.append({"pipeline": pipeline, "h": h, "w": w,
                         "status": "added",
                         "fps_b": eb[k]["measured"]["fps"]})
            continue
        x, y = ea[k], eb[k]
        fps_a, fps_b = x["measured"]["fps"], y["measured"]["fps"]
        d_fps = _rel(fps_a, fps_b)
        amp_a, amp_b = (x.get("bytes_amplification"),
                        y.get("bytes_amplification"))
        tf_a = (x.get("time_fractions") or {}).get("execute")
        tf_b = (y.get("time_fractions") or {}).get("execute")
        rows.append({
            "pipeline": pipeline, "h": h, "w": w,
            "status": ("regressed" if d_fps < -tol
                       else "improved" if d_fps > tol else "ok"),
            "fps_a": fps_a, "fps_b": fps_b, "fps_rel": d_fps,
            "predicted_fps_rel": _rel(x["predicted_fps"],
                                      y["predicted_fps"]),
            "efficiency_a": x["efficiency"], "efficiency_b": y["efficiency"],
            "bytes_amplification_delta": (
                amp_b - amp_a if amp_a is not None and amp_b is not None
                else None),
            "execute_fraction_delta": (
                tf_b - tf_a if tf_a is not None and tf_b is not None
                else None),
        })
    compared = [r for r in rows if "fps_rel" in r]
    return {
        "tol": tol,
        "rows": rows,
        "summary": {
            "n_compared": len(compared),
            "n_regressed": sum(r["status"] == "regressed"
                               for r in compared),
            "n_improved": sum(r["status"] == "improved" for r in compared),
            "n_added": sum(r["status"] == "added" for r in rows),
            "n_removed": sum(r["status"] == "removed" for r in rows),
            "worst_fps_rel": min((r["fps_rel"] for r in compared),
                                 default=0.0),
            "best_fps_rel": max((r["fps_rel"] for r in compared),
                                default=0.0),
        },
    }


def perf_diff_text(diff: dict) -> str:
    """Terminal table of :func:`perf_diff`."""
    tol = diff["tol"]
    rows = [f"{'pipeline':>14} {'h':>4} {'w':>5} {'A f/s':>9} {'B f/s':>9} "
            f"{'delta':>8} {'eff A':>6} {'eff B':>6} {'d exec%':>8} "
            f"{'status':>10}"]
    for r in diff["rows"]:
        if "fps_rel" not in r:
            rows.append(f"{r['pipeline']:>14} {r['h']:>4} {r['w']:>5} "
                        f"{'-':>9} {r.get('fps_b', 0.0):>9.1f} {'-':>8} "
                        f"{'-':>6} {'-':>6} {'-':>8} {r['status']:>10}")
            continue
        mark = " <-" if r["status"] in ("regressed", "improved") else ""
        dexec = r["execute_fraction_delta"]
        rows.append(
            f"{r['pipeline']:>14} {r['h']:>4} {r['w']:>5} "
            f"{r['fps_a']:>9.1f} {r['fps_b']:>9.1f} "
            f"{100.0 * r['fps_rel']:>+7.1f}% "
            f"{r['efficiency_a']:>6.2f} {r['efficiency_b']:>6.2f} "
            + (f"{100.0 * dexec:>+7.1f}% " if dexec is not None
               else f"{'-':>8} ")
            + f"{r['status']:>10}{mark}")
    s = diff["summary"]
    rows.append(
        f"diff: {s['n_compared']} cells compared (tol ±{100 * tol:.0f}%), "
        f"{s['n_regressed']} regressed, {s['n_improved']} improved, "
        f"{s['n_added']} added, {s['n_removed']} removed; "
        f"worst {100 * s['worst_fps_rel']:+.1f}%, "
        f"best {100 * s['best_fps_rel']:+.1f}%")
    return "\n".join(rows)
