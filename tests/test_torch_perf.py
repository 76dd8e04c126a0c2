"""Port performance-attribution lab: model, fractions, ledger, gate,
schema, counted launch costs and measurement, held against the JAX
package.

The contracts of tests/test_perf.py, held by ``repro_torch.perf``; then
the same inputs through both packages: ``predict(...).to_dict()`` equal
field for field for the 11 registered pipelines (two widths, R in
{1, 8}, prefetch depth in {1, 2}, the default DP combo and the
autotuner's), equal reports, diffs, ledger rows, fingerprints, gate
verdicts and step breakdowns. The measured side runs on the CPU here
(``device="cpu"``: the kernel's plain version); its launch counts are
held against a hand count of the kernel's geometry.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core import codegen as jax_codegen
from repro.core import dse as jax_dse
from repro.core import linebuffer as jax_linebuffer
from repro.obs import export as jax_export
from repro.perf import attribution as jax_attribution
from repro.perf import ledger as jax_ledger
from repro.perf import measure as jax_measure
from repro.perf import model as jax_model
from repro_torch.core import DP, algorithms, compile_pipeline, dse
from repro_torch.core.algorithms import conv_fn, gauss1d
from repro_torch.core.dsl import Pipeline
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.obs import Tracer, export
from repro_torch.perf import attribution, ledger, measure
from repro_torch.perf import model as perf_model
from repro_torch.perf.measure import MeasuredPerf, Peaks, classify

PEAKS = Peaks(flops_per_s=1e11, hbm_bytes_per_s=1e10)
JAX_PEAKS = jax_measure.Peaks(flops_per_s=1e11, hbm_bytes_per_s=1e10)
NAMES = sorted(algorithms.ALGORITHMS) + sorted(algorithms.VIDEO_ALGORITHMS)
WIDTHS = (24, 40)


def _conv_chain(name: str, k: int):
    """input -> one k x k convolution -> output."""
    p = Pipeline(name)
    x = p.input("in")
    w = np.outer(gauss1d(k), gauss1d(k)).astype(np.float32)
    c = p.stage("c", [(x, k, k)], conv_fn(w))
    p.output("out", [(c, 1, 1)])
    return p.build()


def _predict(dag, w: int, h: int) -> perf_model.PerfModel:
    return perf_model.predict(compile_pipeline(dag, w, mem=DP), h)


def _dag(name):
    return (algorithms.ALGORITHMS.get(name)
            or algorithms.VIDEO_ALGORITHMS[name])()


def _jax_dag(name):
    return (jax_algorithms.ALGORITHMS.get(name)
            or jax_algorithms.VIDEO_ALGORITHMS[name])()


# ----------------------------------------------------------- model side
def test_predicted_cycles_monotone_in_shape():
    dag = algorithms.ALGORITHMS["unsharp-m"]()
    base = _predict(dag, 32, 16)
    wider = _predict(dag, 64, 16)
    taller = _predict(dag, 32, 48)
    # steady state is 1 px/cycle: cycles grow with both frame dimensions
    assert wider.cycles_per_frame > base.cycles_per_frame
    assert taller.cycles_per_frame > base.cycles_per_frame
    # widening also deepens the line buffers -> longer pipeline fill
    assert wider.fill_cycles > base.fill_cycles
    # height only scales the steady-state term, never the fill latency
    assert taller.fill_cycles == base.fill_cycles
    assert (taller.steady_cycles_per_frame
            == 3 * base.steady_cycles_per_frame)


def test_predicted_cycles_monotone_in_stencil_extent():
    small = _predict(_conv_chain("k3", 3), 32, 16)
    large = _predict(_conv_chain("k5", 5), 32, 16)
    # a taller stencil needs more buffered lines before the first output
    assert large.fill_cycles > small.fill_cycles
    assert large.cycles_per_frame > small.cycles_per_frame
    # and the wider window raises the per-cycle SRAM traffic
    assert large.sram_bytes_per_frame > small.sram_bytes_per_frame


def test_model_fractions_partition_exactly():
    m = _predict(algorithms.ALGORITHMS["harris-s"](), 32, 16)
    for fr in (m.traffic_fractions, m.sram_fractions, m.power_fractions):
        assert fr, "expected non-empty fractions"
        assert math.fsum(fr.values()) == 1.0
        assert all(0.0 <= v <= 1.0 for v in fr.values())
    assert m.hbm_bytes_per_frame > 0
    assert m.sram_bytes_per_frame > 0
    assert m.bytes_per_frame == (m.hbm_bytes_per_frame
                                 + m.sram_bytes_per_frame)


def test_exact_fractions():
    fr = perf_model.exact_fractions({"a": 1.0, "b": 2.0, "c": 0.1})
    assert math.fsum(fr.values()) == 1.0
    assert fr["b"] > fr["a"] > fr["c"]
    # pathological ratios still partition exactly
    fr = perf_model.exact_fractions({c: (i + 1) * 1e-7 for i, c in
                                     enumerate("abcdefghijk")})
    assert math.fsum(fr.values()) == 1.0
    assert perf_model.exact_fractions({}) == {}
    assert perf_model.exact_fractions({"a": 0.0}) == {}
    with pytest.raises(ValueError):
        perf_model.exact_fractions({"a": 1.0, "b": -0.5})


@pytest.mark.parametrize("parts", [
    {"a": 1.0, "b": 2.0, "c": 0.1},
    {c: (i + 1) * 1e-7 for i, c in enumerate("abcdefghijk")},
    {"x": 3.0}, {}, {"a": 0.0, "b": 0.0},
    {"assemble": 0.0123, "execute": 0.7071, "engine_other": 1e-9},
])
def test_exact_fractions_match_the_reference(parts):
    assert perf_model.exact_fractions(parts) \
        == jax_model.exact_fractions(parts)


@pytest.mark.parametrize("seed", range(4))
def test_exact_fractions_always_partition(seed):
    """The port's fractions fsum to exactly 1.0 on every input; they
    equal the JAX package's wherever the JAX package's do (its
    ``1 - fsum(others)`` rounds twice and misses 1.0 by one ULP on a few
    percent of inputs, which this draw includes)."""
    rng = np.random.RandomState(seed)
    missed = 0
    for _ in range(3000):
        n = rng.randint(1, 8)
        parts = {f"p{j}": float(rng.rand() * 10.0 ** rng.uniform(-8, 3))
                 for j in range(n)}
        got, ref = perf_model.exact_fractions(parts), \
            jax_model.exact_fractions(parts)
        assert math.fsum(got.values()) == 1.0
        assert all(0.0 <= v <= 1.0 for v in got.values())
        if math.fsum(ref.values()) == 1.0:
            assert got == ref
        else:
            missed += 1
            assert got.keys() == ref.keys()
            assert max(abs(got[k] - ref[k]) for k in got) <= 2.0 ** -52
    assert missed > 0


def _tuned_combo(name: str, w: int) -> dict[str, str]:
    return {s: c.name
            for s, c in dse.autotune(_dag(name), w).best.mem_cfg.items()}


_JAX_CFGS = {c.name: c for c in (jax_linebuffer.SP, jax_linebuffer.DP,
                                 jax_linebuffer.QP, jax_linebuffer.DPLC,
                                 jax_dse.DPLC2)}
_CFGS = {c.name: c for c in dse.TUNE_OPTIONS}


@pytest.mark.parametrize("tuned", [False, True], ids=["DP", "tuned"])
@pytest.mark.parametrize("name", NAMES)
def test_predict_equals_the_reference(name, tuned):
    """``predict(plan, h).to_dict()`` equals the JAX package's field for
    field on equal plans: two widths, R in {1, 8}, prefetch depth in
    {1, 2}, the DP combo or the port autotuner's winner (its combo
    compiled in both packages)."""
    for w in WIDTHS:
        if tuned:
            combo = _tuned_combo(name, w)
            mem = {s: _CFGS[c] for s, c in combo.items()}
            jax_mem = {s: _JAX_CFGS[c] for s, c in combo.items()}
        else:
            mem, jax_mem = DP, jax_linebuffer.DP
        base = compile_pipeline(_dag(name), w, mem=mem)
        jax_base = jax_codegen.compile_pipeline(_jax_dag(name), w,
                                                mem=jax_mem)
        for r in (1, 8):
            for d in (1, 2):
                plan = dataclasses.replace(base, rows_per_step=r,
                                           prefetch_depth=d)
                jax_plan = dataclasses.replace(jax_base, rows_per_step=r,
                                               prefetch_depth=d)
                for h in (w // 2 + 3, 2 * w):
                    got = perf_model.predict(plan, h).to_dict()
                    exp = jax_model.predict(jax_plan, h).to_dict()
                    assert got == exp, (name, w, r, d, h)


def test_dse_depth_axis_reads_the_perf_model():
    """The autotuner's depth axis classifies with the perf model's DMA
    accounting (one home for it) and equals the reference's."""
    assert not hasattr(dse, "DMA_BYTES_PER_CYCLE")
    assert not hasattr(dse, "_hbm_bytes")
    assert perf_model.DMA_BYTES_PER_CYCLE \
        == jax_model.DMA_BYTES_PER_CYCLE == 16
    for name in ("tbackground-t", "unsharp-m"):
        res = dse.autotune(_dag(name), 24, prefetch_depths=(1, 2))
        jres = jax_dse.autotune(_jax_dag(name), 24, prefetch_depths=(1, 2))
        assert (res.bound, res.best_depth) == (jres.bound, jres.best_depth)


# -------------------------------------------------------------- roofline
def test_classify_bounds():
    # intensity far below the ridge (10 flops/byte) -> DMA-bound
    lo = classify(flops=1e3, bytes_moved=1e6, peaks=PEAKS)
    assert lo["bound"] == "dma"
    assert lo["t_memory_s"] > lo["t_compute_s"]
    # far above -> compute-bound
    hi = classify(flops=1e9, bytes_moved=1e3, peaks=PEAKS)
    assert hi["bound"] == "compute"
    # exactly at the ridge: transfers are what overlap would hide
    ridge = classify(flops=PEAKS.ridge_intensity * 1e6, bytes_moved=1e6,
                     peaks=PEAKS)
    assert ridge["bound"] == "dma"


@pytest.mark.parametrize("flops,nbytes", [(1e3, 1e6), (1e9, 1e3), (0, 0),
                                          (1e7, 1e6), (5.5e9, 3.3e8)])
def test_classify_and_peaks_match_the_reference(flops, nbytes):
    assert classify(flops, nbytes, PEAKS) \
        == jax_measure.classify(flops, nbytes, JAX_PEAKS)
    assert PEAKS.to_dict() == JAX_PEAKS.to_dict()


def test_peaks_hold_no_tpu_figure():
    """The port's peaks are the card's: its data sheets and its own
    probes; no TPU constant carries over."""
    assert not [k for k in vars(measure) if k.startswith("TPU")]
    h100 = measure.datasheet_peaks("NVIDIA H100 80GB HBM3")
    assert (h100.flops_per_s, h100.hbm_bytes_per_s) == (67e12, 3.35e12)
    assert measure.datasheet_peaks("NVIDIA H100 PCIe").hbm_bytes_per_s \
        == 2.0e12
    assert measure.datasheet_peaks("NVIDIA H200").hbm_bytes_per_s == 4.8e12


def test_calibrate_on_the_host():
    peaks = measure.calibrate(device="cpu", reps=2)
    assert np.isfinite([peaks.flops_per_s, peaks.hbm_bytes_per_s]).all()
    assert peaks.flops_per_s > 0 and peaks.hbm_bytes_per_s > 0


def test_calibrate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests calibrate it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.calibrate()


# ----------------------------------------------------- attribution report
_BREAKDOWN = {"n_steps": 4, "step_s": 0.40, "queue_wait_s": 0.01,
              "assemble_s": 0.05, "execute_s": 0.30, "step_self_s": 0.02}


def _report_for(m: perf_model.PerfModel) -> dict:
    meas = MeasuredPerf(pipeline=m.pipeline, h=m.h, w=m.w, frames=8,
                        wall_s=0.5, fps=16.0,
                        flops_per_frame=1e4, bytes_per_frame=2e5)
    clock = attribution.effective_clock_hz([(m, meas)])
    entry = attribution.attribute(m, meas, clock, PEAKS,
                                  breakdown=_BREAKDOWN)
    return attribution.build_report([entry], {"test": True}, PEAKS, clock)


def test_attribution_report_valid_and_partitioned():
    rep = _report_for(_predict(algorithms.ALGORITHMS["unsharp-m"](),
                               32, 16))
    assert attribution.validate_perf_report(rep) == []
    (entry,) = rep["pipelines"]
    # the calibrating pipeline has efficiency exactly 1
    assert entry["efficiency"] == pytest.approx(1.0)
    assert entry["roofline"]["bound"] in ("dma", "compute")
    assert math.fsum(entry["time_fractions"].values()) == 1.0
    assert entry["bytes_amplification"] == pytest.approx(
        2e5 / entry["model"]["bytes_per_frame"])
    # renders without raising, one row per pipeline + header + summary
    assert len(attribution.perf_text(rep).splitlines()) == 3


def test_validate_perf_report_rejects():
    rep = _report_for(_predict(algorithms.ALGORITHMS["unsharp-m"](),
                               32, 16))
    bad = json.loads(json.dumps(rep))           # deep copy
    bad["pipelines"][0]["efficiency"] = -0.5
    bad["pipelines"][0]["roofline"]["bound"] = "banana"
    bad["pipelines"][0]["model"]["traffic_fractions"] = {"hbm": 0.9,
                                                         "sram": 0.2}
    errs = attribution.validate_perf_report(bad)
    assert any("efficiency" in e for e in errs)
    assert any("roofline.bound" in e for e in errs)
    assert any("traffic_fractions" in e for e in errs)
    assert attribution.validate_perf_report({"schema": "nope"})
    assert attribution.validate_perf_report([1, 2])
    # both packages' validators say the same of the same artifact
    for data in (rep, bad, {"schema": "nope"}, [1, 2]):
        assert attribution.validate_perf_report(data) \
            == jax_attribution.validate_perf_report(data)


def _reports(fps_scale: float):
    """One report of four pipelines from each package, on equal models
    and equal measured numbers."""
    both = ([], [])
    for i, name in enumerate(("unsharp-m", "harris-s", "tmotion-t",
                              "xcorr-m")):
        m = _predict(_dag(name), 32, 16)
        jm = jax_model.predict(
            jax_codegen.compile_pipeline(_jax_dag(name), 32,
                                         mem=jax_linebuffer.DP), 16)
        fields = dict(pipeline=m.pipeline, h=16, w=32, frames=8,
                      wall_s=0.5 / (i + 1), fps=16.0 * (i + 1) * fps_scale,
                      flops_per_frame=1e4 * (i + 1),
                      bytes_per_frame=None if i == 3 else 2e5 * (i + 1))
        both[0].append((m, MeasuredPerf(**fields)))
        both[1].append((jm, jax_measure.MeasuredPerf(**fields)))
    port = [attribution.attribute(m, meas,
                                  attribution.effective_clock_hz(both[0]),
                                  PEAKS,
                                  breakdown=_BREAKDOWN if k % 2 else None)
            for k, (m, meas) in enumerate(both[0])]
    ref = [jax_attribution.attribute(
        m, meas, jax_attribution.effective_clock_hz(both[1]), JAX_PEAKS,
        breakdown=_BREAKDOWN if k % 2 else None)
        for k, (m, meas) in enumerate(both[1])]
    cfg = {"seed": 0, "fps_scale": fps_scale}
    return (attribution.build_report(
                port, cfg, PEAKS, attribution.effective_clock_hz(both[0])),
            jax_attribution.build_report(
                ref, cfg, JAX_PEAKS,
                jax_attribution.effective_clock_hz(both[1])))


@pytest.mark.parametrize("fps_scale", [1.0, 0.5, 1.3])
def test_report_text_and_diff_match_the_reference(fps_scale):
    rep, jrep = _reports(fps_scale)
    assert rep == jrep
    assert attribution.validate_perf_report(rep) == [] \
        == jax_attribution.validate_perf_report(jrep)
    assert attribution.perf_text(rep) == jax_attribution.perf_text(jrep)
    base, jbase = _reports(1.0)
    diff = attribution.perf_diff(base, rep)
    assert diff == jax_attribution.perf_diff(jbase, jrep)
    assert attribution.perf_diff_text(diff) \
        == jax_attribution.perf_diff_text(diff)
    for e in rep["pipelines"]:
        if "time_fractions" in e:
            assert math.fsum(e["time_fractions"].values()) == 1.0


# ---------------------------------------------------------------- ledger
def test_ledger_round_trip(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    r1 = ledger.make_row("perf", 0, {"h": 32}, {"fps": 100.0}, ts=1.0,
                         sha="a" * 40)
    r2 = ledger.make_row("perf", 0, {"h": 32}, {"fps": 110.0}, ts=2.0,
                         sha="a" * 40)
    ledger.append_row(path, r1)
    ledger.append_row(path, r2)
    rows = ledger.read_ledger(path)
    assert rows == [r1, r2]
    assert ledger.latest_row(rows, "perf")["metrics"]["fps"] == 110.0
    assert ledger.latest_row(rows, "chaos") is None
    # same config -> same fingerprint; different config -> different
    assert r1["config_fingerprint"] == r2["config_fingerprint"]
    r3 = ledger.make_row("perf", 0, {"h": 64}, {"fps": 1.0})
    assert r3["config_fingerprint"] != r1["config_fingerprint"]


def test_ledger_rejects_corrupt_rows(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    ledger.append_row(path, ledger.make_row("perf", 0, {}, {"fps": 1.0}))
    with open(path, "a") as f:
        f.write("{not json\n")
        f.write(json.dumps({"schema": "wrong/v9"}) + "\n")
        row = ledger.make_row("perf", 0, {}, {"fps": 2.0})
        row["metrics"] = {"fps": True}          # bool is not a number
        f.write(json.dumps(row) + "\n")
    with pytest.raises(ValueError, match="3 corrupt"):
        ledger.read_ledger(path)
    rows, errors = ledger.read_ledger(path, strict=False)
    assert len(rows) == 1 and len(errors) == 3
    assert (rows, errors) == jax_ledger.read_ledger(path, strict=False)
    # append refuses invalid rows outright
    with pytest.raises(ValueError, match="refusing"):
        ledger.append_row(path, {"schema": ledger.LEDGER_SCHEMA})


def test_validate_row_details():
    row = ledger.make_row("perf", 0, {"a": 1}, {"m": 1.0})
    assert ledger.validate_row(row) == []
    assert ledger.validate_row("nope")
    bad = dict(row, config_fingerprint="short")
    assert any("fingerprint" in e for e in ledger.validate_row(bad))
    bad = dict(row, seed="0")
    assert any("seed" in e for e in ledger.validate_row(bad))
    bad = dict(row, metrics={})
    assert any("metrics" in e for e in ledger.validate_row(bad))


_CONFIGS = [{}, {"h": 32}, {"pipelines": ["a", "b"], "w": [24, 40],
                            "peaks": {"flops": 6.7e13}},
            {"device": "NVIDIA H100 80GB HBM3", "seed": 0, "x": None}]


@pytest.mark.parametrize("config", _CONFIGS)
def test_ledger_rows_and_fingerprints_match_the_reference(config, tmp_path):
    metrics = {"fps": 123.5, "cycles": 1000, "eff": 0.25}
    row = ledger.make_row("perf", 3, config, metrics, ts=7.0, sha="b" * 40)
    jrow = jax_ledger.make_row("perf", 3, config, metrics, ts=7.0,
                               sha="b" * 40)
    assert row == jrow
    assert ledger.config_fingerprint(config) \
        == jax_ledger.config_fingerprint(config)
    for bad in (dict(row, seed="0"), dict(row, metrics={"m": "x"}),
                dict(row, schema="v0"), {"kind": "perf"}, "row"):
        assert ledger.validate_row(bad) == jax_ledger.validate_row(bad)
    # a ledger the reference wrote reads back equal, and vice versa
    path = str(tmp_path / "h.jsonl")
    jax_ledger.append_row(path, jrow)
    ledger.append_row(path, row)
    assert ledger.read_ledger(path) == jax_ledger.read_ledger(path) \
        == [row, row]


# ------------------------------------------------------------------ gate
BANDS = [ledger.Band("cycles", 1.0, 1.0),
         ledger.Band("fps", 1 / 1.4, 1.4),
         ledger.Band("maybe", 0.5, 2.0, required=False)]
BASE = {"cycles": 1000.0, "fps": 100.0, "maybe": 1.0}


def test_gate_quiet_within_tolerance():
    current = {"cycles": 1000.0, "fps": 108.0}   # noisy but inside band
    assert ledger.gate(BASE, current, BANDS) == []


def test_gate_fires_on_slowdown():
    slowed = {"cycles": 1000.0, "fps": 50.0}     # the 2x injected stall
    failures = ledger.gate(BASE, slowed, BANDS)
    assert len(failures) == 1 and "fps" in failures[0]
    # deterministic metrics gate exactly: 1 cycle of drift fires
    drifted = {"cycles": 1001.0, "fps": 100.0}
    assert any("cycles" in f for f in ledger.gate(BASE, drifted, BANDS))


def test_gate_missing_metrics():
    # required metric absent from current run -> failure
    assert any("absent from current" in f
               for f in ledger.gate(BASE, {"cycles": 1000.0}, BANDS))
    # banded metric absent from the baseline -> config failure
    assert any("absent from baseline" in f
               for f in ledger.gate({}, {"cycles": 1000.0},
                                    [ledger.Band("cycles", 1.0, 1.0)]))
    # zero baseline compares absolutely
    zb = [ledger.Band("z", 1.0, 1.0)]
    assert ledger.gate({"z": 0.0}, {"z": 0.0}, zb) == []
    assert ledger.gate({"z": 0.0}, {"z": 0.5}, zb)


@pytest.mark.parametrize("current", [
    {"cycles": 1000.0, "fps": 108.0},
    {"cycles": 1000.0, "fps": 50.0},
    {"cycles": 1001.0, "fps": 100.0},
    {"cycles": 1000.0},
    {"cycles": 1000.0, "fps": 100.0, "maybe": 9.0},
    {},
])
def test_gate_verdicts_match_the_reference(current):
    jbands = [jax_ledger.Band(**b.to_dict()) for b in BANDS]
    assert ledger.gate(BASE, current, BANDS) \
        == jax_ledger.gate(BASE, current, jbands)
    assert ledger.gate({}, current, BANDS) \
        == jax_ledger.gate({}, current, jbands)


def test_baseline_file_round_trip(tmp_path):
    path = str(tmp_path / "baseline.json")
    ledger.write_baseline(path, {"perf": {"metrics": BASE,
                                          "bands": BANDS}})
    data = ledger.load_baseline(path)
    assert ledger.baseline_metrics(data, "perf") == BASE
    bands = ledger.baseline_bands(data, "perf")
    assert [b.metric for b in bands] == [b.metric for b in BANDS]
    assert bands[0] == BANDS[0]
    assert ledger.baseline_bands(data, "unknown-kind") == []
    # the reference reads the port's baseline file to the same bands
    jdata = jax_ledger.load_baseline(path)
    assert [b.to_dict() for b in jax_ledger.baseline_bands(jdata, "perf")] \
        == [b.to_dict() for b in bands]
    with open(path, "w") as f:
        json.dump({"schema": "wrong"}, f)
    with pytest.raises(ValueError, match="schema"):
        ledger.load_baseline(path)


# ------------------------------------------------------- step breakdown
def _engine_trace():
    """A trace of two engine steps per pipeline, spans nested as the
    engines nest them, through the port's tracer and exporter."""
    tr = Tracer(enabled=True)
    for name in ("unsharp-m", "canny-m"):
        for k in range(2):
            with tr.span("engine.step", engine="frame", pipeline=name,
                         queue_wait_s=0.001 * (k + 1)):
                with tr.span("engine.assemble", pipeline=name):
                    sum(range(2000))
                with tr.span("engine.execute", pipeline=name):
                    with tr.span("executor.call", pipeline=name):
                        sum(range(5000))
                sum(range(500))
    return export.to_chrome_trace(tr.events())


def test_step_breakdown_matches_the_reference():
    data = _engine_trace()
    for name in ("unsharp-m", "canny-m", "none"):
        got = measure.step_breakdown(data, name)
        assert got == jax_measure.step_breakdown(data, name)
    got = measure.step_breakdown(data, "unsharp-m")
    assert got["n_steps"] == 2
    assert got["assemble_s"] + got["execute_s"] <= got["step_s"]
    assert measure.step_breakdown({"traceEvents": []}, "x") is None
    assert jax_export.validate_trace(data) == []


# ------------------------------------------------------- launch counts
def _loaded_by_mask(prog, frames):
    """The bytes a launch moves, counted CTA by CTA with a boolean mask
    of the frame pixels each CTA's feed loads (its strip, the strip's
    left halo and the warp rounding of its columns; its band, the top
    halo and the rounding to row groups), plus every stored pixel."""
    t = prog.table
    strip, left = int(t[sp.H_STRIP_W]), int(t[sp.H_HALO_LEFT])
    ncols, band, up = int(t[sp.H_NCOLS]), int(t[sp.H_BAND_H]), \
        int(t[sp.H_HALO_UP])
    r = prog.rows_per_step
    per_frame = 0
    for gy in range(prog.grid_y):
        y0 = gy * band
        y1 = min(y0 + band, prog.h)
        rlo = max(y0 - up, 0)
        row_hi = rlo + -(-(y1 - rlo) // r) * r
        for gx in range(prog.grid_x):
            mask = np.zeros((prog.h, prog.w), bool)
            c0 = gx * strip - left
            mask[rlo:row_hi, max(c0, 0):max(c0 + ncols, 0)] = True
            per_frame += int(mask.sum())
    n_feeds = len(prog.feeds) + sum(
        d - 1 for d in prog.dag.temporal_depths().values())
    stores = (1 + len(prog.frame_outs)) * prog.h * prog.w
    return 4 * frames * (n_feeds * per_frame + stores)


def test_executor_cost_one_strip_one_band_equals_launch_work():
    dag = algorithms.ALGORITHMS["canny-m"]()
    plan = compile_pipeline(dag, 48, mem=DP)
    ex = sp.make_executor(dag, 16, 48, batch=3, plan=plan, rows_per_step=8,
                          device="cpu")
    assert (ex.program.grid_x, ex.program.grid_y) == (1, 1)
    cost = measure.executor_cost(ex)
    nbytes, ops = sp.launch_work(ex.program, 3)
    assert cost["bytes_accessed"] == nbytes == _loaded_by_mask(ex.program, 3)
    assert cost["flops"] == ops
    px = 16 * 48 * 4
    assert (cost["arg_bytes"], cost["out_bytes"], cost["temp_bytes"]) \
        == (3 * px, 3 * px, 0)
    assert set(cost) == {"flops", "bytes_accessed", "arg_bytes",
                         "out_bytes", "temp_bytes"}


@pytest.mark.parametrize("name", ["canny-m", "xcorr-m", "denoise-m"])
def test_executor_cost_counts_the_halos_of_many_strips(name):
    dag = algorithms.ALGORITHMS[name]()
    plan = compile_pipeline(dag, 300, mem=DP)
    ex = sp.make_executor(dag, 203, 300, batch=2, plan=plan,
                          rows_per_step=8, device="cpu")
    prog = ex.program
    assert prog.grid_x > 1 and prog.grid_y > 1
    cost = measure.executor_cost(ex)
    assert cost["bytes_accessed"] == _loaded_by_mask(prog, 2)
    assert cost["bytes_accessed"] > sp.launch_work(prog, 2)[0]


@pytest.mark.parametrize("name", sorted(algorithms.VIDEO_ALGORITHMS))
def test_executor_cost_reads_every_tap_of_every_frame(name):
    dag = algorithms.VIDEO_ALGORITHMS[name]()
    plan = compile_pipeline(dag, 40, mem=DP)
    ex = sp.make_video_executor(dag, 18, 40, plan=plan, chunk=4,
                                rows_per_step=8, device="cpu")
    cost = measure.executor_cost(ex)
    assert cost["bytes_accessed"] == _loaded_by_mask(ex.program, 4)
    px = 18 * 40 * 4
    depths = dag.temporal_depths()
    assert cost["arg_bytes"] == 4 * px + sum(d - 1 for d in
                                             depths.values()) * px
    assert cost["temp_bytes"] == ex.state_roll_bytes > 0
    assert cost["flops"] == sp.launch_work(ex.program, 4)[1]


# ----------------------------------------------------------- measurement
def test_measure_executor_on_the_cpu():
    dag = algorithms.ALGORITHMS["unsharp-m"]()
    plan = compile_pipeline(dag, 32, mem=DP)
    ex = sp.make_executor(dag, 20, 32, batch=2, plan=plan, rows_per_step=4,
                          device="cpu")
    meas = measure.measure_executor(ex, 6, np.random.RandomState(0),
                                    settle=1)
    assert (meas.pipeline, meas.h, meas.w, meas.frames) \
        == ("unsharp-m", 20, 32, 6)
    assert meas.fps == pytest.approx(6 / meas.wall_s)
    cost = measure.executor_cost(ex)
    assert meas.flops_per_frame == cost["flops"] / 2
    assert meas.bytes_per_frame == cost["bytes_accessed"] / 2
    # to_dict keeps the reference's keys; the last call holds the output
    assert set(meas.to_dict()) == set(
        jax_measure.MeasuredPerf.__dataclass_fields__)
    inputs, state, out = meas.last
    assert state is None
    exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(
        inputs["in"])})
    assert torch.equal(out, exp)


def test_measure_executor_streams_a_buffer_of_its_own_per_call():
    dag = algorithms.ALGORITHMS["unsharp-m"]()
    ex = sp.make_executor(dag, 20, 32, batch=2, device="cpu")
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(ex, name)

        def __call__(self, images):
            seen.append(images["in"])
            return ex(images)

    meas = measure.measure_executor(Recorder(), 8, np.random.RandomState(3),
                                    settle=1)
    # one settling call, then the four timed ones: call i's frames are the
    # first draw rolled by i columns, each in a buffer of its own
    first = np.random.RandomState(3).rand(2, 20, 32).astype(np.float32)
    assert len(seen) == 5 and seen[0] is seen[1]
    timed = seen[1:]
    assert len({id(a) for a in timed}) == 4
    assert not any(np.shares_memory(a, b) for i, a in enumerate(timed)
                   for b in timed[i + 1:])
    for i, a in enumerate(timed):
        np.testing.assert_array_equal(a, np.roll(first, i, axis=-1))
    np.testing.assert_array_equal(meas.last[0]["in"], timed[-1])


def test_measure_video_executor_carries_state():
    dag = algorithms.VIDEO_ALGORITHMS["tmotion-t"]()
    plan = compile_pipeline(dag, 24, mem=DP)
    ex = sp.make_video_executor(dag, 12, 24, plan=plan, chunk=2,
                                rows_per_step=4, device="cpu")
    meas = measure.measure_executor(ex, 4, np.random.RandomState(1))
    assert meas.frames == 4
    inputs, state, out = meas.last
    # the last call read a state the earlier calls wrote (not zeros)
    assert any(float(s.abs().max()) > 0 for s in state.values())
    ins = {"in": torch.from_numpy(inputs["in"])}
    exp, _ = sp.video_pipeline_plain(
        dag, {**ins, **sp.tap_feeds(dag, ins, state, 2)})
    assert torch.equal(out, exp)


def test_injected_sleep_slows_the_measurement_and_fires_the_gate():
    dag = algorithms.ALGORITHMS["xcorr-m"]()
    ex = sp.make_executor(dag, 16, 24, batch=1, device="cpu")
    clean = measure.measure_executor(ex, 3, np.random.RandomState(0))
    slow = measure.measure_executor(ex, 3, np.random.RandomState(0),
                                    per_frame_sleep_s=0.05)
    assert slow.wall_s >= 3 * 0.05
    bands = [ledger.Band("fps", 1 / 1.4, 1.4)]
    assert ledger.gate({"fps": clean.fps}, {"fps": clean.fps}, bands) == []
    assert ledger.gate({"fps": clean.fps}, {"fps": slow.fps}, bands)


def test_timed_stream_waits_and_returns_the_last_output():
    calls = []

    def call(x):
        calls.append(x)
        return torch.full((2,), float(x))

    wall, out = measure.timed_stream(call, [1, 2, 3], settle=2)
    assert calls == [1, 2, 1, 2, 3]
    assert wall >= 0 and torch.equal(out, torch.full((2,), 3.0))


def test_the_package_exports_the_reference_names_on_first_use():
    import subprocess
    import sys

    import repro.perf as jax_perf
    import repro_torch.perf as perf

    assert sorted(perf.__all__) == sorted(jax_perf.__all__)
    homes = (perf_model, measure, attribution, ledger)
    for name in perf.__all__:
        assert any(getattr(m, name, None) is getattr(perf, name)
                   for m in homes)
    with pytest.raises(AttributeError):
        perf.no_such_name
    # the timing helpers and the planner's model import none of the lab's
    # measuring modules
    probe = ("import sys, repro_torch.perf.timing, repro_torch.perf.model; "
             "print(sorted(m for m in sys.modules if m in ("
             "'repro_torch.perf.measure', 'repro_torch.perf.attribution', "
             "'repro_torch.perf.ledger', "
             "'repro_torch.kernels.stencil_pipeline')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
