"""The examples' twins (``examples/*_torch.py``) against the JAX package.

Each twin runs through its ``main(argv)`` with ``--device cpu`` at the
JAX package's own sizes, where the kernel's wrapper runs its plain
version. The JAX package's Pallas executors fail on jax 0.9.0, so each
twin is held against the parts of the reference that run: the planner
(plans, simulator reports, autotuner and sweep rows, the perf model, the
KV planner), the pure-jnp oracles ``repro.kernels.ref.stencil_pipeline_ref``
and ``video_pipeline_ref`` for pixels (bitwise, else <= 32 ULP at the
array's scale, ``tests/test_video.py``), the reference's memtrace capture
and the reference's LM ``Engine``.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import DP as JAX_DP
from repro.core import DPLC as JAX_DPLC
from repro.core import algorithms as jax_algorithms
from repro.core import compile_pipeline as jax_compile
from repro.core import dse as jax_dse
from repro.core.dsl import Pipeline as JaxPipeline
from repro.core.linebuffer import DP_SIZED as JAX_DP_SIZED
from repro.core.linebuffer import DPLC_SIZED as JAX_DPLC_SIZED
from repro.imaging import PlanCache as JaxPlanCache
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.obs import memtrace as jax_memtrace
from repro.perf import model as jax_perf_model
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import plan_kv as jax_plan_kv
from repro_torch.kernels.stencil_pipeline import SMEM_LIMIT
from repro_torch.models import build_model, params_from_reference
from repro_torch.obs import export, memtrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def twin(name: str):
    """``examples/<name>_torch.py`` as a fresh module."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_ulp(got, exp):
    """Bitwise, else within 32 ULP at the array's scale."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread; more only spin against the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_cache():
    return JaxPlanCache()


def test_quickstart_matches_reference(capsys):
    got = twin("quickstart").main(CPU)
    out = capsys.readouterr().out
    dag = jax_algorithms.unsharp_m()
    plan = jax_compile(dag, 128, mem=JAX_DP)
    lc = jax_compile(dag, 128, mem=JAX_DPLC)
    rep = plan.verify(96)
    p, r = got["plan"], got["report"]
    assert (p.total_alloc_bits, p.alloc.total_blocks, p.power) == \
        (plan.total_alloc_bits, plan.alloc.total_blocks, plan.power)
    assert p.pseudo_rtl() == plan.pseudo_rtl()
    assert (r.ok, r.throughput, r.latency_cycles) == \
        (rep.ok, rep.throughput, rep.latency_cycles)
    assert (got["lc"].total_alloc_bits, got["lc"].alloc.total_blocks) == \
        (lc.total_alloc_bits, lc.alloc.total_blocks)
    assert_ulp(got["out"], jax_ref.stencil_pipeline_ref(dag,
                                                        {"in": got["img"]}))
    assert out.startswith("device: cpu\n")
    assert f"shared memory {got['smem_bytes']} bytes a CTA" in out
    assert "VMEM" not in out


def test_stream_frames_matches_reference(jax_cache, capsys):
    got = twin("stream_frames").main(CPU)
    out = capsys.readouterr().out
    assert got["plan"].fingerprint() == \
        jax_cache.plan_for("canny-m", w=48).fingerprint()
    dag = jax_cache.dag_for("canny-m")
    assert torch.equal(got["r1"], got["r8"])
    assert_ulp(got["r1"], jax_ref.stencil_pipeline_ref(dag,
                                                       {"in": got["img"]}))
    assert got["tiled"].shape == (100, 140)
    assert_ulp(got["tiled"], jax_ref.stencil_pipeline_ref(
        dag, {"in": got["frame"]}))
    assert len(got["results"]) == 10
    for r in got["requests"]:
        assert_ulp(got["results"][r.rid], jax_ref.stencil_pipeline_ref(
            jax_cache.dag_for(r.pipeline), r.frames))
    assert "shared-memory high-water" in out and "VMEM" not in out


def _jax_my_tunsharp():
    p = JaxPipeline("my-tunsharp")
    x = p.input("in")
    avg = p.stage("stavg", [(x, 3, 3, 3)], jax_algorithms.stmean_fn(3, 3, 3))
    sh = p.stage("sharp", [(x, 1, 1), (avg, 1, 1)],
                 jax_algorithms.tunsharp_fn)
    p.output("out", [(sh, 1, 1)])
    return p.build()


def test_stream_video_matches_reference(capsys):
    got = twin("stream_video").main(CPU)
    capsys.readouterr()
    jdag = _jax_my_tunsharp()
    assert got["dag"].temporal_depths() == jdag.temporal_depths()
    assert got["dag"].cumulative_extent(temporal=True) == \
        jdag.cumulative_extent(temporal=True)
    assert got["hand"].shape == (12, 32, 48)
    assert_ulp(got["hand"], jax_ref.video_pipeline_ref(
        jdag, {"in": got["video"]}))
    bg = jax_algorithms.VIDEO_ALGORITHMS["tbackground-t"]()
    assert len(got["streams"]) == 2
    for vid, out in got["streams"].values():
        assert_ulp(out, jax_ref.video_pipeline_ref(bg, {"in": vid}))


@pytest.mark.parametrize("full", [False, True])
def test_overlap_depth_matches_reference(jax_cache, full, capsys):
    """The predicted rows and the autotuner's depth rows equal the
    reference's under the budget the twin printed: the JAX package's
    256 KiB by default, the card's per-block shared-memory limit at
    1920x1080. Depth 2 equals depth 1 bit for bit."""
    got = twin("overlap_depth").main(CPU + (["--full"] if full else []))
    out = capsys.readouterr().out
    w, h = (1920, 1080) if full else (48, 32)
    rows = []
    for name in ("unsharp-m", "tdenoise-t"):
        plan = jax_cache.plan_for(name, w)
        for depth in (1, 2, 4):
            m = jax_perf_model.predict(
                dataclasses.replace(plan, prefetch_depth=depth), h)
            rows.append((name, depth, m.bound, m.cycles_per_frame,
                         m.vmem_ring_bytes))
    assert got["predict"] == rows
    budget = SMEM_LIMIT if full else 256 * 1024
    assert got["budget"] == budget and f"budget: {budget} B" in out
    res = jax_dse.autotune(jax_algorithms.VIDEO_ALGORITHMS["tdenoise-t"](),
                           w, options=(JAX_DP,), frame_h=h,
                           vmem_budget=budget)
    t = got["tuning"]
    assert (t.bound, t.best_depth, t.depth_candidates) == \
        (res.bound, res.best_depth, res.depth_candidates)
    assert got["depths"][0] == 1 and got["depths"][1] >= 2
    assert torch.equal(got["depth1"], got["deep"])
    assert_ulp(got["depth1"], jax_ref.stencil_pipeline_ref(
        jax_algorithms.unsharp_m(), {"in": got["img"]}))


def _cand(c):
    return (c.combo, c.vmem_bytes, c.power, c.alloc_bits,
            c.contention_slack)


def test_tune_pipeline_matches_reference(jax_cache, capsys):
    got = twin("tune_pipeline").main(CPU)
    capsys.readouterr()
    res = jax_dse.autotune(jax_algorithms.unsharp_m(), 64)
    t = got["tuning"]
    assert _cand(t.default) == _cand(res.default)
    assert _cand(t.best) == _cand(res.best)
    assert [_cand(c) for c in t.pareto()] == [_cand(c) for c in res.pareto()]
    assert (t.stats.n_compiled, t.stats.space_size) == \
        (res.stats.n_compiled, res.stats.space_size)
    assert got["plan"].fingerprint() == \
        jax_cache.plan_for("unsharp-m", 64, tune=True).fingerprint()
    dag = jax_algorithms.unsharp_m()
    assert len(got["outputs"]) == 4
    for i, f in enumerate(got["frames"]):
        assert_ulp(got["outputs"][i],
                   jax_ref.stencil_pipeline_ref(dag, {"in": f}))


@pytest.fixture(scope="module")
def jax_sweeps():
    return {name: jax_dse.sweep(jax_algorithms.ALGORITHMS[name](), 480,
                                [JAX_DP_SIZED, JAX_DPLC_SIZED],
                                max_points=300)
            for name in ("canny-m", "denoise-m")}


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_imagen_dse_matches_reference(jax_sweeps, with_matplotlib,
                                      monkeypatch, tmp_path, capsys):
    """Every swept point (area, power, Pareto flag) equals the reference's;
    without matplotlib the same lines print and no plot is written."""
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    png = tmp_path / "dse.png"
    got = twin("imagen_dse").main(CPU + ["--out", str(png)])
    out = capsys.readouterr().out
    for name, ref_pts in jax_sweeps.items():
        pts = got["sweeps"][name]
        assert [(p.area, p.power, p.pareto) for p in pts] == \
            [(p.area, p.power, p.pareto) for p in ref_pts]
        assert (f"{name}: {len(ref_pts)} designs, "
                f"{sum(p.pareto for p in ref_pts)} pareto-optimal") in out
    assert png.exists() == with_matplotlib
    assert ("no plot written" in out) != with_matplotlib


def test_memtrace_pipeline_matches_reference(monkeypatch, tmp_path, capsys):
    """The port renders the reference's own capture of the plan as the
    reference does; the twin's capture has the reference's tracks, joins
    the kernel's shared-memory rings, and both files it writes
    validate."""
    monkeypatch.chdir(tmp_path)
    got = twin("memtrace_pipeline").main(CPU)
    out = capsys.readouterr().out
    jmt = JaxPlanCache().memtrace_for("unsharp-m", 48, 32)
    assert memtrace.memtrace_text(jmt) == jax_memtrace.memtrace_text(jmt)
    mt = got["memtrace"]
    assert memtrace.memtrace_text(mt) in out
    assert [(b["name"], b["peak_occupancy"], b["conflict_cycles"])
            for b in mt["buffers"]] == \
        [(b["name"], b["peak_occupancy"], b["conflict_cycles"])
         for b in jmt["buffers"]]
    assert mt["cycles"] == jmt["cycles"]
    assert mt["summary"]["smem_ring_bytes"] > 0
    with open("memtrace_unsharp.json") as f:
        assert memtrace.validate_memtrace(json.load(f)) == []
    data = export.load_trace("memtrace_pipeline.json")
    assert export.validate_trace(data) == []
    assert any(e["ph"] == "C" for e in data["traceEvents"])
    dag = jax_algorithms.unsharp_m()
    for r in got["requests"]:
        assert_ulp(got["results"][r.rid],
                   jax_ref.stencil_pipeline_ref(dag, r.frames))


def test_trace_serving_trace_validates(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    got = twin("trace_serving").main(CPU)
    out = capsys.readouterr().out
    data = export.load_trace("trace_serving.json")
    assert export.validate_trace(data) == []
    names = {e["name"] for e in data["traceEvents"] if e.get("ph") == "X"}
    assert {"engine.step", "engine.execute", "executor.call", "cache.tune",
            "cache.exec", "dse.autotune", "ilp.solve"} <= names
    assert got["excerpt"]
    assert any(line.startswith("frame_engine_smem_high_water_bytes")
               for line in got["excerpt"])
    assert "--- telemetry plane (excerpt) ---" in out and "vmem" not in out
    dag = jax_algorithms.unsharp_m()
    for r in got["requests"]:
        assert_ulp(got["results"][r.rid],
                   jax_ref.stencil_pipeline_ref(dag, r.frames))


def test_serve_lm_matches_reference(monkeypatch, capsys):
    """The JAX package's parameters carried into the twin's model: the KV
    plan per layer equals ``repro.serve.kv_planner``'s, and every greedy
    request's tokens equal the reference ``Engine``'s and a plain greedy
    loop over the port's ``forward``. gemma3's layers are attention only,
    so the reference's prefill and slot-reuse faults (which move
    recurrent state) reach no request: the reference engine is the
    comparison for all four. Sampled requests are not compared."""
    mod = twin("serve_lm")
    cfg, n_slots, max_len = mod.config(False)
    jcfg = dataclasses.replace(
        jax_config("gemma3-1b"), n_layers=6, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=0, d_ff=256, vocab=512, window=16,
        dtype="float32", remat=False)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params_from_reference(model, jax.tree.map(np.asarray, params))
    monkeypatch.setattr(mod, "build_model", lambda *a, **k: model)
    got = mod.main(CPU)
    capsys.readouterr()

    jplan = jax_plan_kv(jcfg, max_len)
    assert got["kv_plan"].per_layer == jplan.per_layer
    assert got["kv_plan"].bytes_per_seq == jplan.bytes_per_seq
    reqs = got["requests"]
    exp = JaxEngine(jm, params, n_slots=n_slots, max_len=max_len).run(
        [JaxRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                    temperature=r.temperature) for r in reqs])
    assert sorted(got["results"]) == list(range(8))
    assert all(len(t) == 12 for t in got["results"].values())
    greedy = [r for r in reqs if r.temperature == 0.0]
    assert len(greedy) == 4
    for r in greedy:
        toks = [int(t) for t in r.prompt]
        for _ in range(r.max_new):
            logits, _ = model.forward({"tokens": torch.tensor([toks])})
            toks.append(int(logits[0, -1].argmax()))
        assert got["results"][r.rid] == exp[r.rid] == toks[len(r.prompt):]
