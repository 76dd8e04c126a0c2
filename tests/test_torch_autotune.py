"""The port's autotuner and prior-work baselines against the JAX package's.

``repro_torch.core.dse`` and ``repro_torch.core.baselines`` are copies
of the reference's jax-free planning code, so every search must come out
the same: the winner's memory combo, the ranked candidates, the Pareto
set, the prefetch-depth axis, and the baseline schedules. The winner's
plan, carried across as ``to_dict()``, rebuilds the port's winner (equal
fingerprint). The tuned rung of both engines then serves through that
winner, on the CPU here through the kernel's plain version.

Tolerance for pixels: bitwise first, else <= 32 ULP at the array's
scale (``tests/test_video.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core import baselines as jax_baselines
from repro.core import dse as jax_dse
from repro_torch.core import algorithms, baselines, dse
from repro_torch.core.codegen import plan_from_dict
from repro_torch.core.linebuffer import DP, SP
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.video import VideoEngine, VideoFrame

VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)
SPATIAL = ["harris-m", "unsharp-m", "xcorr-m"]
ALL = {**algorithms.ALGORITHMS, **algorithms.VIDEO_ALGORITHMS}
JAX_ALL = {**jax_algorithms.ALGORITHMS, **jax_algorithms.VIDEO_ALGORITHMS}


def assert_ulp_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())   # a few ULP at array scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def _summary(res):
    """A TuningResult as comparable data: its dict without the clock."""
    d = res.to_dict()
    d["stats"].pop("tune_s")
    d["ranked"] = [c.to_dict() for c in res.candidates]
    return d


@pytest.mark.parametrize("w", [48, 480])
@pytest.mark.parametrize("name", VIDEO + SPATIAL)
def test_autotune_equals_reference(name, w):
    got = dse.autotune(ALL[name](), w, rows_per_step=8)
    exp = jax_dse.autotune(JAX_ALL[name](), w, rows_per_step=8)
    assert _summary(got) == _summary(exp)
    assert {s: c.name for s, c in got.best.mem_cfg.items()} == \
        {s: c.name for s, c in exp.best.mem_cfg.items()}
    assert [c.combo for c in got.pareto()] == \
        [c.combo for c in exp.pareto()]
    # the reference winner's plan rebuilds the port's winner
    port = plan_from_dict(exp.best.plan.to_dict(), got.best.plan.dag)
    assert port.fingerprint() == got.best.plan.fingerprint()
    assert got.best.vmem_bytes <= got.default.vmem_bytes


def test_sweep_equals_reference():
    got = dse.sweep(algorithms.unsharp_m(), 48, [SP, DP])
    exp = jax_dse.sweep(jax_algorithms.unsharp_m(), 48,
                        [jax_dse.SP, jax_dse.DP])
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in exp]


@pytest.mark.parametrize("name", sorted(ALL))
def test_baselines_equal_reference(name):
    w = 48
    dag, jdag = ALL[name](), JAX_ALL[name]()
    lin, sched = baselines.darkroom_schedule(dag, w, frame_h=16)
    jlin, jsched = jax_baselines.darkroom_schedule(jdag, w, frame_h=16)
    assert lin.topo_order == jlin.topo_order
    assert sched.starts == jsched.starts
    assert sched.total_pixels == jsched.total_pixels
    soda = baselines.soda_allocate(dag, w, block_bits=4096, frame_h=16)
    jsoda = jax_baselines.soda_allocate(jdag, w, block_bits=4096,
                                        frame_h=16)
    assert (soda.dff_pixels, soda.latency_start, soda.frame_pixels) == \
        (jsoda.dff_pixels, jsoda.latency_start, jsoda.frame_pixels)
    assert soda.alloc.total_alloc_bits == jsoda.alloc.total_alloc_bits
    fx = baselines.fixynn_schedule(dag, w, frame_h=16)
    assert fx.starts == jax_baselines.fixynn_schedule(
        jdag, w, frame_h=16).starts


def test_cache_tunes_once_and_seeds_the_plan():
    cache = PlanCache(device="cpu")
    res = cache.tuning_for("tdenoise-t", 24, rows_per_step=8)
    assert cache.stats.tunes == 1 and cache.stats.tune_s > 0
    assert cache.tuning_for("tdenoise-t", 24) is res
    assert cache.stats.tunes == 1
    # the winner's plan is resident: the first tuned plan_for is a hit
    plan = cache.plan_for("tdenoise-t", 24, rows_per_step=8, tune=True)
    assert plan is res.best.plan and cache.stats.plan_hits == 1
    ex = cache.video_executor_for("tdenoise-t", 16, 24, chunk=4,
                                  rows_per_step=8, tune=True)
    assert ex.plan is plan
    assert cache.snapshot()["tunings_resident"] == 1
    with pytest.raises(ValueError, match="either mem= or tune="):
        cache.plan_for("tdenoise-t", 24, mem=DP, tune=True)


def test_video_engine_tuned_rung_matches_reference():
    h, w = 13, 24
    vid = np.random.RandomState(3).rand(12, h, w).astype(np.float32)
    eng = VideoEngine(autotune=True, chunk=4, device="cpu")
    sid = eng.open_stream("tbackground-t", h, w)
    for f in vid:
        assert eng.submit(VideoFrame(sid, {"in": f}))
    done = []
    while eng.pending:
        done += eng.step()
    assert [c.rung for c in done] == ["tuned"] * 12
    exp = jax_algorithms.execute_reference_video(
        jax_algorithms.tbackground_t(), {"in": vid})
    assert_ulp_equal(np.stack([c.output.numpy() for c in done]),
                     np.asarray(exp))
    assert eng.cache.stats.tunes == 1


def test_frame_engine_tuned_rung_matches_reference():
    h, w = 20, 24
    eng = FrameEngine(autotune=True, max_batch=2, tile_shape=(16, 16),
                      device="cpu")
    imgs = np.random.RandomState(4).rand(3, h, w).astype(np.float32)
    res = eng.run([FrameRequest(rid=i, pipeline="unsharp-m",
                                frames={"in": imgs[i]}) for i in range(3)])
    dag = jax_algorithms.unsharp_m()
    for i in range(3):
        assert_ulp_equal(res[i].numpy(), np.asarray(
            jax_algorithms.execute_reference(dag, {"in": imgs[i]})["out"]))
    assert eng.cache.stats.tunes == 1          # tiles share one width
    untiled = FrameEngine(autotune=True, max_batch=2, device="cpu")
    untiled.submit(FrameRequest(rid=9, pipeline="unsharp-m",
                                frames={"in": imgs[0]}))
    (c,) = untiled.step()
    assert c.rung == "tuned"
    assert torch.equal(c.output, res[0])
    ex = untiled.cache.executor_for("unsharp-m", h, w, batch=2,
                                    rows_per_step=8, tune=True)
    assert ex.plan.mem_cfg == untiled.cache.tuned_mem_for("unsharp-m", w)
    assert isinstance(ex, sp.StencilExecutor)
