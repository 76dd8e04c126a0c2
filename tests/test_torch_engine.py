"""Port serving layer: FrameEngine, PlanCache and tiling on the CPU.

The contracts of tests/test_frame_engine.py, test_imaging_cache.py and
test_imaging_tiling.py, held by ``repro_torch.imaging`` at
``device="cpu"`` (the kernel's plain version), with outputs compared to
the JAX oracle ``repro.kernels.ref.stencil_pipeline_ref`` (pure jnp).

Tolerance: bitwise equality first, else <= 32 ULP at the array's scale
(tests/test_video.py), for XLA's multiply-add contraction. Tiled output
must be exact against the untiled port: tiling recomputes the halo from
real input and changes no arithmetic.
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.kernels import ref as jax_ref
from repro_torch.core import DP, SP
from repro_torch.core.codegen import mem_cfg_key
from repro_torch.imaging import (FrameEngine, FrameRequest, PlanCache,
                                 execute_tiled, plan_tile_grid, tile_origins)
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.resilience import FailedFrame, Priority

RNG = np.random.RandomState(13)


def assert_ulp_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())   # a few ULP at array scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(name):
    """The jnp oracle of ``name``, jitted (one compile per frame shape)."""
    dag = jax_algorithms.ALGORITHMS[name]()
    return jax.jit(lambda img: jax_ref.stencil_pipeline_ref(dag, {"in": img}))


def oracle(name, img):
    return np.asarray(_jax_pipeline(name)(img))


def _req(rid, name, shape=(24, 32)):
    return FrameRequest(rid=rid, pipeline=name,
                        frames={"in": RNG.rand(*shape).astype(np.float32)})


def _engine(**kw):
    return FrameEngine(device="cpu", **kw)


# ------------------------------------------------------------ FrameEngine
def test_submit_rejects_malformed_requests_at_admission():
    eng = _engine(max_batch=2, max_pending=8)
    with pytest.raises(KeyError):
        eng.submit(FrameRequest(rid=0, pipeline="no-such",
                                frames={"in": np.zeros((8, 8), np.float32)}))
    with pytest.raises(ValueError, match="needs inputs"):
        eng.submit(FrameRequest(rid=1, pipeline="canny-m",
                                frames={"img": np.zeros((8, 8), np.float32)}))
    with pytest.raises(ValueError, match="share"):
        eng.submit(FrameRequest(
            rid=2, pipeline="canny-m",
            frames={"in": np.zeros((8, 8), np.float32),
                    "extra": np.zeros((4, 4), np.float32)}))
    assert eng.submit(_req(3, "canny-m"))       # engine still healthy
    assert len(eng.step()) == 1


def test_submit_backpressure():
    eng = _engine(max_batch=2, max_pending=3)
    assert all(eng.submit(_req(i, "harris-s")) for i in range(3))
    assert not eng.submit(_req(3, "harris-s"))      # queue full: refused
    assert eng.metrics.frames_rejected == 1
    assert len(eng.step()) == 2                     # drain one batch...
    assert eng.submit(_req(3, "harris-s"))          # ...now admitted


def test_per_pipeline_fifo_ordering():
    eng = _engine(max_batch=3, max_pending=32)
    order = {"canny-s": [], "unsharp-m": []}
    for i in range(12):
        assert eng.submit(_req(i, ["canny-s", "unsharp-m"][i % 2]))
    while eng.pending:
        for c in eng.step():
            order[c.pipeline].append(c.rid)
    assert order["canny-s"] == [0, 2, 4, 6, 8, 10]
    assert order["unsharp-m"] == [1, 3, 5, 7, 9, 11]


def test_mixed_shapes_never_share_a_batch():
    eng = _engine(max_batch=4, max_pending=32)
    shapes = [(24, 32), (24, 32), (16, 24), (16, 24), (24, 32)]
    for i, s in enumerate(shapes):
        assert eng.submit(_req(i, "harris-m", shape=s))
    done = []
    while eng.pending:
        batch = eng.step()
        assert len({tuple(c.output.shape) for c in batch}) == 1
        done += batch
    assert sorted(c.rid for c in done) == list(range(5))
    assert [c.rid for c in done[:2]] == [0, 1]


def test_bursty_load_completes_all_and_outputs_match_reference():
    """More requests than queue capacity, mixed pipelines and sizes (some
    tiled): everything completes exactly once and matches the oracle."""
    eng = _engine(max_batch=3, max_pending=4, tile_shape=(40, 48))
    reqs = [FrameRequest(
        rid=i, pipeline=["canny-m", "unsharp-m", "harris-s"][i % 3],
        frames={"in": RNG.rand(*((50, 70) if i % 5 == 0 else (24, 32))
                               ).astype(np.float32)})
        for i in range(14)]
    res = eng.run(reqs)
    assert sorted(res) == list(range(14))
    assert eng.metrics.frames_completed == 14
    assert eng.metrics.frames_rejected > 0          # the burst overflowed
    assert eng.metrics.latency_s.count == 14
    assert eng.metrics.smem_high_water > 0
    for r in reqs:
        assert_ulp_equal(res[r.rid].numpy(),
                         oracle(r.pipeline, r.frames["in"]))


@pytest.mark.parametrize("name", sorted(jax_algorithms.ALGORITHMS))
def test_partial_batch_zero_slots_do_not_leak(name):
    """One live request in a 4-slot batch: idle zero-filled slots must not
    perturb the live frame."""
    eng = _engine(max_batch=4, max_pending=8)
    solo = _req(0, name)
    assert eng.submit(solo)
    (c,) = eng.step()
    assert_ulp_equal(c.output.numpy(), oracle(name, solo.frames["in"]))


def test_engine_metrics_snapshot_shape():
    eng = _engine(max_batch=2, max_pending=8)
    eng.run([_req(i, "unsharp-m") for i in range(4)])
    snap = eng.snapshot()
    assert snap["frames_completed"] == 4
    assert snap["batches"] == 2
    assert snap["mean_batch_fill"] == pytest.approx(1.0)
    assert snap["per_pipeline"] == {"unsharp-m": 4}
    assert snap["fps_execute"] > 0
    assert snap["smem_high_water_bytes"] == snap["cache"]["smem_bytes"] > 0
    assert snap["reconciliation"]["balanced"]


def test_executor_exception_becomes_failed_frames(monkeypatch):
    """Strict mode still never strands a popped batch: an executor error
    comes back as FailedFrame results and the queue keeps serving."""
    eng = _engine(max_batch=2, max_pending=8)

    def boom(program, feeds):
        raise RuntimeError("device fault")
    monkeypatch.setattr(sp, "stencil_pipeline", boom)
    assert eng.submit(_req(0, "harris-s"))
    assert eng.submit(_req(1, "harris-s"))
    out = eng.step()
    assert [type(o) for o in out] == [FailedFrame, FailedFrame]
    assert [o.rid for o in out] == [0, 1]
    assert eng.metrics.frames_failed == 2
    assert "device fault" in out[0].error
    assert eng.snapshot()["reconciliation"]["balanced"]
    monkeypatch.undo()
    assert eng.submit(_req(2, "harris-s"))
    assert eng.step()[0].rid == 2


def test_request_priority_defaults_to_normal():
    assert _req(0, "canny-m").priority == Priority.NORMAL


def test_cuda_engine_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        assert FrameEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameEngine(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanCache()


def test_port_runs_without_jax_or_reference_package():
    """A fresh process that imports repro_torch and serves frames ends
    with neither jax nor the reference package in sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.imaging import FrameEngine, FrameRequest
        eng = FrameEngine(device="cpu", max_batch=2, tile_shape=(16, 16))
        img = np.random.RandomState(0).rand(24, 40).astype(np.float32)
        res = eng.run([FrameRequest(rid=0, pipeline="canny-m",
                                    frames={"in": img})])
        assert res[0].shape == (24, 40)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LEAKED", bad)
    """)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


# -------------------------------------------------------------- PlanCache
def test_plan_hit_miss_by_name_width_mem():
    cache = PlanCache(device="cpu")
    p1 = cache.plan_for("unsharp-m", 24)
    assert (cache.stats.plan_misses, cache.stats.plan_hits) == (1, 0)
    assert cache.plan_for("unsharp-m", 24) is p1
    assert (cache.stats.plan_misses, cache.stats.plan_hits) == (1, 1)
    cache.plan_for("unsharp-m", 32)           # width
    cache.plan_for("canny-s", 24)             # pipeline
    cache.plan_for("unsharp-m", 24, mem=SP)   # mem combo
    assert (cache.stats.plan_misses, cache.stats.plan_hits) == (4, 1)
    assert len(cache) == 4


def test_executor_reuses_plan():
    cache = PlanCache(device="cpu")
    e1 = cache.executor_for("harris-s", 16, 24, batch=2)
    assert (cache.stats.exec_misses, cache.stats.plan_misses) == (1, 1)
    assert cache.executor_for("harris-s", 16, 24, batch=2) is e1
    assert cache.stats.exec_hits == 1
    cache.executor_for("harris-s", 20, 24, batch=2)
    cache.executor_for("harris-s", 16, 24, batch=None)
    assert cache.stats.exec_misses == 3
    assert cache.stats.plan_misses == 1
    assert cache.stats.plan_hits == 2


def test_cached_executor_is_correct():
    cache = PlanCache(device="cpu")
    ex = cache.executor_for("canny-m", 20, 24, batch=3, rows_per_step=8)
    frames = RNG.rand(3, 20, 24).astype(np.float32)
    got = ex({"in": frames}).numpy()
    for b in range(3):
        assert_ulp_equal(got[b], oracle("canny-m", frames[b]))
    assert ex.smem_bytes > 0
    assert cache.smem_bytes() >= ex.smem_bytes


def test_plan_cache_key_matches_cache_identity():
    cache = PlanCache(device="cpu")
    plan = cache.plan_for("unsharp-m", 24)
    assert plan.cache_key == ("unsharp-m", 24, mem_cfg_key(DP), 1, 1)
    full = {s: DP for s in cache.dag_for("unsharp-m").stages}
    assert cache.plan_for("unsharp-m", 24, mem=full) is plan
    assert cache.stats.plan_misses == 1


def test_row_group_plan_derived_without_recompile():
    """A plan differing only in rows_per_step is derived from its
    sibling: no second ILP solve, distinct identity, bigger rings."""
    cache = PlanCache(device="cpu")
    p1 = cache.plan_for("unsharp-m", 24)
    solve_s = cache.stats.plan_compile_s
    p8 = cache.plan_for("unsharp-m", 24, rows_per_step=8)
    assert p8 is not p1
    assert p8.rows_per_step == 8 and p1.rows_per_step == 1
    assert p8.cache_key[:3] == p1.cache_key[:3]
    assert p8.schedule is p1.schedule and p8.alloc is p1.alloc
    assert cache.stats.plan_compile_s - solve_s < solve_s
    assert p8.fingerprint() != p1.fingerprint()
    e1 = cache.executor_for("unsharp-m", 16, 24)
    e8 = cache.executor_for("unsharp-m", 16, 24, rows_per_step=8)
    assert e8.smem_bytes > e1.smem_bytes
    assert cache.stats.plan_misses == 2        # the ILP ran once
    dag = cache.dag_for("unsharp-m")
    for owner, rows in sp.smem_rings(dag, p8.alloc.buffers, 8).items():
        shs = [e.sh for e in dag.out_edges(owner)
               if not dag.stages[e.consumer].is_output]
        assert rows >= 8 + max(shs) - 1


def test_unknown_pipeline_raises():
    with pytest.raises(KeyError):
        PlanCache(device="cpu").plan_for("no-such-pipeline", 24)


def test_plan_lru_eviction_bounds_cache():
    cache = PlanCache(device="cpu", max_plans=2)
    cache.executor_for("unsharp-m", 16, 24)           # plan A + exec
    cache.plan_for("unsharp-m", 32)                   # plan B
    assert len(cache) == 2 and cache.stats.plan_evictions == 0
    cache.plan_for("unsharp-m", 40)                   # plan C evicts A
    assert len(cache) == 2
    assert cache.stats.plan_evictions == 1
    assert not any(k[1] == 24 for k in cache._plans)  # A gone...
    assert not any(k[1] == 24 for k in cache._execs)  # ...with its exec
    misses = cache.stats.plan_misses
    cache.plan_for("unsharp-m", 24)
    assert cache.stats.plan_misses == misses + 1
    assert cache.stats.plan_evictions == 2
    assert not any(k[1] == 32 for k in cache._plans)
    assert "plan_evictions" in cache.stats.snapshot()


def test_plan_lru_recency_updated_on_hit():
    cache = PlanCache(device="cpu", max_plans=2)
    cache.plan_for("unsharp-m", 24)                   # A
    cache.plan_for("unsharp-m", 32)                   # B
    cache.plan_for("unsharp-m", 24)                   # hit A: B is LRU now
    cache.plan_for("unsharp-m", 40)                   # evicts B, not A
    assert any(k[1] == 24 for k in cache._plans)
    assert not any(k[1] == 32 for k in cache._plans)


def test_exec_lru_eviction_bounds_cache():
    cache = PlanCache(device="cpu", max_execs=2)
    e16 = cache.executor_for("unsharp-m", 16, 24)
    cache.executor_for("unsharp-m", 20, 24)
    cache.executor_for("unsharp-m", 16, 24)      # hit: refresh recency
    cache.executor_for("unsharp-m", 24, 24)      # evicts the h=20 exec
    assert len(cache._execs) == 2
    assert cache.stats.exec_evictions == 1
    assert cache.executor_for("unsharp-m", 16, 24) is e16
    misses = cache.stats.exec_misses
    cache.executor_for("unsharp-m", 20, 24)
    assert cache.stats.exec_misses == misses + 1
    assert len(cache) == 1


def test_max_plans_validation():
    with pytest.raises(ValueError):
        PlanCache(device="cpu", max_plans=0)
    with pytest.raises(ValueError):
        PlanCache(device="cpu", max_execs=0)


# ----------------------------------------------------------------- tiling
def test_tile_origins_cover_without_gaps():
    for total, tile, halo in [(100, 58, 10), (64, 32, 4), (33, 32, 4),
                              (32, 32, 4), (200, 48, 17), (31, 48, 4)]:
        org = tile_origins(total, tile, halo)
        assert org[0] == 0
        if total <= tile:
            assert org == [0]
            continue
        assert org[-1] + tile == total
        covered = tile
        for a in org[1:]:
            assert a + halo <= covered
            covered = a + tile
        assert covered == total
    with pytest.raises(ValueError):
        tile_origins(100, 10, 10)


@pytest.mark.parametrize("name,hw", [
    ("canny-m", (50, 100)),     # wider and taller, non-divisible
    ("canny-m", (40, 70)),      # width not a multiple of the stride
    ("unsharp-m", (37, 101)),   # odd sizes
    ("unsharp-m", (30, 48)),    # exactly the compiled width, taller only
    ("xcorr-m", (61, 90)),      # tall halo (17 rows), no left halo
    ("denoise-m", (45, 77)),
])
def test_tiled_matches_reference(name, hw):
    h, w = hw
    cache = PlanCache(device="cpu")
    img = RNG.rand(h, w).astype(np.float32)
    got = execute_tiled(cache, name, {"in": img}, tile_h=40, tile_w=48,
                        batch=4)
    # tiling changes no arithmetic: exact against the untiled port
    untiled = sp.stencil_pipeline_plain(cache.dag_for(name),
                                        {"in": torch.from_numpy(img)})
    assert torch.equal(got, untiled)
    assert_ulp_equal(got.numpy(), oracle(name, img))


def test_tiled_single_tile_degenerates_to_plain_execution():
    cache = PlanCache(device="cpu")
    img = RNG.rand(20, 24).astype(np.float32)
    grid = plan_tile_grid(cache.dag_for("harris-s"), 20, 24, 40, 48)
    assert grid.n_tiles == 1 and grid.tile_h == 20 and grid.tile_w == 24
    got = execute_tiled(cache, "harris-s", {"in": img}, 40, 48)
    assert_ulp_equal(got.numpy(), oracle("harris-s", img))


def test_tiled_executor_compiles_once_per_tile_shape():
    """One ILP solve per tile shape; one executor per (tile shape, chunk
    size), reused across frames."""
    cache = PlanCache(device="cpu")
    for _ in range(3):
        img = RNG.rand(50, 100).astype(np.float32)
        execute_tiled(cache, "unsharp-m", {"in": img}, 40, 48, batch=4)
    assert cache.stats.plan_misses == 1
    assert cache.stats.exec_misses == 2          # chunks of 4 and 2 tiles
    assert cache.stats.exec_hits >= 4
