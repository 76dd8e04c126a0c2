"""The CUDA kernel and the serving path on the card.

These tests need an NVIDIA GPU: on a machine without one they skip (the
kernel has no CPU mode; the CPU tests hold its plain version against the
JAX oracle). They import nothing of JAX, so they run where the port does:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bitwise. The kernel rounds every product and sum on its own
(``_rn`` intrinsics, built with ``-fmad=false``) in the plain version's
order, and its square root is correctly rounded like the plain one's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache, \
    execute_tiled
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.video import VideoEngine

NAMES = sorted(algorithms.ALGORITHMS)
VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)


def _tinternal():
    p = Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], algorithms.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frames(seed, n, h, w):
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_bitwise(cuda_device, name, r):
    dag = algorithms.ALGORITHMS[name]()
    frames = torch.from_numpy(_frames(9, 3, 37, 53)).to(cuda_device)
    frames[1] = 0.0                              # idle slot
    ex = sp.make_executor(dag, 37, 53, batch=3, rows_per_step=r,
                          device=cuda_device)
    before = sp.stencil_pipeline.launches
    got = ex({"in": frames})
    torch.cuda.synchronize()
    assert sp.stencil_pipeline.launches == before + 1
    assert torch.equal(got, sp.stencil_pipeline_plain(dag, {"in": frames}))


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(cuda_device):
    eng = FrameEngine(max_batch=3, max_pending=16, tile_shape=(40, 48),
                      device=cuda_device)
    reqs = [FrameRequest(rid=i, pipeline=["canny-m", "xcorr-m"][i % 2],
                         frames={"in": _frames(i, 1, *((50, 70) if i % 3
                                                       else (24, 32)))[0]})
            for i in range(8)]
    before = sp.stencil_pipeline.launches
    res = eng.run(reqs)
    assert sp.stencil_pipeline.launches > before
    for r in reqs:
        exp = sp.stencil_pipeline_plain(
            eng.cache.dag_for(r.pipeline),
            {"in": torch.as_tensor(r.frames["in"], device=cuda_device)})
        assert res[r.rid].device.type == "cuda"
        assert torch.equal(res[r.rid], exp)


@pytest.mark.cuda
def test_tiled_matches_plain_on_card(cuda_device):
    cache = PlanCache(device=cuda_device)
    img = torch.from_numpy(_frames(1, 1, 90, 130)[0]).to(cuda_device)
    got = execute_tiled(cache, "canny-m", {"in": img}, 40, 48, batch=4)
    exp = sp.stencil_pipeline_plain(cache.dag_for("canny-m"), {"in": img})
    assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name,chunk", [(n, c) for n in VIDEO
                                        for c in (None, 4)]
                         + [("tinternal", None)])
def test_temporal_kernel_matches_plain_bitwise(cuda_device, name, chunk, r):
    """K1c: a 12-frame stream from a zero state, output and every
    returned state equal to the plain version's on the same state
    (internal temporal producers run one frame a launch)."""
    dag = _tinternal() if name == "tinternal" \
        else algorithms.VIDEO_ALGORITHMS[name]()
    h, w = 37, 53
    vid = torch.from_numpy(_frames(4, 12, h, w)).to(cuda_device)
    ex = sp.make_video_executor(dag, h, w, rows_per_step=r, chunk=chunk,
                                device=cuda_device)
    state = ex.init_state()
    step = chunk or 1
    for t in range(0, 12, step):
        x = vid[t:t + step] if chunk else vid[t]
        before = sp.stencil_pipeline.launches
        got, new = ex({"in": x}, state)
        torch.cuda.synchronize()
        assert sp.stencil_pipeline.launches == before + 1
        inputs = {"in": x.reshape(-1, h, w)}
        exp, frames = sp.video_pipeline_plain(dag, {
            **inputs, **sp.tap_feeds(dag, inputs, state, step)})
        assert torch.equal(got.reshape(-1, h, w), exp)
        for p in ex.program.frame_outs:
            assert torch.equal(new[p][0], frames[p][0])
        state = new
    assert all(v.device.type == "cuda" for v in state.values())


@pytest.mark.cuda
def test_video_engine_serves_through_the_kernel(cuda_device):
    eng = VideoEngine(chunk=4, device=cuda_device)
    h, w = 40, 56
    vid = _frames(6, 10, h, w)
    sid = eng.open_stream("tbackground-t", h, w)
    before = sp.stencil_pipeline.launches
    res = eng.run({sid: [{"in": f} for f in vid]})
    assert sp.stencil_pipeline.launches > before
    exp = algorithms.execute_reference_video(
        eng.cache.dag_for("tbackground-t"),
        {"in": torch.from_numpy(vid).to(cuda_device)})
    got = torch.stack(res[sid])
    assert got.device.type == "cuda" and torch.equal(got, exp)
