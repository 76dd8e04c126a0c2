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
from repro_torch.imaging import FrameEngine, FrameRequest, PlanCache, \
    execute_tiled
from repro_torch.kernels import stencil_pipeline as sp

NAMES = sorted(algorithms.ALGORITHMS)


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
