"""The CUDA kernel's source, compiled for the host, against its plain version.

The kernel runs only on a card, but its body is plain C++ apart from a
few CUDA names. These tests compile the body of
``src/repro_torch/kernels/csrc/stencil_pipeline.cu`` with the host C++
compiler under a small shim: one thread per block (``blockDim`` 1), so
``__syncthreads`` is a no-op; the ``_rn`` intrinsics as single float
operations under ``-ffp-contract=off``. Every CTA of a launch runs in
turn, its shared memory filled with NaN first, so a read of a ring row
the CTA never wrote shows in the output. The result must equal
``stencil_pipeline_plain`` bitwise, as the kernel must on the card.

This checks the kernel's index math, rings, halos, masks and operand
table at launch geometries the card's tests do not reach; the threads
themselves are checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Skips where no host C++ compiler is found.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, compile_pipeline
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.kernels._build import CSRC

NAMES = sorted(algorithms.ALGORITHMS)

_SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <vector>
using std::max;
using std::min;
struct Dim3 { int x, y, z; };
static Dim3 blockIdx{0, 0, 0}, threadIdx{0, 0, 0}, blockDim{1, 1, 1};
static float* g_smem;
#define __global__
#define __launch_bounds__(n)
#define __grid_constant__
#define __restrict__
#define __syncthreads()
#define __ldg(p) (*(p))
static float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static float __fsqrt_rn(float a) { return std::sqrt(a); }
"""

_LAUNCHER = r"""
extern "C" void host_launch(const int* table, const float* wts,
                            const void* const* feeds, void* out,
                            int gx, int gy, int gz) {
  Program P;
  memcpy(P.hdr, table, sizeof(P.hdr));
  memcpy(P.st, table + kHdr, sizeof(P.st));
  memcpy(P.ring, table + kHdr + kMaxStages * kStageInts, sizeof(P.ring));
  memcpy(P.wts, wts, sizeof(P.wts));
  Feeds F;
  for (int i = 0; i < kMaxFeeds; ++i)
    F.p[i] = static_cast<const float*>(feeds[i]);
  std::vector<float> sm(P.hdr[H_SMEM_BYTES] / 4 + 1);
  g_smem = sm.data();
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::fill(sm.begin(), sm.end(), NAN);
        blockIdx = Dim3{x, y, z};
        stencil_pipeline_kernel(P, F, static_cast<float*>(out));
      }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / "stencil_pipeline.cu").read_text()
    body = src[src.index("namespace {"):src.index("}  // namespace")]
    decl = "extern __shared__ float smem[];"
    assert decl in body
    body = body.replace(decl, "float* smem = g_smem;")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(_SHIM + body + "}  // namespace\n" + _LAUNCHER)
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(d / "k.so"),
                    str(d / "k.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    lib.host_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.host_launch.restype = None

    def launch(prog, x):
        out = np.full(x.shape, np.float32(-7.0))
        feeds = (ctypes.c_void_p * sp.MAX_FEEDS)(x.ctypes.data)
        lib.host_launch(prog.table.ctypes.data, prog.wts.ctypes.data, feeds,
                        out.ctypes.data, prog.grid_x, prog.grid_y,
                        x.shape[0])
        return out
    return launch


@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (16, 64),                       # many strips and bands
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", NAMES)
def test_host_compiled_kernel_matches_plain(host_kernel, name, strip_w,
                                            target_ctas):
    dag = algorithms.ALGORITHMS[name]()
    rng = np.random.RandomState(11)
    for h, w in [(37, 53), (5, 48), (70, 40)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            x = rng.rand(3, h, w).astype(np.float32)
            x[1] = 0.0                                    # idle slot
            prog = sp.build_program(dag, h, w, r, frames=3,
                                    alloc_buffers=plan.alloc.buffers,
                                    strip_w=strip_w, target_ctas=target_ctas)
            exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
            got = host_kernel(prog, x)
            assert np.array_equal(got, exp.numpy()), \
                (name, (h, w), r, strip_w, target_ctas, prog.band_h)
