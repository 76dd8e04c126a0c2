"""The CUDA kernel's source, compiled for the host, against its plain version.

The kernel runs only on a card, but its body is plain C++ apart from a
few CUDA names. These tests compile the body of
``src/repro_torch/kernels/csrc/stencil_pipeline.cu`` with the host C++
compiler under a small shim: one thread per block (``blockDim`` 1), so
``__syncthreads`` is a no-op; the ``_rn`` intrinsics as single float
operations under ``-ffp-contract=off``; the C library's ``floorf``,
``sinf``, ``powf``, ... for CUDA's, and ``rsqrtf`` as eager PyTorch
takes it on the CPU (1 over the root); PTX ``max.NaN`` / ``min.NaN``
(``max_nan`` / ``min_nan``) as the same rule in C++ (the kernel's own
``#ifdef __CUDA_ARCH__`` branch); the asynchronous copies as
deferred ones: each is recorded in the open commit group and lands (a
copy, or a zero fill) only at the wait that covers its group, as on the
card, so a read that overtakes its copy, or a wait count that drifts,
reads what the slot held before. Every CTA of a launch runs in turn, its
shared memory filled with NaN first, so a read of a ring row the CTA
never wrote shows in the output. The result must equal
``stencil_pipeline_plain`` bitwise (``video_pipeline_plain`` for a
temporal pipeline, over random frame-ring states), as the kernel must
on the card.

The conv2d kernels (``csrc/conv2d_stencil.cu``) compile under the same
shim and must equal ``conv2d_plain`` bitwise. The row-streaming kernel
has no barrier, so its CTAs run with all their threads (one after
another); the tile kernel keeps ``blockDim`` 1 and NaN-filled shared
memory. ``float2``/``float4`` are plain aligned structs there.

Expression stages (stage functions lowered by ``core/expr.py`` and
written out as CUDA functions by ``kernels/expr_codegen.py``) run under
the same shim, their generated fragment included at the kernel's
``STENCIL_EXPR`` hook: the bare form of every registered pipeline (each
payload replaced by its own eager function) must equal its payload form
bit for bit, at every geometry, width and depth the payload forms are
held at, and the fuzz harness's random DAGs (``repro_torch.core.fuzz``)
must equal the plain version. The stages a test module runs are compiled
into one host library (the module's ``HOST_EXPR_DAGS``), and a program
with a stage outside that list fails its test: a list that drifts from
its tests shows at once, not as a compile more per program.

This checks the kernel's index math, rings, halos, masks and operand
table at launch geometries the card's tests do not reach; the threads
themselves are checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Skips where no host C++ compiler is found.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms, compile_pipeline, expr, fuzz
from repro_torch.core.dsl import Pipeline
from repro_torch.kernels import conv2d_stencil, expr_codegen
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.kernels._build import CSRC

NAMES = sorted(algorithms.ALGORITHMS)
VIDEO = sorted(algorithms.VIDEO_ALGORITHMS)
TEMPORAL = VIDEO + ["tinternal", "tgeneric", "tstmean"]


def _tinternal():
    """A temporal tap on a computed stage (a frame output)."""
    p = Pipeline("tinternal")
    x = p.input("in")
    b = p.stage("blur", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    d = p.stage("diff", [(b, 2, 1, 1)], algorithms.frame_diff_fn)
    p.output("out", [(d, 1, 1)])
    return p.build()


def _tstmean():
    """A temporal pipeline whose final stage (a 4-frame mean of the
    input's history taps) sits at DAG level 1."""
    p = Pipeline("tstmean")
    x = p.input("in")
    m = p.stage("m", [(x, 4, 1, 1)], algorithms.stmean_fn(4, 1, 1))
    p.output("out", [(m, 1, 1)])
    return p.build()


def generic_pipeline(temporal: bool = False):
    """Windows no registered pipeline uses, so every window stage takes
    the kernel's generic body: a 7x2 conv, a 5x4 nms and, temporal, a
    (2, 3, 1) stmean joined to them by a product."""
    taps = np.random.RandomState(9).randn(7, 2).astype(np.float32)
    p = Pipeline("tgeneric" if temporal else "generic")
    x = p.input("in")
    a = p.stage("a", [(x, 7, 2)], algorithms.conv_fn(taps))
    n = p.stage("n", [(a, 5, 4)], algorithms.nms_fn)
    if temporal:
        m = p.stage("m", [(x, 2, 3, 1)], algorithms.stmean_fn(2, 3, 1))
        n = p.stage("j", [(n, 1, 1), (m, 1, 1)], algorithms.prod_fn)
    p.output("out", [(n, 1, 1)])
    return p.build()


def _dag(name, bare=False):
    """The named pipeline; ``bare``: every payload replaced by its eager
    function, so every computed stage takes the expression body."""
    if name == "tinternal":
        dag = _tinternal()
    elif name == "tstmean":
        dag = _tstmean()
    elif name in ("generic", "tgeneric"):
        dag = generic_pipeline(name == "tgeneric")
    else:
        dag = (algorithms.ALGORITHMS.get(name)
               or algorithms.VIDEO_ALGORITHMS[name])()
    return expr.bare_pipeline(dag) if bare else dag


_SHIM = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>
#define STENCIL_HOST_SHIM
using std::max;
using std::min;
struct Dim3 { int x, y, z; };
static Dim3 blockIdx{0, 0, 0}, threadIdx{0, 0, 0}, blockDim{1, 1, 1};
static float* g_smem;
#define __global__
#define __device__
#define __forceinline__ inline
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
static float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__
#define __syncthreads()
#define __ldg(p) (*(p))
static float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static float __fsqrt_rn(float a) { return std::sqrt(a); }
// CUDA's rsqrtf: eager PyTorch on the CPU divides 1 by the root
static float host_rsqrtf(float a) {
  volatile float r = 1.f / std::sqrt(a);
  return r;
}
#define rsqrtf host_rsqrtf
static float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
// cp.async: a copy joins the open group (the last one) and lands when a
// wait covers its group
struct Copy { float* dst; const float* src; int n; bool ok; };
static std::vector<std::vector<Copy>> g_groups(1);
static void land(std::vector<Copy>& g) {
  for (const Copy& k : g)
    for (int i = 0; i < k.n; ++i) k.dst[i] = k.ok ? k.src[i] : 0.f;
}
static void cp_async4(float* dst, const float* src, bool ok) {
  g_groups.back().push_back(Copy{dst, src, 1, ok});
}
static void cp_async16(float* dst, const float* src, bool ok) {
  g_groups.back().push_back(Copy{dst, src, 4, ok});
}
static void cp_async_commit() { g_groups.emplace_back(); }
// wait_all: commit, then wait until no group is pending
static void cp_async_wait_all() {
  for (auto& g : g_groups) land(g);
  g_groups.assign(1, {});
}
// at most min(n, 7) committed groups left pending
static void cp_async_wait(int n) {
  const int done = static_cast<int>(g_groups.size()) - 1 - std::min(n, 7);
  for (int i = 0; i < done; ++i) land(g_groups[i]);
  if (done > 0) g_groups.erase(g_groups.begin(), g_groups.begin() + done);
}
"""

_LAUNCHER = r"""
// every instantiation: the fragment's bodies serve spatial and temporal,
// depth 1 and prefetch programs alike
static Kernel host_pick(int temporal, int prefetch) {
  if (prefetch)
    return temporal ? stencil_pipeline_kernel<true, true>
                    : stencil_pipeline_kernel<false, true>;
  return temporal ? stencil_pipeline_kernel<true, false>
                  : stencil_pipeline_kernel<false, false>;
}

// returns the CTAs that ended with copies no wait covered
extern "C" int host_launch(const int* table, const float* wts,
                           const void* const* feeds, void* const* outs,
                           int gx, int gy, int gz) {
  int unwaited = 0;
  Program P;
  memcpy(P.hdr, table, sizeof(P.hdr));
  memcpy(P.st, table + kHdr, sizeof(P.st));
  memcpy(P.ring, table + kHdr + kMaxStages * kStageInts, sizeof(P.ring));
  memcpy(P.wts, wts, sizeof(P.wts));
  Feeds F;
  for (int i = 0; i < kMaxFeeds; ++i)
    F.p[i] = static_cast<const float*>(feeds[i]);
  Outs O;
  for (int i = 0; i < kMaxOuts; ++i) O.p[i] = static_cast<float*>(outs[i]);
  uintptr_t bits = 0;
  for (int i = 0; i < kMaxFeeds; ++i)
    bits |= reinterpret_cast<uintptr_t>(feeds[i]);
  for (int i = 0; i < kMaxOuts; ++i)
    bits |= reinterpret_cast<uintptr_t>(outs[i]);
  if (bits & 15) P.hdr[H_VEC] = 0;
  std::vector<float> sm(P.hdr[H_SMEM_BYTES] / 4 + 4);
  g_smem = sm.data();
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::fill(sm.begin(), sm.end(), NAN);
        g_groups.assign(1, {});
        blockIdx = Dim3{x, y, z};
        host_pick(P.hdr[H_TEMPORAL], P.hdr[H_DEPTH] > 1)(P, F, O);
        // a copy never waited for: the CTA ended before it landed
        for (const auto& g : g_groups) unwaited += !g.empty();
      }
  return unwaited;
}
"""


_CONV_LAUNCHER = r"""
extern "C" int host_conv2d(const float* img, const float* wts, float* out,
                           int h, int w, int kh, int kw, int band,
                           int cols) {
  if (kh <= kMaxTap && kw <= kMaxTap) {
    const RowKernel kernel = pick_rows(kh, kw, cols);
    if (kernel == nullptr) return -1;
    const bool vec = use_vector(img, out, w, cols);
    const int per_row = (w + cols - 1) / cols;
    blockDim = Dim3{kThreads, 1, 1};
    for (int y = 0; y < (h + band - 1) / band; ++y)
      for (int x = 0; x < (per_row + kThreads - 1) / kThreads; ++x)
        for (int t = 0; t < kThreads; ++t) {
          blockIdx = Dim3{x, y, 0};
          threadIdx = Dim3{t, 0, 0};
          kernel(img, wts, out, h, w, band, vec);
        }
    return vec ? kRowsVector : kRowsScalar;
  }
  std::vector<float> sm(kh * kw + (band + kh - 1) * (kStripW + kw - 1));
  g_smem = sm.data();
  blockDim = Dim3{1, 1, 1};
  threadIdx = Dim3{0, 0, 0};
  for (int y = 0; y < (h + band - 1) / band; ++y)
    for (int x = 0; x < (w + kStripW - 1) / kStripW; ++x) {
      std::fill(sm.begin(), sm.end(), NAN);
      blockIdx = Dim3{x, y, 0};
      conv2d_tile(img, wts, out, h, w, kh, kw, band);
    }
  return kTile;
}
"""


def _host_library(tmp_path_factory, source: str, launcher: str,
                  fragment: str | None = None):
    """``csrc/<source>``'s kernel body compiled for the host under the
    shim, with ``launcher`` appended and ``fragment`` at the
    STENCIL_EXPR hook."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / source).read_text()
    body = src[src.index("namespace {"):src.index("}  // namespace")]
    decl = "extern __shared__ float smem[];"
    assert decl in body
    body = body.replace(decl, "float* smem = g_smem;")
    d = tmp_path_factory.mktemp("host_kernel")
    hook = ""
    if fragment is not None:
        (d / "expr.cuh").write_text(fragment)
        hook = (f'#define STENCIL_EXPR "{d / "expr.cuh"}"\n'
                "#define STENCIL_EXPR_TEMPORAL 0\n"
                "#define STENCIL_EXPR_PREFETCH 0\n")
    (d / "k.cpp").write_text(_SHIM + hook + body + "}  // namespace\n"
                             + launcher)
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-fno-strict-aliasing",
                    "-shared", "-fPIC", "-o", str(d / "k.so"),
                    str(d / "k.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "k.so"))


# the worker's stencil host libraries by fragment (a module's fixture can
# be set up again when the worker comes back to the module)
_STENCIL_LIBS: dict[str, ctypes.CDLL] = {}


def _stencil_library(tmp_path_factory, fragment: str) -> ctypes.CDLL:
    lib = _STENCIL_LIBS.get(fragment)
    if lib is None:
        lib = _STENCIL_LIBS[fragment] = _host_library(
            tmp_path_factory, "stencil_pipeline.cu", _LAUNCHER, fragment)
        lib.host_launch.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 3
        lib.host_launch.restype = ctypes.c_int
    return lib


def module_stages(dags) -> dict:
    """{stage id: lowered stage} of every expression stage of ``dags``."""
    stages = {}
    for dag in dags:
        for ex in sp.build_program(dag, 16, 64, 1).exprs.values():
            stages[expr_codegen.stage_id(ex)] = ex
    return stages


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory, request):
    """Launch a program under the shim: one host library holds the
    expression stages of the requesting module's ``HOST_EXPR_DAGS()``,
    and a program with any other expression stage fails."""
    make = getattr(request.module, "HOST_EXPR_DAGS", None)
    stages = module_stages(make() if make else [])
    lib = _stencil_library(tmp_path_factory,
                           expr_codegen.expr_source(stages.values()))

    def launch(prog, x, states=()):
        """Output (and frame outputs, if any) of ``prog`` over input
        frames ``x`` and frame-ring ``states``."""
        missing = {name for name, ex in prog.exprs.items()
                   if expr_codegen.stage_id(ex) not in stages}
        assert not missing, (f"{prog.dag.name}: stages {sorted(missing)} "
                             f"are in no DAG of HOST_EXPR_DAGS()")
        outs = [np.full(x.shape, np.float32(-7.0))
                for _ in range(1 + len(prog.frame_outs))]
        feeds = (ctypes.c_void_p * sp.MAX_FEEDS)(
            *[a.ctypes.data for a in (x, *states)])
        optrs = (ctypes.c_void_p * sp.MAX_OUTS)(
            *[a.ctypes.data for a in outs])
        assert lib.host_launch(prog.table.ctypes.data, prog.wts.ctypes.data,
                               feeds, optrs, prog.grid_x, prog.grid_y,
                               x.shape[0]) == 0, "copies no wait covered"
        if prog.frame_outs:
            return outs[0], dict(zip(prog.frame_outs, outs[1:]))
        return outs[0]
    return launch


def HOST_EXPR_DAGS():
    """The expression stages this module runs: the bare forms and the
    fuzz DAGs (payload and bare convolutions, spatial and temporal)."""
    return [_dag(n, bare=True) for n in NAMES + TEMPORAL + ["generic"]] + [
        fuzz.random_pipeline(seed, conv, temporal=t) for seed in range(8)
        for conv in (algorithms.conv_fn, fuzz.bare_conv)
        for t in (False, True)]


@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (16, 64),                       # many strips and bands
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", NAMES + ["generic"])
def test_host_compiled_kernel_matches_plain(host_kernel, name, strip_w,
                                            target_ctas):
    dag = _dag(name)
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


@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", TEMPORAL)
def test_host_compiled_temporal_kernel_matches_plain(host_kernel, name,
                                                     strip_w, target_ctas):
    """History taps read from the launch's own earlier frames and from
    random frame-ring states, and frame outputs, equal the plain
    version bitwise."""
    dag = _dag(name)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(5)
    batches = (1,) if name == "tinternal" else (1, 4)
    for h, w in [(13, 24), (37, 53)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            for b in batches:
                x = rng.rand(b, h, w).astype(np.float32)
                states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                          for p in sorted(depths,
                                          key=dag.topo_order.index)]
                prog = sp.build_program(dag, h, w, r, frames=b,
                                        alloc_buffers=plan.alloc.buffers,
                                        strip_w=strip_w,
                                        target_ctas=target_ctas)
                inputs = {"in": torch.from_numpy(x)}
                ring = {p: torch.from_numpy(a)
                        for p, a in zip(prog.states, states)}
                out, frames = sp.video_pipeline_plain(
                    dag, {**inputs, **sp.tap_feeds(dag, inputs, ring, b)})
                got = host_kernel(prog, x, states)
                where = (name, (h, w), r, b, strip_w, target_ctas)
                if prog.frame_outs:
                    got, got_frames = got
                    for p in prog.frame_outs:
                        assert np.array_equal(got_frames[p],
                                              frames[p].numpy()), where
                assert np.array_equal(got, out.numpy()), where


def _n_steps(prog, y):
    """Row groups of the band starting at row ``y``."""
    up = int(prog.table[sp.H_HALO_UP])
    lo, hi = max(y - up, 0), min(y + prog.band_h, prog.h)
    return -(-(hi - lo) // prog.rows_per_step)


def _feed_rings(prog):
    """(rows, lead) of each feed stage's ring: its rows in the ring table
    (None: no ring) and the rows its copies fill before any read
    (S_LEAD)."""
    rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
    rings = prog.table[sp.HDR + sp.MAX_STAGES * sp.STAGE_INTS:].reshape(-1, 2)
    return [(int(rings[r[sp.S_RING], 1]) if r[sp.S_RING] >= 0 else None,
             int(r[sp.S_LEAD]))
            for r in rows[:int(prog.table[sp.H_NSTAGES])]
            if sp.KINDS[r[sp.S_KIND]] == "feed"]


def _check_grown(prog, depth):
    """Every feed has a ring whose lead (the slots copies write before
    any read, poisoned with NaN first) holds the d row groups of the
    prologue, and the rest of the ring (the zero tail that stands for
    the rows above the band) lies past them."""
    r = prog.rows_per_step
    for rows, lead in _feed_rings(prog):
        assert rows is not None and depth * r <= lead <= rows, (rows, lead)


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (16, 64),                       # many strips and bands
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", NAMES + ["generic"])
def test_host_compiled_prefetch_kernel_matches_plain(host_kernel, name,
                                                     strip_w, target_ctas,
                                                     depth):
    """Prefetch depth 2, 3 and 4: every feed copied d - 1 row groups ahead
    into its grown ring (rings wrap mid-group at R = 3 and 8), the copies
    deferred until the wait that covers them, equals the plain version
    bitwise, bands with fewer row groups than the depth included; at R =
    1 and 3 the grown slots start as NaN (poison_prefetch)."""
    dag = _dag(name)
    rng = np.random.RandomState(12)
    short = False
    for h, w in [(37, 53), (5, 48), (70, 40)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            x = rng.rand(3, h, w).astype(np.float32)
            x[1] = 0.0                                    # idle slot
            prog = sp.build_program(dag, h, w, r, frames=3,
                                    alloc_buffers=plan.alloc.buffers,
                                    strip_w=strip_w, target_ctas=target_ctas,
                                    prefetch_depth=depth,
                                    poison_prefetch=r != 8)
            _check_grown(prog, depth)
            short |= any(_n_steps(prog, y) < depth
                         for y in range(0, h, prog.band_h))
            exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
            got = host_kernel(prog, x)
            assert np.array_equal(got, exp.numpy()), \
                (name, (h, w), r, depth, strip_w, target_ctas, prog.band_h)
    assert short


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (16, 64),                       # many strips and bands
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", TEMPORAL)
def test_host_compiled_prefetch_temporal_kernel_matches_plain(
        host_kernel, name, strip_w, target_ctas, depth):
    """Prefetch depth 2, 3 and 4 on the temporal table: inputs and every
    history tap (launch frames and random frame-ring states) copied ahead
    into their own grown rings, poisoned with NaN first; output and frame
    outputs equal the plain version bitwise."""
    dag = _dag(name)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(6)
    batches = (1,) if name == "tinternal" else (1, 4)
    for h, w in [(13, 24), (37, 53)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            for b in batches:
                x = rng.rand(b, h, w).astype(np.float32)
                states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                          for p in sorted(depths,
                                          key=dag.topo_order.index)]
                prog = sp.build_program(dag, h, w, r, frames=b,
                                        alloc_buffers=plan.alloc.buffers,
                                        strip_w=strip_w,
                                        target_ctas=target_ctas,
                                        prefetch_depth=depth,
                                        poison_prefetch=True)
                _check_grown(prog, depth)
                n_feeds = len(prog.feeds) + len(sp.temporal_taps(dag))
                assert len(_feed_rings(prog)) == n_feeds
                inputs = {"in": torch.from_numpy(x)}
                ring = {p: torch.from_numpy(a)
                        for p, a in zip(prog.states, states)}
                out, frames = sp.video_pipeline_plain(
                    dag, {**inputs, **sp.tap_feeds(dag, inputs, ring, b)})
                got = host_kernel(prog, x, states)
                where = (name, (h, w), r, b, depth, strip_w, target_ctas)
                if prog.frame_outs:
                    got, got_frames = got
                    for p in prog.frame_outs:
                        assert np.array_equal(got_frames[p],
                                              frames[p].numpy()), where
                assert np.array_equal(got, out.numpy()), where


@pytest.mark.parametrize("name", ["xcorr-m", "tunsharp-t"])
def test_host_compiled_prefetch_poison_spares_the_zero_tail(host_kernel,
                                                           name):
    """With poison_prefetch the grown slots start as NaN and none reaches
    an output, while the zero tail (the slots that stand for the rows
    above the band, read by the first row group) stays zero: poisoning
    the whole ring instead puts NaN into the output."""
    dag = _dag(name)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(16)
    h, w = 37, 53
    plan = compile_pipeline(dag, w)
    x = rng.rand(1, h, w).astype(np.float32)
    states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
              for p in sorted(depths, key=dag.topo_order.index)]
    inputs = {"in": torch.from_numpy(x)}
    for r in (3, 8):
        prog = sp.build_program(dag, h, w, r,
                                alloc_buffers=plan.alloc.buffers,
                                target_ctas=8, prefetch_depth=3,
                                poison_prefetch=True)
        assert any(rows > lead for rows, lead in _feed_rings(prog))
        out, _ = sp.video_pipeline_plain(dag, {**inputs, **sp.tap_feeds(
            dag, inputs, {p: torch.from_numpy(a)
                          for p, a in zip(prog.states, states)}, 1)})
        assert np.array_equal(host_kernel(prog, x, states), out.numpy())
        whole = dataclasses.replace(prog, table=prog.table.copy())
        stages = whole.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
        for row in stages[:int(whole.table[sp.H_NSTAGES])]:
            if sp.KINDS[row[sp.S_KIND]] == "feed":
                row[sp.S_LEAD] = whole.table[
                    sp.HDR + sp.MAX_STAGES * sp.STAGE_INTS
                    + 2 * row[sp.S_RING] + 1]
        got = host_kernel(whole, x, states)
        assert np.isnan(got).any() and not np.isnan(out.numpy()).any()


def test_stage_bodies_cover_the_registered_pipelines():
    """Every stage of the 11 registered pipelines runs an unrolled body
    (feed, pointwise or one of the unrolled window shapes); the window
    stages of the DSL pipelines with unusual shapes take the generic
    one."""
    def kinds(dag):
        prog = sp.build_program(dag, 16, 24, 8)
        rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
        return [sp.KINDS[r[sp.S_KIND]]
                for r in rows[:int(prog.table[sp.H_NSTAGES])]]
    for name in NAMES + VIDEO:
        assert "generic" not in kinds(_dag(name)), name
        assert "expr" not in kinds(_dag(name)), name
        assert set(kinds(_dag(name, bare=True))) <= {"feed", "expr"}, name
    assert kinds(_dag("canny-m")) == [
        "feed", "conv1x5", "conv5x1", "conv3x1", "conv1x3", "point",
        "nms3x3", "nms3x3", "point"]
    assert set(kinds(_dag("tunsharp-t"))) == {"feed", "stmean333", "point"}
    assert kinds(_dag("generic")) == ["feed", "generic", "generic"]
    assert kinds(_dag("tgeneric")).count("generic") == 3


def test_barriers_follow_dag_levels():
    """Stages sort by DAG level and only a level's last stage ends in a
    barrier: canny-m's two gradients share one."""
    prog = sp.build_program(_dag("canny-m"), 16, 24, 8)
    rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
    n = int(prog.table[sp.H_NSTAGES])
    assert [int(r[sp.S_SYNC]) for r in rows[:n]] == [1, 1, 1, 0, 1, 1, 1,
                                                     1, 1]
    prog = sp.build_program(_dag("tbackground-t"), 16, 24, 8)
    rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
    # seven taps and the input are level 0: one barrier for all eight
    assert [int(r[sp.S_SYNC]) for r in rows[:10]] == [0] * 7 + [1, 1, 1]


@pytest.mark.parametrize("cu,py", [("kThreads", "THREADS"),
                                   ("kMinBlocks", "MIN_BLOCKS")])
def test_occupancy_model_uses_the_kernels_launch_bounds(cu, py):
    """build_program's CTAs-per-SM model (``_resident``: threads per CTA,
    CTAs per SM that registers allow) takes the kernel's launch bounds."""
    src = (CSRC / "stencil_pipeline.cu").read_text()
    assert "__launch_bounds__(kThreads, kMinBlocks)" in src
    m = re.search(rf"constexpr int {cu} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(sp, py)


# frames narrower than a 4-column vector allows (53, 130, 257: scalar
# loads and stores) and 1920 (float4); 70 rows make two bands at 1920
WIDTHS = [(12, 1920), (70, 1920), (9, 130), (7, 257), (11, 53)]


@pytest.mark.parametrize("name", NAMES + ["generic"])
def test_host_compiled_kernel_vector_and_scalar_widths(host_kernel, name):
    """The executors' geometry (strip 0 and inner strips, band 0 and an
    inner band) over vector and scalar widths at R = 1, 3, 8 equals the
    plain version bitwise; 1920 takes the float4 path."""
    dag = _dag(name)
    rng = np.random.RandomState(13)
    for h, w in WIDTHS:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            x = rng.rand(2, h, w).astype(np.float32)
            prog = sp.build_program(dag, h, w, r, frames=2,
                                    alloc_buffers=plan.alloc.buffers,
                                    target_ctas=10**6)
            assert int(prog.table[sp.H_VEC]) == (w % 4 == 0)
            assert prog.grid_x == -(-w // min(sp.STRIP_W, w))
            exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
            got = host_kernel(prog, x)
            assert np.array_equal(got, exp.numpy()), (name, (h, w), r)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_host_compiled_kernel_passes_an_input_through(host_kernel, depth):
    """An output wired straight to the input: the feed stage writes the
    output rows itself (level 0, before the first barrier), at a scalar
    and a vector width. At depth >= 2 the input, read by no stage, gets
    a ring of d * R rows for its copies to land in, and each thread
    moves the rows it copied from there to the output block."""
    p = Pipeline("through")
    p.output("out", [(p.input("in"), 1, 1)])
    dag = p.build()
    rng = np.random.RandomState(15)
    for h, w in [(37, 53), (20, 1920)]:
        for r in (1, 3, 8):
            x = rng.rand(2, h, w).astype(np.float32)
            prog = sp.build_program(dag, h, w, r, frames=2,
                                    target_ctas=10**6, prefetch_depth=depth,
                                    poison_prefetch=depth > 1)
            assert int(prog.table[sp.H_OSYNC]) == 1
            assert _feed_rings(prog) == [(None, 0) if depth == 1
                                         else (depth * r, depth * r)]
            assert np.array_equal(host_kernel(prog, x), x), ((h, w), r)


@pytest.mark.parametrize("name", TEMPORAL)
def test_host_compiled_temporal_kernel_vector_widths(host_kernel, name):
    """History taps and frame outputs at 1920 (float4 feeds) and 130
    (scalar) over chunks of 4 (1 with a frame output) equal the plain
    version bitwise."""
    dag = _dag(name)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(14)
    b = 1 if name == "tinternal" else 4
    for h, w in [(12, 1920), (9, 130)]:
        plan = compile_pipeline(dag, w)
        for r in (3, 8):
            x = rng.rand(b, h, w).astype(np.float32)
            states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                      for p in sorted(depths, key=dag.topo_order.index)]
            prog = sp.build_program(dag, h, w, r, frames=b,
                                    alloc_buffers=plan.alloc.buffers)
            assert int(prog.table[sp.H_VEC]) == (w % 4 == 0)
            inputs = {"in": torch.from_numpy(x)}
            ring = {p: torch.from_numpy(a)
                    for p, a in zip(prog.states, states)}
            out, frames = sp.video_pipeline_plain(
                dag, {**inputs, **sp.tap_feeds(dag, inputs, ring, b)})
            got = host_kernel(prog, x, states)
            if prog.frame_outs:
                got, got_frames = got
                for p in prog.frame_outs:
                    assert np.array_equal(got_frames[p], frames[p].numpy())
            assert np.array_equal(got, out.numpy()), (name, (h, w), r)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (16, 64),                       # many strips and bands
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", NAMES + ["generic"])
def test_host_compiled_bare_kernel_matches_payload_form(host_kernel, name,
                                                        strip_w, target_ctas,
                                                        depth):
    """Every computed stage through the expression body: the bare form
    equals the payload form and the plain version bit for bit, at the
    payload forms' geometries, depths 1 to 4 (the grown slots poisoned
    at R = 1 and 3)."""
    dag, bare = _dag(name), _dag(name, bare=True)
    rng = np.random.RandomState(17)
    for h, w in [(37, 53), (5, 48), (70, 40)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            x = rng.rand(3, h, w).astype(np.float32)
            x[1] = 0.0                                    # idle slot
            got = {}
            for form, d in (("payload", dag), ("bare", bare)):
                prog = sp.build_program(d, h, w, r, frames=3,
                                        alloc_buffers=plan.alloc.buffers,
                                        strip_w=strip_w,
                                        target_ctas=target_ctas,
                                        prefetch_depth=depth,
                                        poison_prefetch=depth > 1 and r != 8)
                assert int(prog.table[sp.H_EXPR]) == (form == "bare")
                got[form] = host_kernel(prog, x)
            exp = sp.stencil_pipeline_plain(bare, {"in": torch.from_numpy(x)})
            where = (name, (h, w), r, depth, strip_w, target_ctas)
            assert np.array_equal(got["bare"], got["payload"]), where
            assert np.array_equal(got["bare"], exp.numpy()), where


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("strip_w,target_ctas", [
    (sp.STRIP_W, sp.TARGET_CTAS),   # the executors' geometry
    (7, 1),                         # strips narrower than the halo
])
@pytest.mark.parametrize("name", TEMPORAL)
def test_host_compiled_bare_temporal_kernel_matches_payload_form(
        host_kernel, name, strip_w, target_ctas, depth):
    """The temporal table's bare forms (temporal windows, a select on
    axis -3 in frame_diff, frame outputs) over random frame-ring states
    and chunks of 4 equal the payload forms and the plain version."""
    dag, bare = _dag(name), _dag(name, bare=True)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(18)
    batches = (1,) if name == "tinternal" else (1, 4)
    for h, w in [(13, 24), (37, 53)]:
        plan = compile_pipeline(dag, w)
        for r in (1, 3, 8):
            for b in batches:
                x = rng.rand(b, h, w).astype(np.float32)
                states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                          for p in sorted(depths,
                                          key=dag.topo_order.index)]
                got = {}
                for form, d in (("payload", dag), ("bare", bare)):
                    prog = sp.build_program(
                        d, h, w, r, frames=b,
                        alloc_buffers=plan.alloc.buffers, strip_w=strip_w,
                        target_ctas=target_ctas, prefetch_depth=depth,
                        poison_prefetch=depth > 1)
                    got[form] = host_kernel(prog, x, states)
                inputs = {"in": torch.from_numpy(x)}
                ring = {p: torch.from_numpy(a)
                        for p, a in zip(prog.states, states)}
                out, frames = sp.video_pipeline_plain(
                    bare, {**inputs, **sp.tap_feeds(bare, inputs, ring, b)})
                where = (name, (h, w), r, b, depth, strip_w, target_ctas)
                if prog.frame_outs:
                    for p in prog.frame_outs:
                        assert np.array_equal(got["bare"][1][p],
                                              got["payload"][1][p]), where
                        assert np.array_equal(got["bare"][1][p],
                                              frames[p].numpy()), where
                    got = {k: v[0] for k, v in got.items()}
                assert np.array_equal(got["bare"], got["payload"]), where
                assert np.array_equal(got["bare"], out.numpy()), where


@pytest.mark.parametrize("name", NAMES + TEMPORAL)
def test_host_compiled_bare_kernel_vector_and_scalar_widths(host_kernel,
                                                            name):
    """The bare forms at the executors' geometry over vector (1920) and
    scalar widths equal the payload forms bit for bit."""
    dag, bare = _dag(name), _dag(name, bare=True)
    depths = dag.temporal_depths()
    rng = np.random.RandomState(19)
    b = 1 if name == "tinternal" else 2
    for h, w in [(12, 1920), (9, 130), (11, 53)]:
        plan = compile_pipeline(dag, w)
        for r in (3, 8):
            x = rng.rand(b, h, w).astype(np.float32)
            states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                      for p in sorted(depths, key=dag.topo_order.index)]
            got = []
            for d in (dag, bare):
                prog = sp.build_program(d, h, w, r, frames=b,
                                        alloc_buffers=plan.alloc.buffers,
                                        target_ctas=10**6)
                res = host_kernel(prog, x, states)
                got.append(res[0] if prog.frame_outs else res)
            assert np.array_equal(got[0], got[1]), (name, (h, w), r)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("form", ["payload", "bare"])
def test_host_compiled_fuzz_dags_match_plain(host_kernel, form, temporal,
                                             depth):
    """The fuzz harness's random DAGs (seeds 0-7; blends, drains and the
    temporal convolution lowered, the spatial convolutions as payloads or
    lowered) equal the plain version bit for bit at scalar and vector
    widths, R = 1, 3, 8, chunks of 4 for the temporal variant."""
    rng = np.random.RandomState(20)
    conv = fuzz.bare_conv if form == "bare" else algorithms.conv_fn
    for seed in range(8):
        dag = fuzz.random_pipeline(seed, conv, temporal=temporal)
        depths = dag.temporal_depths()
        b = 4 if temporal else 2
        for h, w in [(37, 53), (20, 40), (12, 1920)]:
            for r in (1, 3, 8):
                x = rng.rand(b, h, w).astype(np.float32)
                states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
                          for p in sorted(depths, key=dag.topo_order.index)]
                prog = sp.build_program(dag, h, w, r, frames=b,
                                        target_ctas=64, prefetch_depth=depth,
                                        poison_prefetch=depth > 1)
                inputs = {"in": torch.from_numpy(x)}
                ring = {p: torch.from_numpy(a)
                        for p, a in zip(prog.states, states)}
                out, _ = sp.video_pipeline_plain(
                    dag, {**inputs, **sp.tap_feeds(dag, inputs, ring, b)})
                got = host_kernel(prog, x, states)
                assert np.array_equal(got, out.numpy()), \
                    (seed, (h, w), r, depth)


@pytest.fixture(scope="module")
def host_conv2d(tmp_path_factory):
    lib = _host_library(tmp_path_factory, "conv2d_stencil.cu",
                        _CONV_LAUNCHER)
    lib.host_conv2d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    lib.host_conv2d.restype = ctypes.c_int

    def launch(img, wts, band, cols=conv2d_stencil.COLS, offset=0):
        """(output, variant) of the kernel the launch picks; ``offset``
        floats shift the image and output off their 16-byte alignment."""
        h, w = img.shape
        src = np.zeros(h * w + offset, np.float32)
        src[offset:] = img.ravel()
        out = np.full(h * w + offset, np.float32(-7.0))
        ran = lib.host_conv2d(src[offset:].ctypes.data, wts.ctypes.data,
                              out[offset:].ctypes.data, h, w, *wts.shape,
                              band, cols)
        assert ran >= 0, (wts.shape, cols)
        return out[offset:].reshape(h, w), conv2d_stencil.VARIANTS[ran]
    return launch


# every filter of the JAX sweep, the largest square and non-square ones
# the row kernel takes, and two that take the tile kernel
CONV_FILTERS = [(1, 1), (3, 3), (1, 5), (5, 1), (2, 4), (5, 5), (7, 7),
                (4, 6), (7, 2), (3, 7), (8, 3), (9, 9)]
# the JAX sweep's shapes (w % 4 != 0 at 130 and 257), and wider frames
# with w % 4 == 0 over more than one CTA strip
CONV_SHAPES = [(8, 16), (20, 24), (13, 130), (9, 257), (37, 1028),
               (3, 516)]


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16, 64])
@pytest.mark.parametrize("k", CONV_FILTERS)
def test_host_compiled_conv2d_matches_plain(host_conv2d, k, tile_rows):
    """Both conv2d kernels over frames narrower and wider than one strip,
    bands (or tiles) of ``tile_rows`` rows, taller and shorter than the
    frame with h % tile_rows != 0, vector rows (w % 4 == 0, aligned) and
    scalar ones, equal conv2d_plain bitwise; shared memory is NaN before
    each CTA."""
    band = tile_rows
    rows = conv2d_stencil.uses_rows(*k)
    assert conv2d_stencil.smem_bytes(*k, band) == (0 if rows else 4 * (
        k[0] * k[1] + (band + k[0] - 1) * (conv2d_stencil.STRIP_W + k[1]
                                           - 1)))
    rng = np.random.RandomState(3)
    seen = set()
    for h, w in CONV_SHAPES:
        img = rng.rand(h, w).astype(np.float32)
        wts = rng.randn(*k).astype(np.float32)
        exp = conv2d_stencil.conv2d_plain(torch.from_numpy(img),
                                          torch.from_numpy(wts)).numpy()
        for offset in (0, 1):
            got, variant = host_conv2d(img, wts, band, offset=offset)
            assert np.array_equal(got, exp), ((h, w), k, band, offset)
            seen.add(variant)
    assert seen == ({"rows_vector", "rows_scalar"} if rows else {"tile"})


@pytest.mark.parametrize("cols", [1, 2, 4])
@pytest.mark.parametrize("k", [(3, 3), (5, 5)])
def test_host_compiled_conv2d_columns_per_thread(host_conv2d, k, cols):
    """The 1080p filters at 1, 2 and 4 output columns per thread (the
    launch-geometry sweep's kernels) equal conv2d_plain bitwise."""
    rng = np.random.RandomState(4)
    for h, w in [(21, 130), (19, 520)]:
        img = rng.rand(h, w).astype(np.float32)
        wts = rng.randn(*k).astype(np.float32)
        exp = conv2d_stencil.conv2d_plain(torch.from_numpy(img),
                                          torch.from_numpy(wts)).numpy()
        for band in (4, 16):
            got, variant = host_conv2d(img, wts, band, cols=cols)
            assert np.array_equal(got, exp), ((h, w), k, band, cols)
            assert variant == ("rows_vector" if cols > 1 and w % cols == 0
                               else "rows_scalar")
