// Fused line-buffered stencil pipeline on Hopper (sm_90a).
//
// Replaces repro/kernels/stencil_pipeline.py::_build_pipeline_call of the
// JAX package: the single-frame spatial kernel, its batched grid, its
// temporal form (history taps and frame outputs), and its prefetch_depth
// >= 2 form (input rings filled by asynchronous copies ahead of compute).
// One launch runs a whole pipeline DAG over a batch of frames; every
// intermediate stage lives only in shared-memory ring line buffers (the
// paper's line buffer), so device memory sees each input pixel read once
// and each output pixel written once.
//
// What bounds it: per frame it must move (n_inputs + 1) * h * w * 4 bytes
// -- 16.6 MB for one 1080p input and output, about 5 us at the 3.35 TB/s
// of an H100 SXM -- against a few tens of float32 operations per pixel,
// so the bound is device-memory bytes. A temporal launch adds the history
// frames it reads (d-1 per temporal producer) and the frames of internal
// temporal producers it writes. This kernel is simple rather than fast:
// it loads with plain coalesced reads, runs one thread per (row, column)
// of a row group, and synchronises the block between stages. TMA row
// loads into an mbarrier ring and warp specialisation are later work.
//
// Work split. The TPU kernel walks a frame sequentially on one core with
// rings carried across grid steps. Here one CTA owns one (frame, column
// strip, row band) and loops over row groups of R rows top to bottom,
// keeping one ring per producer in dynamic shared memory:
//   * a strip of strip_w output columns recomputes its left halo of
//     halo_left columns (the DAG's cumulative stencil width) from real
//     input; a band recomputes its top halo of halo_up rows likewise.
//     Reads left of the strip's first stored column or above the band's
//     first computed row return zero, but only values inside the halo
//     ever see them, and the halo is never written out. Only reads at
//     frame row < 0 or frame column < 0 give the zero of the frame edge:
//     a halo is never zero-filled (mag maps 0 to sqrt(1e-6)).
//   * a CTA owns exactly one frame of the batch, so batched frames never
//     see one another's ring residue.
//   * rows at and below h (the last partial row group) and columns at
//     and beyond w compute from zero input and are never stored.
//
// Temporal pipelines. Each history tap (producer p, j frames back) is a
// pseudo-input stage (OP_TAP) with its own ring, filled like an input
// over the CTA's strip and band halos. Frame b of the launch reads tap j
// from input frame b - j of the same launch when b >= j (a chunk of
// consecutive frames serves its own history), else from slot j - b - 1
// of p's frame-ring state (newest first), so no history frame is copied
// to build the feed. A producer's rings lie consecutively, oldest tap
// first and its live ring last, so an operand (first ring, st, sh, sw)
// reads time index dt from ring first + dt. An internal temporal
// producer also writes its frame to an extra output, which the host
// rolls into the state; such a launch holds one frame.
//
// The pipeline comes as a stage table built once per plan on the host
// (repro_torch/kernels/stencil_pipeline.py::build_program) and passed by
// value as a __grid_constant__ parameter: per stage an op code, its own
// ring, its operands (first ring, st, sh, sw), and offsets into a
// float32 constant table. One compiled kernel serves every pipeline; no
// source is generated per DAG.
//
// Numerics: every product and sum goes through the _rn intrinsics (and the
// library is built with -fmad=false), in the reference's order, and sqrt
// is __fsqrt_rn. The eager PyTorch version does one rounding per
// operation in the same order, so the two agree bit for bit.
//
// Prefetch depth d >= 2 (the kPrefetch instantiations). The TPU kernel
// stages every feed through a (d, R, W) VMEM ring filled by
// pltpu.make_async_copy, so step t computes on slot t % d while steps
// t+1..t+d-1 load, and drains outputs through staging rings. Here each
// feed stage (an input, or a history tap) owns a staging ring of d slots
// of R x ncols floats in dynamic shared memory, after the line rings. A
// CTA's row groups are its steps t = 0, 1, ...; a prologue issues the
// copies of steps 0..d-1, step t waits for its own slot, the input and tap
// stages read the slot instead of device memory, and after the stage
// pass's last barrier the kernel refills that slot with step t + d. The
// copies are 4-byte cp.async (src-size 0 writes the zero of the frame
// edge), so any width works: a TMA tensor map would need 16-byte row
// strides. One commit group per step (an empty one past the band's last
// step) and cp.async.wait_group d-1 track completion. Each thread copies
// exactly the slot elements it later reads (the same idx loop), so its own
// wait makes them visible; no block barrier is needed for the copies.
// Depths above 8 stay correct but keep at most 8 steps in flight, since
// wait_group takes an immediate. Outputs keep direct global stores: a
// store does not stall the warp that issues it, so the TPU's output
// staging rings have no work to do here. The depth-1 instantiations
// compile to the kernel without any of this.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kHdr = 16;
constexpr int kMaxStages = 24;
constexpr int kStageInts = 24;
constexpr int kMaxRings = 24;
constexpr int kMaxWts = 256;
constexpr int kMaxFeeds = 8;      // input frames, then frame-ring states
constexpr int kMaxOuts = 4;       // the output, then frame outputs
constexpr int kThreads = 256;

// op codes: the order of stencil_pipeline.py::OPS
enum Op {
  OP_INPUT = 0, OP_RELAY, OP_CONV, OP_SQUARE, OP_IDENTITY, OP_MAG, OP_PROD,
  OP_NMS, OP_THRESH, OP_UNSHARP, OP_XCORR, OP_DENOISE_COMB, OP_HARRIS_RESP,
  OP_TAP, OP_STMEAN, OP_FRAME_DIFF, OP_BG_SUBTRACT
};

// header fields
// H_DEPTH is the prefetch depth, H_STAGING the offset (floats) of the
// staging rings in shared memory, H_POISON fills them with NaN at start.
enum Hdr {
  H_NSTAGES = 0, H_R, H_H, H_W, H_STRIP_W, H_HALO_LEFT, H_NCOLS, H_BAND_H,
  H_HALO_UP, H_SMEM_BYTES, H_TEMPORAL, H_DEPTH, H_STAGING, H_POISON
};

// stage fields; S_SRC, S_ST, S_SH and S_SW each hold up to 3 operands.
// S_FEED is an input's feed (or, for a tap, its producer's input feed,
// -1 for an internal producer); S_STATE and S_TAPJ locate a tap's
// frame-ring state and its frames back; S_FOUT is a frame output or -1;
// S_STAGE is a feed stage's staging ring at depth >= 2, else -1.
enum Field {
  S_OP = 0, S_RING, S_FINAL, S_FEED, S_NSRC, S_WOFF, S_FOUT, S_STATE,
  S_TAPJ, S_SRC = 9, S_ST = 12, S_SH = 15, S_SW = 18, S_STAGE = 21
};

struct Program {
  int hdr[kHdr];
  int st[kMaxStages][kStageInts];
  int ring[kMaxRings][2];        // {offset in floats, rows}
  float wts[kMaxWts];
};

struct Feeds {
  const float* p[kMaxFeeds];
};

struct Outs {
  float* p[kMaxOuts];
};

#ifndef STENCIL_HOST_SHIM
// 4-byte asynchronous copy from device to shared memory; ok == false
// reads nothing and writes zero (src-size 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most min(n, 7) of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}
#endif

// kTemporal: the instantiation that also runs history taps, the temporal
// ops and frame outputs. Spatial programs launch the other one, whose code
// is the spatial kernel's alone (the temporal cases compile to nothing).
// kPrefetch: feeds arrive through staging rings (prefetch depth >= 2);
// without it the feed stages read device memory inline.
template <bool kTemporal, bool kPrefetch>
__global__ void __launch_bounds__(kThreads)
stencil_pipeline_kernel(const __grid_constant__ Program P,
                        const __grid_constant__ Feeds F,
                        const __grid_constant__ Outs O) {
  extern __shared__ float smem[];
  const int n_stages = P.hdr[H_NSTAGES];
  const int R = P.hdr[H_R];
  const int h = P.hdr[H_H];
  const int w = P.hdr[H_W];
  const int ncols = P.hdr[H_NCOLS];
  // output columns [x0, x1), stored columns [cbase, cbase + ncols)
  const int x0 = blockIdx.x * P.hdr[H_STRIP_W];
  const int x1 = min(x0 + P.hdr[H_STRIP_W], w);
  const int cbase = x0 - P.hdr[H_HALO_LEFT];
  const int clo = max(cbase, 0);
  // output rows [y0, y1), computed from row rlo on
  const int y0 = blockIdx.y * P.hdr[H_BAND_H];
  const int y1 = min(y0 + P.hdr[H_BAND_H], h);
  const int rlo = max(y0 - P.hdr[H_HALO_UP], 0);
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t frame = blockIdx.z * hw;
  const int items = R * ncols;

  // prefetch: the feed stage's frame in device memory (a tap of frame b
  // reads launch frame b - j, or state slot j - b - 1), slot u % depth of
  // its staging ring, and the copies of step u (none past the band's last
  // step), committed as one group
  const int depth = kPrefetch ? P.hdr[H_DEPTH] : 1;
  const int n_steps = (y1 - rlo + R - 1) / R;
  auto feed_frame = [&](const int* S) -> const float* {
    const int b = blockIdx.z, j = S[S_TAPJ];
    if (S[S_OP] != OP_TAP) return F.p[S[S_FEED]] + frame;
    return b >= j ? F.p[S[S_FEED]] + (b - j) * hw
                  : F.p[S[S_STATE]] + (j - b - 1) * hw;
  };
  auto slot_of = [&](const int* S, int u) -> float* {
    return smem + P.hdr[H_STAGING] + (S[S_STAGE] * depth + u % depth) * items;
  };
  auto issue = [&](int u) {
    if (u < n_steps) {
      const int r0 = rlo + u * R;
      for (int s = 0; s < n_stages; ++s) {
        const int* S = P.st[s];
        if (S[S_STAGE] < 0) continue;
        const float* src = feed_frame(S);
        float* dst = slot_of(S, u);
        for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
          const int i = idx / ncols;
          const int row = r0 + i;
          const int col = cbase + idx - i * ncols;
          const bool ok = row < h && col >= 0 && col < w;
          cp_async4(dst + idx,
                    ok ? src + static_cast<size_t>(row) * w + col : src, ok);
        }
      }
    }
    cp_async_commit();
  };
  if constexpr (kPrefetch) {
    if (P.hdr[H_POISON]) {
      // debug: a read of a slot before its copy lands gives NaN
      for (int i = P.hdr[H_STAGING] + threadIdx.x;
           i < P.hdr[H_SMEM_BYTES] / 4; i += blockDim.x)
        smem[i] = __int_as_float(0x7fc00000);
      __syncthreads();
    }
    for (int u = 0; u < depth; ++u) issue(u);
  }

  int t = 0;
  for (int row0 = rlo; row0 < y1; row0 += R, ++t) {
    // this thread's copies of step t have landed
    if constexpr (kPrefetch) cp_async_wait(depth - 1);
    for (int s = 0; s < n_stages; ++s) {
      const int* S = P.st[s];
      const int op = S[S_OP];
      const float* wt = P.wts + S[S_WOFF];
      for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
        const int i = idx / ncols;
        const int lc = idx - i * ncols;
        const int row = row0 + i;
        const int col = cbase + lc;
        // window element (dt, dy, dx) of operand j: pixel
        // (row - sh + 1 + dy, col - sw + 1 + dx) of ring first + dt
        // (time index st - 1, the current frame, is the producer's ring)
        auto tap3 = [&](int j, int dt, int dy, int dx) -> float {
          const int r = row - S[S_SH + j] + 1 + dy;
          const int c = col - S[S_SW + j] + 1 + dx;
          if (r < rlo || c < clo) return 0.f;
          const int* rg = P.ring[S[S_SRC + j] + dt];
          return smem[rg[0] + (r % rg[1]) * ncols + (c - cbase)];
        };
        auto tap = [&](int j, int dy, int dx) -> float {
          return tap3(j, 0, dy, dx);
        };
        float v = 0.f;
        switch (op) {
          case OP_INPUT:
            if constexpr (kPrefetch)
              v = slot_of(S, t)[idx];
            else if (row < h && col >= 0 && col < w)
              v = __ldg(F.p[S[S_FEED]] + frame + static_cast<size_t>(row) * w
                        + col);
            break;
          case OP_TAP:
            if constexpr (kPrefetch) {
              if (kTemporal) v = slot_of(S, t)[idx];
            } else if (kTemporal && row < h && col >= 0 && col < w) {
              // frame b's tap j is launch frame b - j, or state slot
              // j - b - 1 (newest first) when that frame precedes it
              const int b = blockIdx.z, j = S[S_TAPJ];
              const float* src = b >= j
                  ? F.p[S[S_FEED]] + (b - j) * hw
                  : F.p[S[S_STATE]] + (j - b - 1) * hw;
              v = __ldg(src + static_cast<size_t>(row) * w + col);
            }
            break;
          case OP_STMEAN: {
            if (!kTemporal) break;
            // dt-major, then dy, then dx; one multiply by 1/(st*sh*sw)
            const int st = S[S_ST], sh = S[S_SH], sw = S[S_SW];
            int k = 0;
            for (int dt = 0; dt < st; ++dt)
              for (int dy = 0; dy < sh; ++dy)
                for (int dx = 0; dx < sw; ++dx, ++k) {
                  const float t = tap3(0, dt, dy, dx);
                  v = k ? __fadd_rn(v, t) : t;
                }
            v = __fmul_rn(v, wt[0]);
            break;
          }
          case OP_FRAME_DIFF:
            if (kTemporal)
              v = fabsf(__fsub_rn(tap3(0, 1, 0, 0), tap3(0, 0, 0, 0)));
            break;
          case OP_BG_SUBTRACT: {
            if (!kTemporal) break;
            const float d = fabsf(__fsub_rn(tap(0, 0, 0), tap(1, 0, 0)));
            v = d > wt[0] ? d : 0.f;
            break;
          }
          case OP_RELAY:
          case OP_IDENTITY:
            v = tap(0, 0, 0);
            break;
          case OP_CONV: {
            const int sh = S[S_SH], sw = S[S_SW];
            int k = 0;
            for (int dy = 0; dy < sh; ++dy)
              for (int dx = 0; dx < sw; ++dx, ++k) {
                const float t = __fmul_rn(wt[k], tap(0, dy, dx));
                v = k ? __fadd_rn(v, t) : t;
              }
            break;
          }
          case OP_SQUARE: {
            const float a = tap(0, 0, 0);
            v = __fmul_rn(a, a);
            break;
          }
          case OP_MAG: {
            const float a = tap(0, 0, 0), b = tap(1, 0, 0);
            v = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a),
                                               __fmul_rn(b, b)), wt[0]));
            break;
          }
          case OP_PROD:
            v = __fmul_rn(tap(0, 0, 0), tap(1, 0, 0));
            break;
          case OP_NMS: {
            // centre [-2, -2] when sw >= 2, else [-1, -1]; the max runs
            // over the zero-padded cells too
            const int sh = S[S_SH], sw = S[S_SW];
            const float c = sw >= 2 ? tap(0, sh - 2, sw - 2)
                                    : tap(0, sh - 1, sw - 1);
            float m = tap(0, 0, 0);
            for (int dy = 0; dy < sh; ++dy)
              for (int dx = 0; dx < sw; ++dx) m = fmaxf(m, tap(0, dy, dx));
            v = c >= m ? c : 0.f;
            break;
          }
          case OP_THRESH: {
            const float a = tap(0, 0, 0);
            v = a > wt[0] ? a : 0.f;
            break;
          }
          case OP_UNSHARP: {
            const float o = tap(0, 0, 0), b = tap(1, 0, 0);
            v = __fadd_rn(o, __fmul_rn(wt[0], __fsub_rn(o, b)));
            break;
          }
          case OP_XCORR: {
            const int sh = S[S_SH];
            for (int dy = 0; dy < sh; ++dy) {
              const float t = __fmul_rn(wt[dy], tap(0, dy, 0));
              v = dy ? __fadd_rn(v, t) : t;
            }
            v = __fsub_rn(v, tap(1, 0, 0));
            break;
          }
          case OP_DENOISE_COMB: {
            const float o = tap(0, 0, 0), b = tap(1, 0, 0), l = tap(2, 0, 0);
            const float e = fminf(fmaxf(fabsf(l), 0.f), 1.f);
            v = __fadd_rn(__fmul_rn(e, o), __fmul_rn(__fsub_rn(1.f, e), b));
            break;
          }
          case OP_HARRIS_RESP: {
            const float a = tap(0, 0, 0);
            v = __fsub_rn(a, __fmul_rn(__fmul_rn(wt[0], a), a));
            break;
          }
        }
        if (S[S_RING] >= 0) {
          const int* rg = P.ring[S[S_RING]];
          smem[rg[0] + (row % rg[1]) * ncols + lc] = v;
        }
        const bool fout = kTemporal && S[S_FOUT] >= 0;
        if ((S[S_FINAL] || fout) && row >= y0 && row < y1 && col >= x0
            && col < x1) {
          const size_t px = frame + static_cast<size_t>(row) * w + col;
          if (S[S_FINAL]) O.p[0][px] = v;
          if (fout) O.p[S[S_FOUT]][px] = v;
        }
      }
      // the next stage reads this stage's ring; the next row group
      // overwrites ring rows this stage's consumers have read
      __syncthreads();
    }
    // step t's slots are read: refill them with step t + depth
    if constexpr (kPrefetch) issue(t + depth);
  }
}

using Kernel = void (*)(Program, Feeds, Outs);

Kernel pick_kernel(int temporal, int prefetch) {
  if (prefetch)
    return temporal ? stencil_pipeline_kernel<true, true>
                    : stencil_pipeline_kernel<false, true>;
  return temporal ? stencil_pipeline_kernel<true, false>
                  : stencil_pipeline_kernel<false, false>;
}

}  // namespace

// table: kHdr + kMaxStages * kStageInts + kMaxRings * 2 ints; wts: kMaxWts
// floats; feeds: kMaxFeeds device pointers (inputs, then frame-ring
// states); outs: kMaxOuts (the output, then frame outputs). Launches on
// ``stream`` and returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_pipeline_launch(const int* table, const float* wts,
                                       const void* const* feeds,
                                       void* const* outs,
                                       int grid_x, int grid_y, int grid_z,
                                       void* stream) {
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
  const int smem = P.hdr[H_SMEM_BYTES];
  const Kernel kernel = pick_kernel(P.hdr[H_TEMPORAL], P.hdr[H_DEPTH] > 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, grid_z), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(P, F, O);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stencil_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs of the kernel (the temporal instantiation when ``temporal``, the
// staging one when ``prefetch``) that fit on one SM at ``smem_bytes`` of
// dynamic shared memory each, written to ``*blocks``; returns the
// cudaError_t.
extern "C" int stencil_pipeline_blocks_per_sm(int smem_bytes, int temporal,
                                              int prefetch, int* blocks) {
  const Kernel kernel = pick_kernel(temporal, prefetch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, smem_bytes));
}
