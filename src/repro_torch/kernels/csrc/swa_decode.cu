// Sliding-window decode attention over a ring KV cache on Hopper (sm_90a).
//
// Replaces repro/kernels/swa_decode.py::swa_decode of the JAX package: for
// each (batch b, kv head h) and each query row of h's GQA group,
//   scores = q . k^T * (1 / sqrt(D)) over the S ring slots,
//   slots whose (slot - ring_start) mod S >= length[b] are masked,
//   p = exp(scores - max) / max(sum, 1e-30), with max taken as 0 when
//   every slot is masked (the output is then zero, not NaN),
//   out = p . v, all in float32.
//
// What bounds it: the valid ring slots' K and V rows, read once --
// 2 * B * S * Hkv * D * 4 bytes when the window is full, 67 MB at
// gemma3-1b's local layers (Hq=4, Hkv=1, D=256, S=512) and a decode batch
// of 64, about 20 us at the 3.35 TB/s of an H100 SXM -- against 4 * G * D
// float32 operations per slot and kv head (about 2 per byte at G = 4, the
// card has ~20), so bytes.
//
// Work split (flash-decoding). The valid slots form one ring range,
// start .. start + min(length, S) - 1 mod S; position i of it is slot
// (start + i) mod S, oldest first. The grid is (splits, Hkv * passes, B):
// CTA (sp, h, b) takes positions [sp * chunk, (sp + 1) * chunk) of row b's
// range -- at most two contiguous slot segments across the wrap -- for up
// to GP query rows of kv head h's group at once (G rows in ceil(G / GP)
// passes), so each K and V row is read once per pass. Its kWarps warps
// take rounds of U consecutive positions in turn (U = 16 / floats per
// lane: 4 KB of K and V rows at the widest D of the lane share). A lane
// holds its share of a row (float4s at 4 * lane + 128 * j, or floats at
// lane + 32 * j when D % 4 != 0) and of the GP query rows in registers.
// Each warp streams its rounds through a ring of kStages slots in shared
// memory with cp.async, kStages - 1 rounds ahead of the one it computes,
// so 8 KB of K and V rows per warp stay in flight whatever the arithmetic
// costs; a lane copies exactly the elements of its share, so its own
// wait_group makes them visible to it and no barrier is needed. Each warp
// keeps an online softmax in registers (running max m, sum l and
// accumulator acc per query row). At the end the CTA's warps merge
// through the same shared memory -- at most 48 KB, set by D and G, not by
// S -- and the CTA writes (m, l, acc) of its split to a workspace; with
// one split it writes the normalised output itself. A second kernel,
// swa_combine, then computes out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s (0 when every split
// is empty). A second kernel and not a last-CTA epilogue: it needs no
// counters that persist between calls (and no reset that calls on two
// streams could race on), and costs one small launch.
//
// Numerics: the dot products, the online rescaling and the p . v sums run
// in another order than the eager PyTorch version (repro_torch/kernels/
// swa_decode.py::swa_decode_plain), with fmaf and expf; the two agree to
// float32 rounding, held at rtol 2e-4, atol 2e-5 -- the tolerance at which
// the JAX package holds its kernel against its oracle.

#include <math.h>
#include <algorithm>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 8;       // GP: query rows per pass, at most
constexpr int kMaxShare = 64;     // GP * (floats per lane), at most
constexpr int kCombineThreads = 128;
constexpr int kMaxSplits = 1024;
constexpr int kStages = 3;        // rounds in flight or staged per warp
constexpr int kRoundFloats = 16;  // positions per round x floats per lane

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element t of a lane's share of a D-row
template <bool kVec>
__device__ __forceinline__ int elem(int lane, int t) {
  return kVec ? 4 * lane + 128 * (t >> 2) + (t & 3) : lane + 32 * t;
}

// x = the lane's share of row[0 .. d), zero past d (row in global memory
// through the read-only path, or in shared memory)
template <int P, bool kVec, bool kGlobal>
__device__ __forceinline__ void load_share(const float* __restrict__ row,
                                           int lane, int d, float (&x)[P]) {
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      const int e = 4 * lane + 128 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < d) {
        const float4* src = reinterpret_cast<const float4*>(row + e);
        if constexpr (kGlobal) v = __ldg(src); else v = *src;
      }
      x[4 * j] = v.x; x[4 * j + 1] = v.y; x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = lane + 32 * j;
      x[j] = 0.f;
      if (e < d) {
        if constexpr (kGlobal) x[j] = __ldg(row + e); else x[j] = row[e];
      }
    }
  }
}

// asynchronous copy of kBytes (16 or 4) from device to shared memory;
// ok == false reads nothing and writes zeros (src-size 0)
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(sd), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(sd), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// GP query rows per pass; P floats of a D-row per lane (float4s if kVec)
template <int GP, int P, bool kVec>
__global__ void __launch_bounds__(kThreads)
swa_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int* __restrict__ length,
                 const int* __restrict__ ring_start,
                 float* __restrict__ out, float* __restrict__ ws, int hkv,
                 int g, int s_len, int d, int chunk, float scale) {
  constexpr int U = kRoundFloats / P;      // positions per round
  constexpr int kPiece = kVec ? 4 : 1;     // floats per copy
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int passes = (g + GP - 1) / GP;
  const int hh = blockIdx.y / passes;
  const int g0 = (blockIdx.y - hh * passes) * GP;
  const int gn = min(GP, g - g0);          // rows of this pass
  const int b = blockIdx.z, sp = blockIdx.x, splits = gridDim.x;
  const int n = min(max(length[b], 0), s_len);
  const int start = ((ring_start[b] % s_len) + s_len) % s_len;
  const int lo = sp * chunk, hi = min(lo + chunk, n);
  // q (B, Hq, D), Hq = hkv * g: pass rows are hq = hh * g + g0 + j
  const size_t row0 = static_cast<size_t>(b) * hkv * g + hh * g + g0;
  float qr[GP][P];
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    if (j < gn) {
      load_share<P, kVec, true>(q + (row0 + j) * d, lane, d, qr[j]);
    } else {
#pragma unroll
      for (int t = 0; t < P; ++t) qr[j][t] = 0.f;
    }
  }
  // k, v (B, S, Hkv, D): slot s of head hh at (b * S + s) * Hkv + hh
  const size_t stride = static_cast<size_t>(hkv) * d;
  const float* kb = k + static_cast<size_t>(b) * s_len * stride
      + static_cast<size_t>(hh) * d;
  const float* vb = v + static_cast<size_t>(b) * s_len * stride
      + static_cast<size_t>(hh) * d;
  float m[GP], l[GP], acc[GP][P];
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int t = 0; t < P; ++t) acc[j][t] = 0.f;
  }
  // Round r of this warp: positions first + r * step .. + U - 1, staged
  // in ring slot r % kStages (U K rows, then U V rows). Each lane copies
  // exactly the elements of its share, so its own wait makes them
  // visible to it, and refills a slot only after it has read it.
  float* ring = smem + warp * kStages * 2 * U * d;
  const int first = lo + warp * U, step = kWarps * U;
  const int rounds = first < hi ? (hi - first + step - 1) / step : 0;
  auto issue = [&](int r) {
    if (r < rounds) {
      const int p0 = first + r * step;
      float* st = ring + (r % kStages) * 2 * U * d;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = p0 + u < hi;
        int s = start + p0 + u;
        if (s >= s_len) s -= s_len;
        const float* krow = ok ? kb + s * stride : kb;
        const float* vrow = ok ? vb + s * stride : vb;
#pragma unroll
        for (int j = 0; j < P / kPiece; ++j) {
          const int e = kVec ? 4 * lane + 128 * j : lane + 32 * j;
          if (e < d) {
            cp_async<4 * kPiece>(st + u * d + e, krow + e, ok);
            cp_async<4 * kPiece>(st + (U + u) * d + e, vrow + e, ok);
          }
        }
      }
    }
    cp_async_commit();                     // one group per round, if empty
  };
#pragma unroll
  for (int r = 0; r + 1 < kStages; ++r) issue(r);
  for (int r = 0; r < rounds; ++r) {
    issue(r + kStages - 1);
    cp_async_wait<kStages - 1>();          // round r's group is complete
    const float* st = ring + (r % kStages) * 2 * U * d;
    const int p0 = first + r * step;
    float sc[GP][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[P];
      load_share<P, kVec, false>(st + u * d, lane, d, kx);
#pragma unroll
      for (int j = 0; j < GP; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < P; ++t) dot = fmaf(qr[j][t], kx[t], dot);
        dot = warp_sum(dot);
        sc[j][u] = p0 + u < hi ? dot * scale : -INFINITY;
      }
    }
    // position p0 < hi, so sc[j][0] and the new max are finite
#pragma unroll
    for (int j = 0; j < GP; ++j) {
      float mn = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, sc[j][u]);
      const float alpha = expf(m[j] - mn);     // 0 while m is -inf
      l[j] *= alpha;
#pragma unroll
      for (int t = 0; t < P; ++t) acc[j][t] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[j][u] = expf(sc[j][u] - mn);        // 0 past the range
        l[j] += sc[j][u];
      }
      m[j] = mn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[P];
      load_share<P, kVec, false>(st + (U + u) * d, lane, d, vx);
#pragma unroll
      for (int j = 0; j < GP; ++j)
#pragma unroll
        for (int t = 0; t < P; ++t) acc[j][t] = fmaf(sc[j][u], vx[t], acc[j][t]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the rings are free again
  // merge the warps: row j's accumulator of warp w at smem[(w*GP + j)*d],
  // its (m, l) at part[(w * GP + j) * 2]
  float* part = smem + kWarps * GP * d;
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    if (lane == 0) {
      part[(warp * GP + j) * 2] = m[j];
      part[(warp * GP + j) * 2 + 1] = l[j];
    }
    float* a = smem + (warp * GP + j) * d;
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int e = elem<kVec>(lane, t);
      if (e < d) a[e] = acc[j][t];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * d; idx += kThreads) {
    const int j = idx / d, e = idx - j * d;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[(w * GP + j) * 2]);
    const float m0 = mx == -INFINITY ? 0.f : mx;    // every warp empty
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(part[(w * GP + j) * 2] - m0);
      lsum = fmaf(part[(w * GP + j) * 2 + 1], c, lsum);
      a = fmaf(smem[(w * GP + j) * d + e], c, a);
    }
    const size_t row = row0 + j;
    if (ws == nullptr) {
      out[row * d + e] = a / fmaxf(lsum, 1e-30f);
    } else {
      // ws: (B * Hq) x splits (m, l) pairs, then (B * Hq) x splits x d
      const size_t rows = static_cast<size_t>(gridDim.z) * hkv * g;
      if (e == 0) {
        ws[(row * splits + sp) * 2] = mx;
        ws[(row * splits + sp) * 2 + 1] = lsum;
      }
      ws[rows * splits * 2 + (row * splits + sp) * d + e] = a;
    }
  }
}

// one CTA per output row (b, hq): out = the splits' partials, combined
__global__ void __launch_bounds__(kCombineThreads)
swa_combine_kernel(const float* __restrict__ ws, float* __restrict__ out,
                   int rows, int splits, int d) {
  __shared__ float c[kMaxSplits];
  __shared__ float inv_l;
  const size_t row = blockIdx.x;
  const float* ml = ws + row * splits * 2;
  const float* a = ws + static_cast<size_t>(rows) * splits * 2
      + row * splits * d;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  const float m0 = mx == -INFINITY ? 0.f : mx;      // every split empty
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    c[s] = expf(ml[2 * s] - m0);
  __syncthreads();
  if (threadIdx.x == 0) {
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) lsum = fmaf(ml[2 * s + 1], c[s], lsum);
    inv_l = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc = fmaf(a[s * d + e], c[s], acc);
    out[row * d + e] = acc * inv_l;
  }
}

using SplitKernel = void (*)(const float*, const float*, const float*,
                             const int*, const int*, float*, float*, int,
                             int, int, int, int, float);

template <int P, bool kVec, int... I>
SplitKernel split_kernel(int gp, std::integer_sequence<int, I...>) {
  static const SplitKernel table[] = {swa_split_kernel<I + 1, P, kVec>...};
  return table[gp - 1];
}

// floats of a D-row per lane: float4s for D % 4 == 0 (up to 512), else
// floats (up to 256)
int share(int d) {
  if (d % 4 == 0) return d <= 128 ? 4 : d <= 256 ? 8 : d <= 512 ? 16 : 0;
  return d <= 256 ? 8 : 0;
}

// query rows per pass: G, at most kMaxRows and kMaxShare / share; 0 when
// the kernel cannot take d (as swa_decode.py::rows_per_pass)
int rows_per_pass(int g, int d) {
  const int p = share(d);
  return p == 0 ? 0 : std::min(std::min(g, kMaxRows), kMaxShare / p);
}

// dynamic shared memory of a split CTA: the warps' rings of kStages rounds
// of U = kRoundFloats / share K and V rows, which the warps' merge (an
// accumulator and (m, l) per warp and row) reuses; as swa_decode.py::
// smem_bytes
int smem_bytes(int gp, int d) {
  const int u = kRoundFloats / share(d);
  return std::max(kWarps * kStages * 2 * u * d, kWarps * gp * (d + 2)) * 4;
}

SplitKernel pick_split(int gp, int d) {
  const auto rows8 = std::make_integer_sequence<int, kMaxRows>{};
  if (gp < 1 || gp > kMaxRows) return nullptr;
  if (d % 4 != 0) return share(d) ? split_kernel<8, false>(gp, rows8)
                                  : nullptr;
  switch (share(d)) {
    case 4: return split_kernel<4, true>(gp, rows8);
    case 8: return split_kernel<8, true>(gp, rows8);
    case 16:
      return gp <= 4 ? split_kernel<16, true>(
                           gp, std::make_integer_sequence<int, 4>{})
                     : nullptr;
    default: return nullptr;
  }
}

}  // namespace

// q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D): float32; length
// and ring_start (B,): int32; all device pointers, Hq = hkv * g, rows 16-
// byte aligned when D % 4 == 0. ws: workspace of B * Hq * splits * (D + 2)
// floats when splits > 1 (unused with one split). Launches swa_split_kernel
// over (splits, hkv * passes, b) CTAs, each taking ``chunk`` ring positions,
// and, for splits > 1, swa_combine_kernel over the B * Hq rows, on
// ``stream``; returns the cudaError_t of the launches.
extern "C" int swa_decode_launch(const float* q, const float* k,
                                 const float* v, const int* length,
                                 const int* ring_start, float* out,
                                 float* ws, int b, int hkv, int g,
                                 int s_len, int d, int splits, int chunk,
                                 float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gp = rows_per_pass(g, d);
  const SplitKernel kernel = pick_split(gp, d);
  if (kernel == nullptr || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = (g + gp - 1) / gp;
  const int smem = smem_bytes(gp, d);       // at most 48 KB: no attribute
  kernel<<<dim3(splits, hkv * passes, b), kThreads, smem, st>>>(
      q, k, v, length, ring_start, out, splits > 1 ? ws : nullptr, hkv, g,
      s_len, d, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  swa_combine_kernel<<<b * hkv * g, kCombineThreads, 0, st>>>(
      ws, out, b * hkv * g, splits, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* swa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
