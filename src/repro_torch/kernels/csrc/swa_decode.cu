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
// float32 operations per slot and kv head, so bytes.
//
// Work split. As on the TPU, one CTA owns one (batch, kv head) and takes
// its group's G query rows at once, so each K and V row is read once for
// all G of them. The valid slots form one ring range, start .. start +
// min(length, S) - 1 mod S, so the CTA walks only those, oldest first:
//   1. one warp per slot: each lane takes D / 32 elements of the K row and
//      of the G query rows (in shared memory), partial dot products are
//      summed across the warp with shuffles, and the scaled score is kept
//      in shared memory (G x S floats);
//   2. per query row, the block takes the max, then exp and the sum, then
//      divides: the exact softmax of the reference, not an online one;
//   3. threads over D: out[g, e] = sum over slots of p[g, i] * v[i, e],
//      reading each V row coalesced, G accumulators per thread.
// A CTA per (batch, kv head) leaves most of the card idle at small batch
// (64 CTAs on 132 SMs at B=64, Hkv=1); splitting the ring across CTAs is
// later work.
//
// Numerics: the dot products and the p . v sums run in another order than
// the eager PyTorch version (repro_torch/kernels/swa_decode.py::
// swa_decode_plain), and exp is expf; the two agree to float32 rounding,
// held at rtol 2e-4, atol 2e-5 -- the tolerance at which the JAX package
// holds its kernel against its oracle.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 8;             // query rows per register pass

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the block-wide sum (or max) of x, on every thread
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();                  // red is free again
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < kWarps; ++i) x = kMax ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const int* __restrict__ length,
                  const int* __restrict__ ring_start,
                  float* __restrict__ out, int hkv, int g, int s_len, int d,
                  float scale) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  float* qs = smem;                 // g x d query rows
  float* p = smem + g * d;          // g x s_len scores, then weights
  const int hh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = min(max(length[b], 0), s_len);        // valid slots
  const int start = ((ring_start[b] % s_len) + s_len) % s_len;
  // q is (B, Hq, D) with Hq = hkv * g: head hh's group is contiguous
  const float* qb = q + (static_cast<size_t>(b) * hkv + hh) * g * d;
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) qs[i] = qb[i];
  // k, v are (B, S, Hkv, D): slot s of head hh at (b * S + s) * Hkv + hh
  const size_t slot_stride = static_cast<size_t>(hkv) * d;
  const float* kb = k + static_cast<size_t>(b) * s_len * slot_stride
      + static_cast<size_t>(hh) * d;
  const float* vb = v + static_cast<size_t>(b) * s_len * slot_stride
      + static_cast<size_t>(hh) * d;
  __syncthreads();

  // 1. scores of the valid slots, oldest first: p[gi * s_len + i]
  for (int i = warp; i < n; i += kWarps) {
    const int s = start + i < s_len ? start + i : start + i - s_len;
    const float* krow = kb + s * slot_stride;
    for (int g0 = 0; g0 < g; g0 += kG) {
      float acc[kG];
      for (int j = 0; j < kG; ++j) acc[j] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = __ldg(krow + e);
        for (int j = 0; j < kG; ++j)
          if (g0 + j < g) acc[j] += qs[(g0 + j) * d + e] * kv;
      }
      for (int j = 0; j < kG; ++j) {
        const float dot = warp_sum(acc[j]);
        if (lane == 0 && g0 + j < g) p[(g0 + j) * s_len + i] = dot * scale;
      }
    }
  }
  __syncthreads();

  // 2. exact softmax per query row; no valid slot leaves the row empty
  for (int gi = 0; gi < g; ++gi) {
    float* row = p + gi * s_len;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, row[i]);
    m = block_reduce<true>(m, red);
    if (!isfinite(m)) m = 0.f;
    float z = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float e = expf(row[i] - m);
      row[i] = e;
      z += e;
    }
    z = fmaxf(block_reduce<false>(z, red), 1e-30f);
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = row[i] / z;
  }
  __syncthreads();

  // 3. out = p . v over the valid slots (zero when there is none)
  float* ob = out + (static_cast<size_t>(b) * hkv + hh) * g * d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    for (int g0 = 0; g0 < g; g0 += kG) {
      float acc[kG];
      for (int j = 0; j < kG; ++j) acc[j] = 0.f;
      for (int i = 0; i < n; ++i) {
        const int s = start + i < s_len ? start + i : start + i - s_len;
        const float vv = __ldg(vb + s * slot_stride + e);
        for (int j = 0; j < kG; ++j)
          if (g0 + j < g) acc[j] += p[(g0 + j) * s_len + i] * vv;
      }
      for (int j = 0; j < kG; ++j)
        if (g0 + j < g) ob[(g0 + j) * d + e] = acc[j];
    }
  }
}

}  // namespace

// q (B, Hq, D), k and v (B, S, Hkv, D), out (B, Hq, D): float32; length
// and ring_start (B,): int32; all device pointers, Hq = hkv * g. Launches
// one CTA per (kv head, batch) on ``stream`` with (g * d + g * s_len) * 4
// bytes of dynamic shared memory; returns the cudaError_t of the launch.
extern "C" int swa_decode_launch(const float* q, const float* k,
                                 const float* v, const int* length,
                                 const int* ring_start, float* out, int b,
                                 int hkv, int g, int s_len, int d,
                                 float scale, void* stream) {
  const int smem = (g * d + g * s_len) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      swa_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_decode_kernel<<<dim3(hkv, b), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, k, v, length, ring_start, out, hkv, g, s_len, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* swa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
