// Causal 2-D convolution, one stencil stage, on Hopper (sm_90a).
//
// Replaces repro/kernels/conv2d_stencil.py::conv2d of the JAX package:
//   out(r, c) = sum_dy sum_dx w[dy, dx] * img[r - kh + 1 + dy, c - kw + 1 + dx]
// bottom-right aligned, zero above and left of the frame, float32.
//
// What bounds it: each input pixel read once and each output pixel written
// once, 2 * h * w * 4 bytes -- 16.6 MB at 1920x1080, about 5 us at the
// 3.35 TB/s of an H100 SXM -- against 2 * kh * kw float32 operations per
// pixel (a 5x5 filter at 1080p: 104 MFLOP, 1.5 us at 67 TFLOP/s), so the
// bound is device-memory bytes.
//
// Work split (filters up to 7x7, conv2d_rows). The TPU kernel keeps the
// whole padded input resident in VMEM and walks TR-row output tiles in
// order on one core. Here a thread owns C adjacent output columns and a
// CTA a strip of kThreads * C columns by a band of rows. The thread walks
// down its band with a register window: the last kh input rows of its
// columns and the kw - 1 columns to their left. Per row it loads one new
// row segment (vectors of C floats where the row is aligned, the left
// halo as the neighbouring vectors, which L1 holds), computes its C
// outputs from registers and stores them as one vector; the next row's
// load is issued before the current row's arithmetic. Halo rows are read
// again once per band, (kh - 1) / band, not once per tile; there is no
// shared memory, no barrier and no integer division in the loop, and the
// weights sit in registers. Larger filters take conv2d_tile: one CTA per
// (TR-row tile, kStripW-column strip) with its input tile, halo included,
// in shared memory. The launch reports which of the two ran.
//
// Numerics: acc starts at 0, then dy-major, then dx, acc = acc + w * x with
// __fmul_rn / __fadd_rn (the library is built with -fmad=false) -- the
// reference's order -- so both kernels equal the eager PyTorch version,
// repro_torch/kernels/conv2d_stencil.py::conv2d_plain, bit for bit.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // conv2d_rows: threads per CTA
constexpr int kMaxTap = 7;        // conv2d_rows: filters up to 7x7
constexpr int kCols = 4;          // output columns per thread
constexpr int kTileThreads = 256; // conv2d_tile
constexpr int kStripW = 128;      // conv2d_tile: output columns per CTA

enum Variant { kTile = 0, kRowsScalar = 1, kRowsVector = 2 };

template <int N> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void unpack(float v, float* d) { d[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* d) {
  d[0] = v.x; d[1] = v.y;
}
__device__ __forceinline__ void unpack(float4 v, float* d) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void pack(const float* s, float* v) { *v = s[0]; }
__device__ __forceinline__ void pack(const float* s, float2* v) {
  v->x = s[0]; v->y = s[1];
}
__device__ __forceinline__ void pack(const float* s, float4* v) {
  v->x = s[0]; v->y = s[1]; v->z = s[2]; v->w = s[3];
}

// x[t] = img[r, c0 - KW + 1 + t] for t < C + KW - 1, zero outside the
// frame. Vector path: w % C == 0 and aligned rows, so the C columns from
// c0 lie in the frame and every vector left of c0 is wholly in or out.
template <int KW, int C>
__device__ __forceinline__ void load_row(const float* __restrict__ img,
                                         int w, int r, int c0, bool vec,
                                         float (&x)[C + KW - 1]) {
  constexpr int kWin = C + KW - 1;
  if (r < 0) {
#pragma unroll
    for (int t = 0; t < kWin; ++t) x[t] = 0.f;
    return;
  }
  const float* row = img + static_cast<size_t>(r) * w;
  if (vec) {
    using V = typename Vec<C>::T;
    constexpr int kLeft = (KW - 1 + C - 1) / C;     // vectors left of c0
    float buf[(kLeft + 1) * C];
#pragma unroll
    for (int m = 0; m <= kLeft; ++m) {
      const int c = c0 - (kLeft - m) * C;
      V v{};
      if (c >= 0) v = __ldg(reinterpret_cast<const V*>(row + c));
      unpack(v, buf + m * C);
    }
#pragma unroll
    for (int t = 0; t < kWin; ++t) x[t] = buf[t + kLeft * C - (KW - 1)];
  } else {
#pragma unroll
    for (int t = 0; t < kWin; ++t) {
      const int c = c0 - KW + 1 + t;
      x[t] = c >= 0 && c < w ? __ldg(row + c) : 0.f;
    }
  }
}

template <int KH, int KW, int C>
__global__ void __launch_bounds__(kThreads)
conv2d_rows(const float* __restrict__ img, const float* __restrict__ wts,
            float* __restrict__ out, int h, int w, int band, int vec) {
  constexpr int kWin = C + KW - 1;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * C;
  if (c0 >= w) return;
  const int r0 = blockIdx.y * band;
  const int r1 = min(r0 + band, h);
  float wr[KH * KW];
#pragma unroll
  for (int i = 0; i < KH * KW; ++i) wr[i] = __ldg(wts + i);
  // win[i] holds input row r - KH + 1 + i while output row r is computed
  float win[KH][kWin];
#pragma unroll
  for (int i = 1; i < KH; ++i)
    load_row<KW, C>(img, w, r0 - KH + i, c0, vec, win[i]);
  float next[kWin];
  load_row<KW, C>(img, w, r0, c0, vec, next);
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int i = 0; i + 1 < KH; ++i)
#pragma unroll
      for (int t = 0; t < kWin; ++t) win[i][t] = win[i + 1][t];
#pragma unroll
    for (int t = 0; t < kWin; ++t) win[KH - 1][t] = next[t];
    if (r + 1 < r1) load_row<KW, C>(img, w, r + 1, c0, vec, next);
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < KH; ++dy)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
          a = __fadd_rn(a, __fmul_rn(wr[dy * KW + dx], win[dy][j + dx]));
      acc[j] = a;
    }
    float* orow = out + static_cast<size_t>(r) * w;
    if (vec) {
      pack(acc, reinterpret_cast<typename Vec<C>::T*>(orow + c0));
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (c0 + j < w) orow[c0 + j] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
conv2d_tile(const float* __restrict__ img, const float* __restrict__ wts,
            float* __restrict__ out, int h, int w, int kh, int kw, int tr) {
  extern __shared__ float smem[];
  float* wsm = smem;                      // kh * kw weights
  float* tile = smem + kh * kw;           // th x tw input tile
  const int th = tr + kh - 1;
  const int tw = kStripW + kw - 1;
  const int r0 = blockIdx.y * tr;         // first output row of the tile
  const int c0 = blockIdx.x * kStripW;    // first output column
  for (int i = threadIdx.x; i < kh * kw; i += blockDim.x) wsm[i] = wts[i];
  // tile element (i, j) is frame pixel (r0 - kh + 1 + i, c0 - kw + 1 + j)
  for (int idx = threadIdx.x; idx < th * tw; idx += blockDim.x) {
    const int i = idx / tw;
    const int r = r0 - kh + 1 + i;
    const int c = c0 - kw + 1 + idx - i * tw;
    tile[idx] = r >= 0 && r < h && c >= 0 && c < w
        ? __ldg(img + static_cast<size_t>(r) * w + c) : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < tr * kStripW; idx += blockDim.x) {
    const int i = idx / kStripW;
    const int j = idx - i * kStripW;
    const int r = r0 + i, c = c0 + j;
    if (r >= h || c >= w) continue;
    float acc = 0.f;
    for (int dy = 0; dy < kh; ++dy)
      for (int dx = 0; dx < kw; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(wsm[dy * kw + dx],
                                       tile[(i + dy) * tw + j + dx]));
    out[static_cast<size_t>(r) * w + c] = acc;
  }
}

using RowKernel = void (*)(const float*, const float*, float*, int, int,
                           int, int);

template <int... I>
RowKernel row_kernel(int i, std::integer_sequence<int, I...>) {
  static const RowKernel table[] = {
      conv2d_rows<I / kMaxTap + 1, I % kMaxTap + 1, kCols>...};
  return table[i];
}

// The row kernel of a kh x kw filter at ``cols`` output columns per thread,
// or nullptr (the tile kernel's filters, or a width not built). kCols is
// built for every filter up to 7x7; 1 and 2 only for the 3x3 and 5x5
// filters, for the launch-geometry sweep.
RowKernel pick_rows(int kh, int kw, int cols) {
  if (kh < 1 || kw < 1 || kh > kMaxTap || kw > kMaxTap) return nullptr;
  if (cols == kCols)
    return row_kernel((kh - 1) * kMaxTap + kw - 1,
                      std::make_integer_sequence<int, kMaxTap * kMaxTap>{});
  if (kh == 3 && kw == 3 && cols == 1) return conv2d_rows<3, 3, 1>;
  if (kh == 3 && kw == 3 && cols == 2) return conv2d_rows<3, 3, 2>;
  if (kh == 5 && kw == 5 && cols == 1) return conv2d_rows<5, 5, 1>;
  if (kh == 5 && kw == 5 && cols == 2) return conv2d_rows<5, 5, 2>;
  return nullptr;
}

// vectors of ``cols`` floats: whole vectors per row, aligned rows
bool use_vector(const float* img, const float* out, int w, int cols) {
  const uintptr_t align = 4u * cols;
  return cols > 1 && w % cols == 0
      && reinterpret_cast<uintptr_t>(img) % align == 0
      && reinterpret_cast<uintptr_t>(out) % align == 0;
}

}  // namespace

// img (h, w), wts (kh, kw) and out (h, w): float32 device pointers. Filters
// up to 7x7 run conv2d_rows over bands of ``band`` rows at ``cols`` output
// columns per thread (4, or 1 and 2 for the 3x3 and 5x5 filters); larger
// filters run conv2d_tile over ``band``-row tiles. Launches on ``stream``,
// writes the Variant that ran to ``*variant`` and returns the cudaError_t
// of the launch.
extern "C" int conv2d_launch(const float* img, const float* wts, float* out,
                             int h, int w, int kh, int kw, int band,
                             int cols, void* stream, int* variant) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kh <= kMaxTap && kw <= kMaxTap) {
    const RowKernel kernel = pick_rows(kh, kw, cols);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = use_vector(img, out, w, cols);
    const int per_row = (w + cols - 1) / cols;
    const dim3 grid((per_row + kThreads - 1) / kThreads,
                    (h + band - 1) / band);
    kernel<<<grid, kThreads, 0, st>>>(img, wts, out, h, w, band, vec);
    *variant = vec ? kRowsVector : kRowsScalar;
    return static_cast<int>(cudaGetLastError());
  }
  // dynamic shared memory per CTA, as conv2d_stencil.py::smem_bytes; above
  // the default 48 KB the attribute is raised once per device and size
  const int smem = (kh * kw + (band + kh - 1) * (kStripW + kw - 1)) * 4;
  if (smem > 48 * 1024) {
    static int raised[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || raised[dev] < smem) {
      err = cudaFuncSetAttribute(
          conv2d_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) raised[dev] = smem;
    }
  }
  const dim3 grid((w + kStripW - 1) / kStripW, (h + band - 1) / band);
  conv2d_tile<<<grid, kTileThreads, smem, st>>>(img, wts, out, h, w, kh, kw,
                                                band);
  *variant = kTile;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
