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
// Work split. The TPU kernel keeps the whole padded input resident in VMEM
// and walks TR-row output tiles in order on one core. Here one CTA owns one
// (TR-row tile, STRIP-column strip): it loads its (TR + kh - 1) x
// (STRIP + kw - 1) input tile, halo included, into shared memory with
// zeros outside the frame, and its threads compute the tile's output
// pixels from it. Halo rows and columns are read by two CTAs (at TR = 8
// and a 3x3 filter, 25% more rows); this simple kernel does not share them.
//
// Numerics: acc starts at 0, then dy-major, then dx, acc = acc + w * x with
// __fmul_rn / __fadd_rn (the library is built with -fmad=false) -- the
// reference's order -- so the kernel equals its eager PyTorch version,
// repro_torch/kernels/conv2d_stencil.py::conv2d_plain, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStripW = 128;      // output columns per CTA

__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const float* __restrict__ img, const float* __restrict__ wts,
              float* __restrict__ out, int h, int w, int kh, int kw,
              int tr) {
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

}  // namespace

// img (h, w), wts (kh, kw) and out (h, w): float32 device pointers.
// Launches on ``stream`` and returns the cudaError_t of the launch.
extern "C" int conv2d_launch(const float* img, const float* wts, float* out,
                             int h, int w, int kh, int kw, int tr,
                             void* stream) {
  // dynamic shared memory per CTA, as conv2d_stencil.py::smem_bytes
  const int smem = (kh * kw + (tr + kh - 1) * (kStripW + kw - 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kStripW - 1) / kStripW, (h + tr - 1) / tr);
  conv2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      img, wts, out, h, w, kh, kw, tr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
