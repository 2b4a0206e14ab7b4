// K3: SRM residual raw moments. For each image, both distinct SRM
// residuals (the normalised K2 stencil and the K3 Laplacian, 3x3, 'same'
// size, zero border) and E[r], E[r^2], E[r^3], E[r^4] of each -> (B, 8).
//
// Replaces tpudf/ops/srm.py `_srm_moments_kernel` (wrapper
// `srm_raw_moments`). The TPU kernel used the separable form of the two
// stencils over VMEM-resident images; here each thread forms both
// residuals at its pixels directly from the 3x3 neighbourhood (9 taps in
// row-major order with the twin's f32 coefficients, rounded op by op, so
// the residual is the twin's to the bit), and accumulates the powers in
// f64. One block per image: the block reduces its own sums, so there are
// no cross-block sums (no atomics, no second pass) and the result is
// deterministic. Bound by device-memory bytes: one f32 read per pixel (the
// neighbour reads hit L1/L2).
#include "common.cuh"

namespace tpudf {

constexpr int kSrmThreads = 512;

__global__ void __launch_bounds__(kSrmThreads)
    srm_moments_kernel(const float* __restrict__ gray,
                       const float* __restrict__ coeffs,   // 2 x 3 x 3
                       float* __restrict__ out, int h, int w) {
  __shared__ double red[kSrmThreads];
  __shared__ float c[18];
  if (threadIdx.x < 18) c[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();

  const float* img = gray + static_cast<size_t>(blockIdx.x) * h * w;
  double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int idx = threadIdx.x; idx < h * w; idx += kSrmThreads) {
    const int i = idx / w, j = idx % w;
    float nb[9];
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int y = i + di - 1, x = j + dj - 1;
        nb[di * 3 + dj] =
            (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float k = c[r * 9 + tap];
        if (k != 0.0f) v = __fadd_rn(v, __fmul_rn(nb[tap], k));
      }
      const float v2 = __fmul_rn(v, v);
      acc[r * 4 + 0] += v;
      acc[r * 4 + 1] += v2;
      acc[r * 4 + 2] += __fmul_rn(v2, v);
      acc[r * 4 + 3] += __fmul_rn(v2, v2);
    }
  }
  const double inv_n = 1.0 / (static_cast<double>(h) * w);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    red[threadIdx.x] = acc[m];
    __syncthreads();
    for (unsigned s = kSrmThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0)
      out[blockIdx.x * 8 + m] = static_cast<float>(red[0] * inv_n);
    __syncthreads();
  }
}

}  // namespace tpudf

TPUDF_API int tpudf_srm_moments(const void* gray, const void* coeffs,
                                void* out, int batch, int h, int w,
                                void* stream) {
  using namespace tpudf;
  if (batch <= 0) return 0;
  srm_moments_kernel<<<batch, kSrmThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(coeffs),
      static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
