// K4: row layer norm, bf16 in and out, f32 E[x^2]-E[x]^2 statistics.
//
// Replaces tpudf/ops/layernorm.py `_ln_kernel` (wrappers `_ln_pallas`,
// `layer_norm_fused`). Also here: the LN + static int8 quant row pass that
// opens kernels K1 and K2 (the quantize of int8_block.py
// `_attn_sublayer_kernel` and mlp.py `_kernel_int8`).
//
// Bound by device-memory bytes: 2 bytes read and 2 (or 1) written per
// element against ~10 flops. One warp per row, the row held in registers
// between the statistics and the normalisation, so each row is read once;
// 16-byte loads and stores.
#include "common.cuh"

namespace tpudf {

constexpr int kLnWarps = 8;

__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ g,
                           const float* __restrict__ b,
                           __nv_bfloat16* __restrict__ out, int rows,
                           int width, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  RowLN r;
  load_row_ln(x + static_cast<size_t>(row) * width, width, eps, lane, r);
  const int nchunks = width / 8;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int chunk = lane + c * 32;
    if (chunk < nchunks) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = chunk * 8 + j;
        o[j] = __float2bfloat16_rn(ln_apply(r.v[c * 8 + j], r, g[col], b[col]));
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * width +
                                chunk * 8) = *reinterpret_cast<uint4*>(o);
    }
  }
}

__global__ void __launch_bounds__(kLnWarps * 32)
    ln_quant_i8_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ b,
                       const float* __restrict__ act_scale,
                       int8_t* __restrict__ out, int rows, int width,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float inv = 127.0f / act_scale[0];
  RowLN r;
  load_row_ln(x + static_cast<size_t>(row) * width, width, eps, lane, r);
  const int nchunks = width / 8;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int chunk = lane + c * 32;
    if (chunk < nchunks) {
      __align__(8) int8_t q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = chunk * 8 + j;
        q[j] = quant_i8(ln_apply(r.v[c * 8 + j], r, g[col], b[col]), inv);
      }
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * width +
                                chunk * 8) = *reinterpret_cast<uint2*>(q);
    }
  }
}

}  // namespace tpudf

TPUDF_API int tpudf_layer_norm_bf16(const void* x, const void* g,
                                    const void* b, void* out, int rows,
                                    int width, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (width % 8 != 0 || width > tpudf::kLnMaxWidth)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + tpudf::kLnWarps - 1) / tpudf::kLnWarps);
  tpudf::layer_norm_bf16_kernel<<<grid, tpudf::kLnWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), rows,
      width, eps);
  return static_cast<int>(cudaGetLastError());
}

TPUDF_API int tpudf_ln_quant_i8(const void* x, const void* g, const void* b,
                                const void* act_scale, void* out, int rows,
                                int width, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (width % 8 != 0 || width > tpudf::kLnMaxWidth)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + tpudf::kLnWarps - 1) / tpudf::kLnWarps);
  tpudf::ln_quant_i8_kernel<<<grid, tpudf::kLnWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(out), rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}
