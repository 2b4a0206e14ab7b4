// Kernel K5: the int8 x int8 -> int32 GEMM with an LN + static-quant
// prologue, on the mma.sync tile of gemm_i8.cuh (the plain int8 GEMM
// behind `tpudf_i8_gemm` is int8_gemm_sm90.cu, on wgmma and TMA).
//
// K5 replaces tpudf/ops/int8_block.py `_ln_qkv_kernel` (wrapper
// `ln_qkv_int8`): bf16 x -> LN with f32 statistics -> static int8 quant ->
// int8 QKV product -> dequant + bias -> bf16, in ONE launch. Each block
// first normalises and quantises its 128 rows of x into an int8 panel in
// shared memory (K + 16 bytes a row: 170 KB with the weight stages at
// so400m's K = 1152, at most 186 KB for K = kLnMaxWidth), with the
// first weight stage already in flight, then streams the weight through
// two cp.async stages: the int8 LN output never reaches device memory, as
// it never left VMEM on the TPU. Each of the N / 128 column blocks of a
// row tile recomputes the LN of its rows (x is re-read from L2); at the
// detect core's shapes the bound is the tensor-core operations.
#include "gemm_i8.cuh"

namespace tpudf {

__global__ void __launch_bounds__(kGemmThreads)
    ln_qkv_i8_kernel(GemmArgs p, const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ g,
                     const float* __restrict__ b, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  ln_gemm_tile<__nv_bfloat16, kEpiBf16>(p, x, g, b, eps, blockIdx.y * kBM,
                                        blockIdx.x * kBN, smem);
}

}  // namespace tpudf

// K5: out (M, N) bf16 = bf16(quant(LN(x)) . wt^T dequantised + bias)
TPUDF_API int tpudf_ln_qkv_i8(const void* x, const void* g, const void* b,
                              const void* wt, const void* col_scale,
                              const void* bias, const void* act, void* out,
                              int M, int N, int K, float eps, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N % kBN != 0 || K % kBK != 0 || K > kLnMaxWidth)
    return cudaErrorInvalidValue;
  const size_t smem = ln_gemm_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmArgs p{nullptr,
             static_cast<const int8_t*>(wt),
             static_cast<const float*>(col_scale),
             static_cast<const float*>(bias),
             static_cast<const float*>(act),
             nullptr,
             out,
             nullptr,
             nullptr,
             M, N, K};
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  ln_qkv_i8_kernel<<<grid, kGemmThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), eps);
  return static_cast<int>(cudaGetLastError());
}
