// int8 x int8 -> int32 GEMM with the W8A8 epilogues of kernels K1 and K2,
// and kernel K5 (the same GEMM with an LN + static-quant prologue).
//
// out[m, n] = epilogue(sum_k a[m, k] * bt[n, k]), a (M, K) and bt (N, K)
// row-major int8 (bt is the weight transposed once at load time), exact
// int32 accumulation on the tensor cores (mma.sync m16n8k32 s8); the tile,
// its cp.async ring and the epilogues are in gemm_i8.cuh.
//
// The plain GEMM replaces the int8 projections inside
// tpudf/ops/int8_block.py `_attn_sublayer_kernel` (QKV, out-proj) and
// tpudf/ops/mlp.py `_kernel_int8` / `_kernel_int8_ss` (fc1, fc2); its int32
// mode serves the XLA products of tpudf/ops/quant.py (`int8_matmul`,
// `int8_matmul_static`, `int8_matmul_pre`), whose dequantisation the
// caller does. On the TPU those kernels kept the whole int8 weight and the
// activation in VMEM; here a 128x128 output tile per 256-thread block
// streams 64-deep K slices of A and B through a double-buffered cp.async
// ring in shared memory (40 KB). Bound by tensor-core operations at the
// main path's shapes (M = B*S rows, N, K in {768, 2304, 3072}); wgmma + TMA
// are later work.
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

template <int MODE>
__global__ void __launch_bounds__(kGemmThreads) i8_gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) int8_t smem[4 * kStageBytes];
  gemm_tile<MODE>(p, blockIdx.y * kBM, blockIdx.x * kBN, smem);
}

__global__ void __launch_bounds__(kGemmThreads)
    ln_qkv_i8_kernel(GemmArgs p, const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ g,
                     const float* __restrict__ b, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  ln_gemm_tile<__nv_bfloat16, kEpiBf16>(p, x, g, b, eps, blockIdx.y * kBM,
                                        blockIdx.x * kBN, smem);
}

}  // namespace tpudf

TPUDF_API int tpudf_i8_gemm(const void* a, const void* bt,
                            const void* col_scale, const void* bias,
                            const void* act, const void* residual, void* out,
                            void* sumsq, const void* act_out, int M, int N,
                            int K, int mode, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N % kBN != 0 || K % kBK != 0 || mode < 0 || mode > kEpiI32 ||
      (mode == kEpiGeluI8 && act_out == nullptr) ||
      (mode == kEpiResidual && residual == nullptr) ||
      (mode != kEpiI32 && (act == nullptr || col_scale == nullptr ||
                           bias == nullptr)))
    return cudaErrorInvalidValue;
  GemmArgs p{static_cast<const int8_t*>(a),
             static_cast<const int8_t*>(bt),
             static_cast<const float*>(col_scale),
             static_cast<const float*>(bias),
             static_cast<const float*>(act),
             residual,
             out,
             static_cast<float*>(sumsq),
             static_cast<const float*>(act_out),
             M, N, K};
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kEpiBf16)
    i8_gemm_kernel<kEpiBf16><<<grid, kGemmThreads, 0, s>>>(p);
  else if (mode == kEpiGeluI8)
    i8_gemm_kernel<kEpiGeluI8><<<grid, kGemmThreads, 0, s>>>(p);
  else if (mode == kEpiResidual)
    i8_gemm_kernel<kEpiResidual><<<grid, kGemmThreads, 0, s>>>(p);
  else
    i8_gemm_kernel<kEpiI32><<<grid, kGemmThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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
