// bf16 x bf16 -> f32 GEMM with the epilogues of kernels K13 and K14.
//
// out[m, n] = epilogue(sum_k a[m, k] * w[k, n] + bias[n]), a (M, K) and
// w (K, N) row-major bf16 (w in the JAX package's (in, out) layout, read
// as it is), f32 accumulation on the tensor cores (mma.sync m16n8k16 bf16).
//
// Replaces the products of tpudf/ops/linear.py `_make_kernel` (K13,
// `linear_fused`: LN1 + QKV, out-proj + residual) and tpudf/ops/mlp.py
// `_kernel` (K14, `mlp_block_fused`: fc1 + GELU, fc2 + residual). On the
// TPU those kernels kept the whole bf16 weight, the LN output and (K14) the
// (rows, 4W) hidden in VMEM. Here a 128x128 output tile per 256-thread
// block streams 32-deep K slices of A and W through a 3-stage cp.async
// ring in dynamic shared memory (55.5 KB); fragments come from ldmatrix
// (A as it is, W transposed by ldmatrix.trans, so no transposed copy of
// the weight exists). Rows of both tiles are padded by 16 bytes so that
// the eight row addresses of an ldmatrix hit distinct banks. At the float
// tower's shapes (M = views * 256 rows, N, K in {768, 2304, 3072}) the
// QKV, fc1 and fc2 products are bound by tensor-core operations, the
// out-proj (K = N = 768) nearly by bytes; wgmma + TMA are later work.
//
// Kernel 15's bf16 product, scripts/micro_pallas_int8.py `bf16_kernel`
// (bf16(x . w) with f32 sums, no bias), is MODE 0 with a null bias.
//
// Epilogues (per output element, f = acc + bias[n] in f32, the result
// rounded once to bf16, as the Pallas kernels do):
//   MODE 0  out = bf16(f)                          (QKV; bias may be null)
//   MODE 1  out = bf16(gelu_tanh(f))               (fc1 -> hidden)
//   MODE 2  out = bf16(f + residual)               (out-proj, fc2)
#include "common.cuh"

namespace tpudf {

constexpr int kHBM = 128, kHBN = 128, kHBK = 32, kHStages = 3;
constexpr int kALd = kHBK + 8;          // A smem row: 40 bf16 = 80 bytes
constexpr int kBLd = kHBN + 8;          // W smem row: 136 bf16 = 272 bytes
constexpr int kHThreads = 256;          // 8 warps: 2 (M) x 4 (N)
constexpr int kAStage = kHBM * kALd;    // elements per stage
constexpr int kBStage = kHBK * kBLd;
constexpr int kHSmem =
    kHStages * (kAStage + kBStage) * static_cast<int>(sizeof(__nv_bfloat16));

struct Bf16GemmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* w;
  const float* bias;
  const __nv_bfloat16* residual;
  __nv_bfloat16* out;
  int M, N, K;
};

template <int MODE>
__global__ void __launch_bounds__(kHThreads)
    bf16_gemm_kernel(Bf16GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kHStages * kAStage;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;             // 0..1: 64-row slab
  const int wn = warp & 3;              // 0..3: 32-column slab
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kHBM, n0 = blockIdx.x * kHBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

  // one stage: A kHBM rows x kHBK bf16 and W kHBK rows x kHBN bf16, in
  // chunks of 16 bytes spread over the threads
  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* as = As + stage * kAStage;
    __nv_bfloat16* bs = Bs + stage * kBStage;
    constexpr int kAChunks = kHBK / 8, kBChunks = kHBN / 8;
#pragma unroll
    for (int i = 0; i < kHBM * kAChunks / kHThreads; ++i) {
      const int c = tid + i * kHThreads;
      const int r = c / kAChunks, cc = (c % kAChunks) * 8;
      const int ar = min(m0 + r, p.M - 1);   // ragged M: clamp, never stored
      cp_async16(as + r * kALd + cc,
                 p.a + static_cast<size_t>(ar) * p.K + k0 + cc);
    }
#pragma unroll
    for (int i = 0; i < kHBK * kBChunks / kHThreads; ++i) {
      const int c = tid + i * kHThreads;
      const int r = c / kBChunks, cc = (c % kBChunks) * 8;
      cp_async16(bs + r * kBLd + cc,
                 p.w + static_cast<size_t>(k0 + r) * p.N + n0 + cc);
    }
  };

  const int kt_count = p.K / kHBK;
#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < kt_count) load_stage(s, s * kHBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();   // stage kt landed; stage kt-1 is free to refill
    const int nk = kt + kHStages - 1;
    if (nk < kt_count) load_stage(nk % kHStages, nk * kHBK);
    cp_async_commit();
    const __nv_bfloat16* as = As + (kt % kHStages) * kAStage;
    const __nv_bfloat16* bs = Bs + (kt % kHStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kHBK; kk += 16) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
        // k + 8: the four 8x8 matrices are a0..a3 of m16n8k16
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], as + r * kALd + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // W rows are k: lanes 0-15 address k rows 0-15 of columns n..n+7,
        // lanes 16-31 of n+8..n+15; .trans gives b0, b1 of two n8 tiles
        unsigned r[4];
        const int n = wn * 32 + nj * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(r, bs + (kk + (lane & 15)) * kBLd + n);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: thread holds rows (g, g+8) x cols (2t, 2t+1) per tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
      // MODE 0 may run without a bias (kernel 15's bf16 product): f32
      // acc + 0 is acc
      const bool no_bias = MODE == 0 && p.bias == nullptr;
      const float b0 = no_bias ? 0.0f : p.bias[col];
      const float b1 = no_bias ? 0.0f : p.bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (row >= p.M) continue;
        float f0 = __fadd_rn(acc[mi][ni][2 * h], b0);
        float f1 = __fadd_rn(acc[mi][ni][2 * h + 1], b1);
        const size_t o = static_cast<size_t>(row) * p.N + col;
        if (MODE == 1) {
          f0 = gelu_tanh(f0);
          f1 = gelu_tanh(f1);
        } else if (MODE == 2) {
          const __nv_bfloat162 res =
              *reinterpret_cast<const __nv_bfloat162*>(p.residual + o);
          f0 = __fadd_rn(f0, __low2float(res));
          f1 = __fadd_rn(f1, __high2float(res));
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + o) =
            __floats2bfloat162_rn(f0, f1);
      }
    }
  }
}

template <int MODE>
int launch_bf16_gemm(const Bf16GemmArgs& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      bf16_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kHSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / kHBN, (p.M + kHBM - 1) / kHBM);
  bf16_gemm_kernel<MODE><<<grid, kHThreads, kHSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

TPUDF_API int tpudf_bf16_gemm(const void* a, const void* w, const void* bias,
                              const void* residual, void* out, int M, int N,
                              int K, int mode, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N % kHBN != 0 || K % kHBK != 0 || mode < 0 || mode > 2 ||
      (mode != 0 && bias == nullptr) || (mode == 2 && residual == nullptr) ||
      (M + kHBM - 1) / kHBM > 65535)
    return cudaErrorInvalidValue;
  const Bf16GemmArgs p{static_cast<const __nv_bfloat16*>(a),
                       static_cast<const __nv_bfloat16*>(w),
                       static_cast<const float*>(bias),
                       static_cast<const __nv_bfloat16*>(residual),
                       static_cast<__nv_bfloat16*>(out),
                       M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_bf16_gemm<0>(p, s);
  if (mode == 1) return launch_bf16_gemm<1>(p, s);
  return launch_bf16_gemm<2>(p, s);
}
