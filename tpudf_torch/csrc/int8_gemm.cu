// int8 x int8 -> int32 GEMM with the W8A8 epilogues of kernels K1 and K2.
//
// out[m, n] = epilogue(sum_k a[m, k] * bt[n, k]), a (M, K) and bt (N, K)
// row-major int8 (bt is the weight transposed once at load time), exact
// int32 accumulation on the tensor cores (mma.sync m16n8k32 s8).
//
// Replaces the int8 projections inside tpudf/ops/int8_block.py
// `_attn_sublayer_kernel` (QKV, out-proj) and tpudf/ops/mlp.py
// `_kernel_int8` / `_kernel_int8_ss` (fc1, fc2). On the TPU those kernels
// kept the whole int8 weight and the activation in VMEM; here a 128x128
// output tile per 256-thread block streams 64-deep K slices of A and B
// through a double-buffered cp.async ring in shared memory (40 KB).
// Bound by tensor-core operations at the main path's shapes (M = B*S rows,
// N, K in {768, 2304, 3072}); wgmma + TMA are later work.
//
// Epilogues (per output element, f = acc * ((act / 127) * col_scale[n]) +
// bias[n], rounded op by op as the JAX kernels do):
//   MODE 0  out = bf16(f)                                  (QKV)
//   MODE 1  out = int8 quant(gelu_tanh(f), act_out)        (fc1 -> hidden)
//   MODE 2  out = bf16(residual + f), and, when sumsq is not null,
//           sumsq[m] += out^2 (f32 atomics across column tiles; the order
//           of the adds varies from run to run)           (out-proj, fc2)
#include "common.cuh"

namespace tpudf {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;          // padded smem row: conflict-free
constexpr int kGemmThreads = 256;       // 8 warps: 2 (M) x 4 (N)

struct GemmArgs {
  const int8_t* a;
  const int8_t* bt;
  const float* col_scale;
  const float* bias;
  const float* act;
  const __nv_bfloat16* residual;
  void* out;
  float* sumsq;
  const float* act_out;
  int M, N, K;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// D = A (16x32, row) * B (32x8, col) + D, s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int MODE>
__global__ void __launch_bounds__(kGemmThreads) i8_gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) int8_t As[2][kBM * kLds];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;             // 0..1: 64-row slab
  const int wn = warp & 3;              // 0..3: 32-column slab
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // one stage: 128 rows x 64 bytes of A and of B = 2 x 512 16-byte chunks
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, cc = (c & 3) * 16;
      const int ar = min(m0 + r, p.M - 1);   // ragged M: clamp, never stored
      cp_async16(&As[stage][r * kLds + cc],
                 p.a + static_cast<size_t>(ar) * p.K + k0 + cc);
      cp_async16(&Bs[stage][r * kLds + cc],
                 p.bt + static_cast<size_t>(n0 + r) * p.K + k0 + cc);
    }
  };

  const int kt_count = p.K / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) load_stage((kt + 1) & 1, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = lds32(as + r * kLds + kk + t * 4);
        af[mi][1] = lds32(as + (r + 8) * kLds + kk + t * 4);
        af[mi][2] = lds32(as + r * kLds + kk + 16 + t * 4);
        af[mi][3] = lds32(as + (r + 8) * kLds + kk + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bf[ni][0] = lds32(bs + n * kLds + kk + t * 4);
        bf[ni][1] = lds32(bs + n * kLds + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // ---- epilogue: thread holds rows (g, g+8) x cols (2t, 2t+1) per tile
  const float a_div = p.act[0] / 127.0f;
  const float inv_out = MODE == 1 ? 127.0f / p.act_out[0] : 0.0f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
      const float cs0 = __fmul_rn(a_div, p.col_scale[col]);
      const float cs1 = __fmul_rn(a_div, p.col_scale[col + 1]);
      const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
        const float f0 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mi][ni][2 * h]), cs0), b0);
        const float f1 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mi][ni][2 * h + 1]), cs1), b1);
        if (row >= p.M) continue;
        const size_t o = static_cast<size_t>(row) * p.N + col;
        if (MODE == 0) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(f0, f1);
        } else if (MODE == 1) {
          char2 q;
          q.x = quant_i8(gelu_tanh(f0), inv_out);
          q.y = quant_i8(gelu_tanh(f1), inv_out);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = q;
        } else {
          const __nv_bfloat162 res =
              *reinterpret_cast<const __nv_bfloat162*>(p.residual + o);
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              __fadd_rn(__low2float(res), f0),
              __fadd_rn(__high2float(res), f1));
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) = y;
          const float y0 = __low2float(y), y1 = __high2float(y);
          ss[h] += y0 * y0 + y1 * y1;
        }
      }
    }
    if (MODE == 2 && p.sumsq != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = ss[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (t == 0 && row < p.M) atomicAdd(p.sumsq + row, v);
      }
    }
  }
}

}  // namespace tpudf

TPUDF_API int tpudf_i8_gemm(const void* a, const void* bt,
                            const void* col_scale, const void* bias,
                            const void* act, const void* residual, void* out,
                            void* sumsq, const void* act_out, int M, int N,
                            int K, int mode, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N % kBN != 0 || K % kBK != 0 || mode < 0 || mode > 2 ||
      (mode == 1 && act_out == nullptr) ||
      (mode == 2 && residual == nullptr))
    return cudaErrorInvalidValue;
  GemmArgs p{static_cast<const int8_t*>(a),
             static_cast<const int8_t*>(bt),
             static_cast<const float*>(col_scale),
             static_cast<const float*>(bias),
             static_cast<const float*>(act),
             static_cast<const __nv_bfloat16*>(residual),
             out,
             static_cast<float*>(sumsq),
             static_cast<const float*>(act_out),
             M, N, K};
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    i8_gemm_kernel<0><<<grid, kGemmThreads, 0, s>>>(p);
  else if (mode == 1)
    i8_gemm_kernel<1><<<grid, kGemmThreads, 0, s>>>(p);
  else
    i8_gemm_kernel<2><<<grid, kGemmThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
