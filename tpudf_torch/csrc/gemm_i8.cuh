// Device pieces of the int8 x int8 -> int32 GEMM tile on mma.sync: the
// quantising probe GEMM's (probe_gemm.cu), whose panel tile streams the
// weight through cp.async stages; 9b's and probe 17's int8 products
// (attention_i8.cu) take its mma.sync wrapper. The W8A8 block's products,
// K5, K6 and K7 run on int8 wgmma and TMA (int8_gemm_sm90.cu,
// i8_sm90.cuh), which share the epilogue modes below.
//
// A tile is 128 x 128 outputs for 256 threads: 8 warps, 2 (M, 64 rows) x
// 4 (N, 32 columns), mma.sync m16n8k32 s8 with exact int32 accumulators;
// K advances in 64-deep slices. B is the weight transposed once at load
// time, (N, K) row-major, streamed through shared memory by cp.async.
//
// Epilogues, per output element, with f = acc * ((act / 127) * col_scale[n])
// + bias[n] rounded op by op as the JAX kernels do:
//   kEpiBf16         out = bf16(f)                                (QKV)
//   kEpiGeluI8       out = int8 quant(gelu_tanh(f), act_out)      (fc1)
//   kEpiResidual     out = bf16(residual + f), and, when sumsq is not
//                    null, sumsq[m] += out^2 (f32 atomics across column
//                    tiles; the order of the adds varies from run to run)
//   kEpiI32          out = acc (int32; the caller dequantises)
//   kEpiResF32Out    out = f32((residual + acc * cs) + bias[n]), residual
//                    bf16: K7's attention sublayer, whose residual stays
//                    f32 into LN2 (the order of _layer_kernel's adds)
//   kEpiF32Residual  out = bf16(residual + f), residual f32 (K7's fc2)
// This file's tile has the first (`gemm_epilogue_bf16`); the others are
// int8_gemm_sm90.cu's and i8_sm90.cuh's.
#pragma once

#include "common.cuh"

namespace tpudf {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;          // padded smem row: conflict-free
constexpr int kGemmThreads = 256;       // 8 warps: 2 (M) x 4 (N)
constexpr int kStageBytes = kBM * kLds; // one 128 x 64 int8 stage

enum : int {
  kEpiBf16 = 0,
  kEpiGeluI8 = 1,
  kEpiResidual = 2,
  kEpiI32 = 3,
  kEpiResF32Out = 4,
  kEpiF32Residual = 5,
};

struct GemmArgs {
  const int8_t* a;          // (M, K) int8 (null where A is built in smem)
  const int8_t* bt;         // (N, K) int8
  const float* col_scale;   // (N,)
  const float* bias;        // (N,)
  const float* act;         // the input's activation scale (0-d)
  const void* residual;     // (M, N) bf16, or f32 for kEpiF32Residual
  void* out;                // (M, N)
  float* sumsq;             // (M,) or null
  const float* act_out;     // kEpiGeluI8: the output's activation scale
  int M, N, K;
};

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

struct TileThread {
  int tid, warp, lane, wm, wn, g, t;
};

__device__ __forceinline__ TileThread tile_thread() {
  TileThread q;
  q.tid = threadIdx.x;
  q.warp = q.tid >> 5;
  q.lane = q.tid & 31;
  q.wm = q.warp >> 2;                   // 0..1: 64-row slab
  q.wn = q.warp & 3;                    // 0..3: 32-column slab
  q.g = q.lane >> 2;
  q.t = q.lane & 3;
  return q;
}

__device__ __forceinline__ void zero_acc(int (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
}

// 128 rows x 64 bytes of a row-major (rows, K) int8 matrix from row r0 and
// column k0 into a stage of kLds-byte rows (cp.async; rows past `rows`
// repeat the last one and are never stored)
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* src,
                                           int rows, int K, int r0, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kGemmThreads;
    const int r = c >> 2, cc = (c & 3) * 16;
    const int sr = min(r0 + r, rows - 1);
    cp_async16(dst + r * kLds + cc,
               src + static_cast<size_t>(sr) * K + k0 + cc);
  }
}

// acc += A (this warp's 64 rows, 64 k) . B (its 32 columns, 64 k)^T, both
// from shared memory: A rows `lda` bytes apart, B rows kLds apart
__device__ __forceinline__ void mma_kslice(int (&acc)[4][4][4],
                                           const int8_t* as, int lda,
                                           const int8_t* bs,
                                           const TileThread& q) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = q.wm * 64 + mi * 16 + q.g;
      af[mi][0] = lds32(as + r * lda + kk + q.t * 4);
      af[mi][1] = lds32(as + (r + 8) * lda + kk + q.t * 4);
      af[mi][2] = lds32(as + r * lda + kk + 16 + q.t * 4);
      af[mi][3] = lds32(as + (r + 8) * lda + kk + 16 + q.t * 4);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = q.wn * 32 + ni * 8 + q.g;
      bf[ni][0] = lds32(bs + n * kLds + kk + q.t * 4);
      bf[ni][1] = lds32(bs + n * kLds + kk + 16 + q.t * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
}

// the first B stage of mma_panel: issue it, as early as the caller may
__device__ __forceinline__ void first_b_stage(int8_t* bs, const GemmArgs& p,
                                              int n0, const TileThread& q) {
  load_stage(bs, p.bt, p.N, p.K, n0, 0, q.tid);
  cp_async_commit();
}

// acc += A (128 x K, int8 in shared memory, rows `lda` bytes apart) . B^T
// for the 128 rows of bt from n0, streaming B through the two stages at
// `bs` (one cp.async group in flight ahead of the products); the caller
// has issued the first stage (first_b_stage)
__device__ __forceinline__ void mma_panel(int (&acc)[4][4][4],
                                          const int8_t* panel, int lda,
                                          int8_t* bs, const GemmArgs& p,
                                          int n0, const TileThread& q) {
  const int kt_count = p.K / kBK;
  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count)
      load_stage(bs + ((kt + 1) & 1) * kStageBytes, p.bt, p.N, p.K, n0,
                 (kt + 1) * kBK, q.tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma_kslice(acc, panel + kt * kBK, lda, bs + (kt & 1) * kStageBytes, q);
    __syncthreads();
  }
}

// kEpiBf16's epilogue: thread holds rows (g, g+8) x cols (2t, 2t+1) of
// each 16 x 8 tile; rows at or past m_end are not stored
__device__ __forceinline__ void gemm_epilogue_bf16(const int (&acc)[4][4][4],
                                                   const GemmArgs& p, int m0,
                                                   int m_end, int n0,
                                                   const TileThread& q) {
  const float a_div = p.act[0] / 127.0f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + q.wn * 32 + ni * 8 + q.t * 2;
      const float cs0 = __fmul_rn(a_div, p.col_scale[col]);
      const float cs1 = __fmul_rn(a_div, p.col_scale[col + 1]);
      const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + q.wm * 64 + mi * 16 + q.g + h * 8;
        if (row >= m_end) continue;
        const size_t o = static_cast<size_t>(row) * p.N + col;
        const float f0 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mi][ni][2 * h]), cs0), b0);
        const float f1 = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[mi][ni][2 * h + 1]), cs1), b1);
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(p.out) + o) =
            __floats2bfloat162_rn(f0, f1);
      }
    }
  }
}

// shared bytes of a panel tile at depth K: the int8 panel (rows K + 16
// bytes apart) and two B stages
__host__ __device__ __forceinline__ size_t panel_gemm_smem(int K) {
  return static_cast<size_t>(kBM) * (K + 16) + 2 * kStageBytes;
}

}  // namespace tpudf
