// Device pieces of the int8 x int8 -> int32 GEMM tile on mma.sync, shared
// by K6's out-projection (attention.cu), K7's four phases (layer_int8.cu,
// its LN-prologue tiles `ln_gemm_tile`) and the quantising probe GEMM
// (probe_gemm.cu). The plain int8 GEMM and K5 are int8_gemm_sm90.cu (wgmma
// and TMA), which shares the epilogue modes below (kEpiI32 only there).
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
//   kEpiI32          out = acc (int32; the caller dequantises; the sm90
//                    GEMM only)
//   kEpiResF32Out    out = f32((residual + acc * cs) + bias[n]), residual
//                    bf16: K7's attention sublayer, whose residual stays
//                    f32 into LN2 (the order of _layer_kernel's adds)
//   kEpiF32Residual  out = bf16(residual + f), residual f32 (K7's fc2)
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

// the epilogue: thread holds rows (g, g+8) x cols (2t, 2t+1) of each
// 16 x 8 tile; rows at or past m_end are not stored
template <int MODE>
__device__ __forceinline__ void gemm_epilogue(const int (&acc)[4][4][4],
                                              const GemmArgs& p, int m0,
                                              int m_end, int n0,
                                              const TileThread& q) {
  const float a_div = p.act[0] / 127.0f;
  float inv_out = 0.0f;
  if constexpr (MODE == kEpiGeluI8) inv_out = 127.0f / p.act_out[0];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    float ss[2] = {0.0f, 0.0f};
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
        const int i0 = acc[mi][ni][2 * h], i1 = acc[mi][ni][2 * h + 1];
        const float p0 = __fmul_rn(static_cast<float>(i0), cs0);
        const float p1 = __fmul_rn(static_cast<float>(i1), cs1);
        const float f0 = __fadd_rn(p0, b0), f1 = __fadd_rn(p1, b1);
        if constexpr (MODE == kEpiBf16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(f0, f1);
        } else if constexpr (MODE == kEpiGeluI8) {
          char2 c;
          c.x = quant_i8(gelu_tanh(f0), inv_out);
          c.y = quant_i8(gelu_tanh(f1), inv_out);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = c;
        } else if constexpr (MODE == kEpiResidual) {
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(p.residual) + o);
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              __fadd_rn(__low2float(res), f0),
              __fadd_rn(__high2float(res), f1));
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) = y;
          const float y0 = __low2float(y), y1 = __high2float(y);
          ss[h] += y0 * y0 + y1 * y1;
        } else if constexpr (MODE == kEpiResF32Out) {
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(p.residual) + o);
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(__fadd_rn(__fadd_rn(__low2float(res), p0), b0),
                          __fadd_rn(__fadd_rn(__high2float(res), p1), b1));
        } else {  // kEpiF32Residual
          const float2 res = *reinterpret_cast<const float2*>(
              static_cast<const float*>(p.residual) + o);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(__fadd_rn(res.x, f0),
                                    __fadd_rn(res.y, f1));
        }
      }
    }
    if constexpr (MODE == kEpiResidual) {
      if (p.sumsq != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = ss[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int row = m0 + q.wm * 64 + mi * 16 + q.g + h * 8;
          if (q.t == 0 && row < m_end) atomicAdd(p.sumsq + row, v);
        }
      }
    }
  }
}

// One 128 x 128 output tile of A (M, K) . B^T, both int8 in device memory,
// through a double-buffered cp.async ring (4 stages of kStageBytes at smem)
template <int MODE>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, int m0, int n0,
                                          int8_t* smem) {
  const TileThread q = tile_thread();
  int8_t* as = smem;
  int8_t* bs = smem + 2 * kStageBytes;
  int acc[4][4][4];
  zero_acc(acc);
  const int kt_count = p.K / kBK;
  load_stage(as, p.a, p.M, p.K, m0, 0, q.tid);
  load_stage(bs, p.bt, p.N, p.K, n0, 0, q.tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt + 1 < kt_count) {
      const int s = (kt + 1) & 1, k0 = (kt + 1) * kBK;
      load_stage(as + s * kStageBytes, p.a, p.M, p.K, m0, k0, q.tid);
      load_stage(bs + s * kStageBytes, p.bt, p.N, p.K, n0, k0, q.tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma_kslice(acc, as + (kt & 1) * kStageBytes, kLds,
               bs + (kt & 1) * kStageBytes, q);
    __syncthreads();
  }
  gemm_epilogue<MODE>(acc, p, m0, p.M, n0, q);
}

// LN + static int8 quant of the tile's 128 rows of x (bf16 or f32, width
// K <= kLnMaxWidth) into a shared int8 panel of rows `ldp` bytes apart:
// each warp takes 16 rows, one row at a time held in registers
// (load_row_ln); rows past M are zero
template <typename T>
__device__ __forceinline__ void ln_quant_panel(int8_t* panel, int ldp,
                                               const T* x, int M, int K,
                                               int m0, const float* g,
                                               const float* b, float inv,
                                               float eps,
                                               const TileThread& q) {
  const int nchunks = K / 8;
  for (int r = q.warp; r < kBM; r += kGemmThreads / 32) {
    int8_t* dst = panel + r * ldp;
    const int row = m0 + r;
    if (row >= M) {
      for (int c = q.lane; c < nchunks; c += 32)
        *reinterpret_cast<uint2*>(dst + c * 8) = make_uint2(0, 0);
      continue;
    }
    RowLN rl;
    load_row_ln(x + static_cast<size_t>(row) * K, K, eps, q.lane, rl);
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int chunk = q.lane + c * 32;
      if (chunk < nchunks) {
        __align__(8) int8_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = chunk * 8 + j;
          v[j] = quant_i8(ln_apply(rl.v[c * 8 + j], rl, g[col], b[col]), inv);
        }
        *reinterpret_cast<uint2*>(dst + chunk * 8) =
            *reinterpret_cast<uint2*>(v);
      }
    }
  }
}

// shared bytes of one LN-prologue tile: the int8 panel and two B stages
__host__ __device__ __forceinline__ size_t ln_gemm_smem(int K) {
  return static_cast<size_t>(kBM) * (K + 16) + 2 * kStageBytes;
}

// One 128 x 128 output tile of quant(LN(x)) . B^T: the LN statistics, the
// affine and the int8 quant of the tile's rows run in the prologue into
// shared memory (the first B stage already in flight), so the int8 LN
// output never reaches device memory. p.act is x's activation scale.
template <typename T, int MODE>
__device__ __forceinline__ void ln_gemm_tile(const GemmArgs& p, const T* x,
                                             const float* g, const float* b,
                                             float eps, int m0, int n0,
                                             unsigned char* smem) {
  const TileThread q = tile_thread();
  const int ldp = p.K + 16;
  int8_t* panel = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = panel + static_cast<size_t>(kBM) * ldp;
  first_b_stage(bs, p, n0, q);
  ln_quant_panel(panel, ldp, x, p.M, p.K, m0, g, b, 127.0f / p.act[0], eps,
                 q);
  int acc[4][4][4];
  zero_acc(acc);
  mma_panel(acc, panel, ldp, bs, p, n0, q);
  gemm_epilogue<MODE>(acc, p, m0, p.M, n0, q);
}

}  // namespace tpudf
