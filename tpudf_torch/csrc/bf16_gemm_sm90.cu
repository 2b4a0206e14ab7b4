// bf16 x bf16 -> f32 GEMM with the epilogues of kernels K13 and K14, on
// Hopper's wgmma and TMA (sm90.cuh).
//
// out[m, n] = epilogue(sum_k a[m, k] * w[k, n] + bias[n]), a (M, K) and
// w (K, N) row-major bf16 (w in the JAX package's (in, out) layout, read
// where it lies), f32 sums on the tensor cores.
//
// Replaces the products of tpudf/ops/linear.py `_make_kernel` (K13,
// `linear_fused`: LN1 + QKV, out-proj + residual) and tpudf/ops/mlp.py
// `_kernel` (K14, `mlp_block_fused`: fc1 + GELU, fc2 + residual). On the
// TPU those kernels kept the whole bf16 weight, the LN output and (K14) the
// (rows, 4W) hidden in VMEM. Kernel 15's bf16 product,
// scripts/micro_pallas_int8.py `bf16_kernel` (bf16(x . w) with f32 sums,
// no bias), is MODE 0 with a null bias.
//
// At the float tower's shapes (M = views * 256 rows; N, K in {768, 2304,
// 3072}) the QKV, fc1 and fc2 products are bound by tensor-core
// operations, the out-proj (K = N = 768) nearly by bytes. The design:
// - a block is two consumer warpgroups and a producer warpgroup
//   (setmaxnreg: 24 registers for the producer, 240 for the consumers),
//   one block an SM, persistent over output tiles of 128 x 256 (tile t:
//   rows 128 (t / n_tiles_n), columns 256 (t % n_tiles_n), so that the
//   blocks running together share A's rows and the weight stays in L2);
// - each consumer owns 64 rows of the tile: m64n256k16 wgmma, 128 f32
//   accumulator registers a thread;
// - the producer's first thread streams K in steps of 64 through a ring
//   of 4 stages (48 KB each) that runs on across tiles: A's 128 x 64 box
//   (K-major, as K9's Q) and W's 64 x 256 rows as four 64 x 64 boxes
//   (MN-major, read with the transpose bit, as K9's V for p . v), each in
//   the 128-byte swizzle. No transposed copy of the weight exists;
// - ragged edges: rows of A past M and the K tail past K (K % 64 == 32)
//   arrive from TMA as zeros and add nothing; the half tile at N % 256 ==
//   128 loads two of W's boxes, and its other 128 columns are neither read
//   out nor stored;
// - the epilogue starts after the last product has retired (a plain
//   instruction on an accumulator in flight would serialise every wgmma):
//   128 columns at a time, the residual (MODE 2) arrives by TMA in the
//   warpgroup's output buffer, each thread turns its accumulators into
//   bf16 there, and a TMA store writes whole 128-byte lines, rows past M
//   clipped by the copy engine (on the card this beat bf16x2 stores from
//   the registers by 1.2-1.9x; PERF.md).
//
// Epilogues (per output element, f = acc + bias[n] in f32, the result
// rounded once to bf16, as the Pallas kernels do):
//   MODE 0  out = bf16(f)                          (QKV; bias may be null)
//   MODE 1  out = bf16(gelu_tanh(f))               (fc1 -> hidden)
//   MODE 2  out = bf16(f + residual)               (out-proj, fc2)
#include <algorithm>

#include "sm90.cuh"

namespace tpudf {
namespace {

using namespace sm90;

constexpr int kGM = 128;                 // rows of an output tile
constexpr int kGN = 256;                 // its columns
constexpr int kGK = 64;                  // K a stage: one 128-byte box wide
constexpr int kGStages = 4;
constexpr int kHalf = 128;               // columns of one epilogue pass

// shared memory: kGStages stages of A (128 x 64) and W (64 x 256, four
// 64 x 64 boxes), then each consumer's output buffer (64 x 128: two
// boxes), then the barriers
struct GemmSmem {
  static constexpr int kA = 0;
  static constexpr int kW = kGM * kGK * 2;
  static constexpr int kStage = kW + kGK * kGN * 2;
  static constexpr int kOut = kGStages * kStage;
  static constexpr int kOutWg = 2 * kBox;
  static constexpr int kBars = kOut + kWarpgroups * kOutWg;
  static constexpr size_t kBytes =
      kBars + 8 * (2 * kGStages + kWarpgroups) + 1024;
};
static_assert(GemmSmem::kBytes <= kMaxBlockSmem, "GEMM block too large");

// output tiles of an (M, N) product
inline long long gemm_tiles(int M, int N) {
  return static_cast<long long>(M / kGM + (M % kGM != 0)) *
         (N / kGN + (N % kGN != 0));
}

// One warpgroup's 64 x 128 columns H * 128 .. of its accumulator through
// its output buffer `ob` (two 64 x 64 boxes in the 128-byte swizzle: a
// row's 16-byte chunk j at chunk j ^ (row % 8)): f = acc + bias, the
// epilogue, bf16 in place of the residual (MODE 2: already in `ob`, each
// thread reads and writes the same elements).
template <int MODE, int H>
__device__ __forceinline__ void epilogue_half(const float (&acc)[kGN / 2],
                                              unsigned char* ob,
                                              const float* bias, int col0,
                                              const Consumer& c) {
#pragma unroll
  for (int jj = 0; jj < kHalf / 8; ++jj) {
    const int j = H * (kHalf / 8) + jj;
    const int col = col0 + 8 * jj + 2 * c.t;
    // MODE 0 may run without a bias (kernel 15's product): f32 acc + 0
    float2 b = make_float2(0.0f, 0.0f);
    if (MODE != 0 || bias != nullptr)
      b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c.row + 8 * r;
      const int off = (jj / 8) * kBox + row * 128 +
                      (((jj % 8) ^ (row & 7)) << 4) + 4 * c.t;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(ob + off);
      float f0 = __fadd_rn(acc[4 * j + 2 * r], b.x);
      float f1 = __fadd_rn(acc[4 * j + 2 * r + 1], b.y);
      if (MODE == 1) {
        f0 = gelu_tanh(f0);
        f1 = gelu_tanh(f1);
      } else if (MODE == 2) {
        const __nv_bfloat162 res = *p;
        f0 = __fadd_rn(f0, __low2float(res));
        f1 = __fadd_rn(f1, __high2float(res));
      }
      *p = __floats2bfloat162_rn(f0, f1);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    bf16_gemm_sm90(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap res_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const float* __restrict__ bias, int M, int N, int K) {
  using L = GemmSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const Ring<kGStages> ring{bars, bars + kGStages};
  uint64_t* res_full = bars + 2 * kGStages;    // one a consumer warpgroup
  auto stage = [&](int r) { return smem + ring.stage(r) * L::kStage; };
  const int n_tn = N / kGN + (N % kGN != 0);
  const int n_tiles = (M / kGM + (M % kGM != 0)) * n_tn;
  const int nk = (K + kGK - 1) / kGK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kGStages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], kWarpgroups * 128);
    }
    for (int i = 0; i < kWarpgroups; ++i) mbar_init(&res_full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: one lane issues every load
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    int r = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_tn * kGM, n0 = tile % n_tn * kGN;
      const int boxes = min(kGN, N - n0) / 64;     // W's boxes inside N
      const uint32_t bytes = kGM * kGK * 2 + boxes * kBox;
      for (int kt = 0; kt < nk; ++kt, ++r) {
        uint64_t* full = ring.producer_acquire(r, bytes);
        unsigned char* st = stage(r);
        tma_load_3d(st + L::kA, &a_map, full, kt * kGK, m0, 0);
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(st + L::kW + j * kBox, &w_map, full, n0 + 64 * j,
                      kt * kGK, 0);
      }
    }
    return;
  }

  // ---- consumers: 64 rows of each tile
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  unsigned char* ob = smem + L::kOut + c.wg * L::kOutWg;
  float acc[kGN / 2];
  zero(acc);        // each tile's first k16 step overwrites it (scale_d 0)
  int r = 0, res_uses = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile / n_tn * kGM, n0 = tile % n_tn * kGN;
    // the product: stage kt's four k16 steps are issued while stage
    // kt - 1's run, then kt - 1's stage is released
    for (int kt = 0; kt < nk; ++kt) {
      ring.consumer_wait(r + kt);
      unsigned char* st = stage(r + kt);
      const uint64_t da = opaque(desc_k(st + L::kA + c.wg * kBox));
      const uint64_t db = opaque(desc_mn(st + L::kW, kBox));
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kGK / 16; ++ks)
        wgmma_ss_t<kGN>(acc, step_k(da, kBox, ks), step_mn(db, ks),
                        kt > 0 || ks > 0);
      fence_regs(acc);
      wg_commit();
      wg_wait<1>();
      if (kt > 0) ring.release(r + kt - 1);
    }
    wg_wait<0>();
    fence_regs(acc);
    ring.release(r + nk - 1);
    r += nk;

    // the epilogue: rows past M are clipped by the store; a warpgroup
    // whose rows all lie past M, and the half past N, skip it
    const int row0 = m0 + 64 * c.wg;
    if (row0 >= M) continue;
#pragma unroll
    for (int h = 0; h < kGN / kHalf; ++h) {
      const int col0 = n0 + h * kHalf;
      if (col0 >= N) continue;
      if (MODE == 2) {
        if ((threadIdx.x & 127) == 0) {
          mbar_expect_tx(&res_full[c.wg], L::kOutWg);
          tma_load_3d(ob, &res_map, &res_full[c.wg], col0, row0, 0);
          tma_load_3d(ob + kBox, &res_map, &res_full[c.wg], col0 + 64, row0,
                      0);
        }
        mbar_wait(&res_full[c.wg], res_uses & 1);
        ++res_uses;
      }
      if (h == 0)
        epilogue_half<MODE, 0>(acc, ob, bias, col0, c);
      else
        epilogue_half<MODE, 1>(acc, ob, bias, col0, c);
      fence_proxy_async();
      warpgroup_sync(c.wg);
      if ((threadIdx.x & 127) == 0) {
        tma_store_3d(&out_map, ob, col0, row0, 0);
        tma_store_3d(&out_map, ob + kBox, col0 + 64, row0, 0);
        tma_store_commit();
        tma_store_wait_read();
      }
      warpgroup_sync(c.wg);
    }
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int MODE>
int launch_gemm(const void* a, const void* w, const void* bias,
                const void* residual, void* out, int M, int N, int K,
                cudaStream_t stream) {
  // the tensor maps a launch encodes on the host: A, W, out, and in MODE
  // 2 the residual
  CUtensorMap a_map, w_map, res_map, out_map;
  if (!map_bf16_3d(&a_map, a, K, M, 1, kGM) ||
      !map_bf16_3d(&w_map, w, N, K, 1, 64) ||
      !map_bf16_3d(&out_map, out, N, M, 1, 64))
    return cudaErrorInvalidValue;
  if (MODE == 2) {
    if (!map_bf16_3d(&res_map, residual, N, M, 1, 64))
      return cudaErrorInvalidValue;
  } else {
    res_map = out_map;                      // never read
  }
  static const cudaError_t attr =
      registers_suffice(bf16_gemm_sm90<MODE>)
          ? cudaFuncSetAttribute(bf16_gemm_sm90<MODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(GemmSmem::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = gemm_tiles(M, N);
  const int grid = static_cast<int>(std::min<long long>(tiles, sm_count()));
  bf16_gemm_sm90<MODE><<<grid, kThreads, GemmSmem::kBytes, stream>>>(
      a_map, w_map, res_map, out_map, static_cast<const float*>(bias), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpudf

// K13 / K14 / kernel 15: out (M, N) bf16 = epilogue(a (M, K) . w (K, N) +
// bias) with f32 sums; N % 128 == 0, K % 32 == 0, any M >= 1 (tiles of
// 128 x 256 and at most 2^31 - 1 of them); bias (N,) f32, null only in
// MODE 0; residual (M, N) bf16 in MODE 2
TPUDF_API int tpudf_bf16_gemm(const void* a, const void* w, const void* bias,
                              const void* residual, void* out, int M, int N,
                              int K, int mode, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N <= 0 || N % 128 != 0 || K <= 0 || K % 32 != 0 || mode < 0 ||
      mode > 2 || (mode != 0 && bias == nullptr) ||
      (mode == 2 && residual == nullptr) ||
      gemm_tiles(M, N) > 2147483647ll)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_gemm<0>(a, w, bias, residual, out, M, N, K, s);
  if (mode == 1) return launch_gemm<1>(a, w, bias, residual, out, M, N, K, s);
  return launch_gemm<2>(a, w, bias, residual, out, M, N, K, s);
}
