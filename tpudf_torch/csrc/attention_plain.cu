// Plain multi-head attention in f32 (kernels 11 and 12 at f32).
//
//   o = softmax(scale * q k^T) v      per (image, head), Sq != Skv allowed
//
// Replaces tpudf/ops/attention.py `_attn_kernel` (launched by
// `_attention_pallas`, the (B, H, S, D) layout; kernel 11) and the inner
// `kernel` of `_attention_pallas_bshd` (the (B, S, H, D) layout; kernel 12)
// on f32 q, k, v: JAX's kernel is dtype-generic and its test holds f32 to
// atol 5e-4, rtol 1e-3, so the products are exact f32 (no TF32, no bf16
// cast). bf16 runs on the tensor cores in attention_plain_sm90.cu. One
// kernel serves both layouts: q, k, v and o are addressed by element
// strides (image, head, row), so the (B, S, H, D) layout is read where it
// lies and never transposed.
//
// The function: s = (q . k) * scale in f32, keys past Skv masked to -inf,
// an exact softmax (row max m, e = exp(s - m), p = e / l with l the row sum,
// normalised before p . v), o = p . v summed in f32. Two sweeps over the
// keys: the row statistics, then p and p . v.
//
// A SIMT kernel tiled in registers like an SGEMM micro-kernel: one block of
// 192 threads for each (48 query rows, head, image), 64-key tiles of K and
// V in shared memory; thread (ty, tx) of a 12 x 16 grid holds the scores
// of rows 4 ty .. 4 ty + 3 and keys tx, tx + 16, tx + 32, tx + 48 of a
// tile (32 FMAs for every six shared loads: Q^T as a float4 of its rows at
// two columns, K as a float2 of each key's two columns), and the outputs of
// the same rows at columns 4 tx .. 4 tx + 3 (+ 64 at head_dim > 64) (16
// FMAs for every two float4 loads: p^T of its rows, a row of V). A warp
// covers 16 rows by 32 keys, so its loads of Q^T and p^T are 64
// contiguous bytes and those of K and V hit distinct banks (rows padded by
// 4 floats). Each thread keeps its own running max and sum of each row
// over its keys (rescaled at a new max); the 16 threads of a row merge
// them once, after the first sweep (the eight lanes of a warp by xor 1, 2,
// 4, then the two key halves through shared memory, in a fixed order). The
// softmax's instructions are sm90.cuh's (ex2 on scores that carry log2 e,
// p = e r). K and V arrive by cp.async of 16 bytes where every row start
// is 16-byte aligned (head_dim, the strides and the base of k and v
// multiples of 4 floats), else of 4 bytes, zero past Skv and past head_dim
// (the zero columns add exact zeros); the block waits for its tile, and
// the blocks an SM holds (three at head_dim <= 64) cover one another's
// loads. 48 rows a block suit the table's (2, 16, 576) on 132 SMs: 384
// blocks, three an SM, where 64 rows left 24 SMs a third block; other
// row counts, a second stage of K and V and an 8 x 4 register tile were
// measured and not kept (PERF.md).
// The card's bound is the f32 FMAs: twice 2 Sq Skv D for q . k (both
// sweeps) and 2 Sq Skv D for p . v.
#include <cstdint>

#include "sm90.cuh"

namespace tpudf {
namespace {

using sm90::ex2;
using sm90::kLog2e;
using sm90::rcp_refined;

constexpr int kKeys = 64;            // keys a tile
constexpr int kRows = 48;            // query rows a block
constexpr int kSmSmem = 233472;      // shared memory an SM holds (bytes)

// row stride of the K and V tiles of DP columns (floats)
template <int DP>
__host__ __device__ constexpr int ld_kv() {
  return DP + 4;
}

// shared memory (floats) of a block of R query rows: Q^T (DP x R + 4), a
// K and a V tile (kKeys x ld_kv), p^T (kKeys x R + 4), the row statistics
// of the block's two key halves (2 x R x 2)
template <int DP, int R>
struct F32Smem {
  static constexpr int kLdT = R + 4;
  static constexpr int kTile = kKeys * ld_kv<DP>();
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + DP * kLdT;
  static constexpr int kV = kK + kTile;
  static constexpr int kP = kV + kTile;
  static constexpr int kStats = kP + kKeys * kLdT;
  static constexpr size_t kBytes = (kStats + 4 * R) * sizeof(float);
  // blocks an SM holds (each also takes 1 KB of the SM's shared memory)
  static constexpr int kBlocks = kSmSmem / static_cast<int>(kBytes + 1024);
};

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int heads, sq, skv, hd;
  int q_sb, q_sh, q_ss;      // q and o: element strides of image, head, row
  int kv_sb, kv_sh, kv_ss;   // k and v
  float mul;                 // the scale, times log2 e
};

// N bytes global -> shared by cp.async, zeros in place of the source
// where `in` is false (the source is then not read)
template <int N>
__device__ __forceinline__ void cp_async_zfill(float* smem, const float* gmem,
                                               bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(in ? 4 : 0));
}

// (m, l) of a row merged with another part's: the larger max, the sums
// rescaled to it
__device__ __forceinline__ void merge(float& m, float& l, float mo,
                                      float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == __int_as_float(0xff800000)) return;      // no key seen yet
  l = __fadd_rn(__fmul_rn(l, ex2(m - mn)), __fmul_rn(lo, ex2(mo - mn)));
  m = mn;
}

// A block of 4R threads: R / 16 warp pairs, a warp 4 ty x 8 tx
template <int DP, int VEC>
__global__ void __launch_bounds__(4 * kRows, (F32Smem<DP, kRows>::kBlocks))
    attention_plain_f32(F32Args a) {
  constexpr int R = kRows;
  using L = F32Smem<DP, R>;
  constexpr int LD = ld_kv<DP>(), LT = L::kLdT, NT = 4 * R;
  constexpr int NC = DP / 16;        // output columns a thread
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm + L::kQ;
  float* ks = fsm + L::kK;
  float* vs = fsm + L::kV;
  float* ps = fsm + L::kP;
  float* stats = fsm + L::kStats;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (lane >> 3) + 4 * (warp >> 1);
  const int tx = (lane & 7) + 8 * (warp & 1);
  const float* qg = a.q + static_cast<size_t>(b) * a.q_sb +
                    static_cast<size_t>(h) * a.q_sh;
  const float* kg = a.k + static_cast<size_t>(b) * a.kv_sb +
                    static_cast<size_t>(h) * a.kv_sh;
  const float* vg = a.v + static_cast<size_t>(b) * a.kv_sb +
                    static_cast<size_t>(h) * a.kv_sh;
  const int dk = (a.hd + 1) & ~1;    // the products' depth, in steps of 2
  const int ntiles = (a.skv + kKeys - 1) / kKeys;
  const float neg_inf = __int_as_float(0xff800000);

  // Q^T, zero past Sq and past head_dim
  for (int i = threadIdx.x; i < R * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    qs[d * LT + r] = q0 + r < a.sq && d < a.hd
                         ? qg[static_cast<size_t>(q0 + r) * a.q_ss + d]
                         : 0.0f;
  }
  // rows k0 .. k0 + 63 of K or V, zero past Skv and past head_dim
  auto load_rows = [&](float* dst, const float* src, int k0) {
    for (int i = threadIdx.x; i < kKeys * DP / VEC; i += NT) {
      const int r = i / (DP / VEC), c = VEC * (i % (DP / VEC));
      const bool in = k0 + r < a.skv && c < a.hd;
      cp_async_zfill<4 * VEC>(
          dst + r * LD + c,
          in ? src + static_cast<size_t>(k0 + r) * a.kv_ss + c : src, in);
    }
  };
  // the block's tile of sweep 1 (K) or sweep 2 (K and V) at key k0, once
  // every thread is done with the last one
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();
    load_rows(ks, kg, k0);
    if (with_v) load_rows(vs, vg, k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  // s[i][j] = (q_{4 ty + i} . k_{tx + 16 j}) * mul, -inf past Skv
  auto scores = [&](float (&s)[4][4], int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dk; d += 2) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + d * LT + 4 * ty);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + (d + 1) * LT + 4 * ty);
      const float qr[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                              {qb.x, qb.y, qb.z, qb.w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 kk =
            *reinterpret_cast<const float2*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = fmaf(qr[1][i], kk.y, fmaf(qr[0][i], kk.x, s[i][j]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = k0 + tx + 16 * j < a.skv;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = in ? __fmul_rn(s[i][j], a.mul) : neg_inf;
    }
  };
  // ---- sweep 1: each thread's running max and sum of its keys of a row
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf;
    l[i] = 0.0f;
  }
  float s[4][4];
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t * kKeys, false);
    scores(s, t * kKeys);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tm = fmaxf(fmaxf(fmaxf(m[i], s[i][0]), s[i][1]),
                             fmaxf(s[i][2], s[i][3]));
      if (tm == neg_inf) continue;
      if (tm != m[i]) l[i] = __fmul_rn(l[i], ex2(m[i] - tm));
      m[i] = tm;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        l[i] = __fadd_rn(l[i], ex2(s[i][j] - tm));
    }
  }
  // the 16 threads of a row: the eight lanes of its warp, then the other
  // key half's warp, in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      merge(m[i], l[i], mo, lo);
    }
  if ((lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      stats[((warp & 1) * R + 4 * ty + i) * 2] = m[i];
      stats[((warp & 1) * R + 4 * ty + i) * 2 + 1] = l[i];
    }
  }
  __syncthreads();
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = stats[(4 * ty + i) * 2];
    l[i] = stats[(4 * ty + i) * 2 + 1];
    merge(m[i], l[i], stats[(R + 4 * ty + i) * 2],
          stats[(R + 4 * ty + i) * 2 + 1]);
    r[i] = rcp_refined(l[i]);
  }

  // ---- sweep 2: p = exp(s - m) / l, o += p . v
  float o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t * kKeys, true);
    scores(s, t * kKeys);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 p;
      p.x = __fmul_rn(ex2(s[0][j] - m[0]), r[0]);
      p.y = __fmul_rn(ex2(s[1][j] - m[1]), r[1]);
      p.z = __fmul_rn(ex2(s[2][j] - m[2]), r[2]);
      p.w = __fmul_rn(ex2(s[3][j] - m[3]), r[3]);
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * LT + 4 * ty) = p;
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + key * LT + 4 * ty);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < NC / 4; ++cc) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vs + key * LD + 4 * tx + 64 * cc);
        const float vr[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][4 * cc + e] = fmaf(pr[i], vr[e], o[i][4 * cc + e]);
      }
    }
  }
  float* og = a.o + static_cast<size_t>(b) * a.q_sb +
              static_cast<size_t>(h) * a.q_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + (c & 3) + 64 * (c >> 2);
      if (col < a.hd) og[static_cast<size_t>(qi) * a.q_ss + col] = o[i][c];
    }
  }
}

template <int DP, int VEC>
int launch_f32(const F32Args& a, int batch, cudaStream_t stream) {
  using L = F32Smem<DP, kRows>;
  static const cudaError_t attr = [] {
    cudaError_t err = cudaFuncSetAttribute(
        attention_plain_f32<DP, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          attention_plain_f32<DP, VEC>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.sq + kRows - 1) / kRows, a.heads, batch);
  attention_plain_f32<DP, VEC><<<grid, 4 * kRows, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpudf

// q, o: (B, H, Sq, D) or (B, Sq, H, D); k, v: (B, H, Skv, D) or (B, Skv,
// H, D), f32, as the strides say (elements of image, head and row; unit
// stride along D); head_dim <= 128; Sq, Skv >= 1.
TPUDF_API int tpudf_attention_plain_f32(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int heads, int sq, int skv,
                                        int head_dim, int q_sb, int q_sh,
                                        int q_ss, int kv_sb, int kv_sh,
                                        int kv_ss, float scale,
                                        void* stream) {
  using namespace tpudf;
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (skv <= 0 || head_dim < 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  heads, sq, skv, head_dim, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                  kv_ss, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies only where every row start of k and v is 16-byte aligned
  const bool vec =
      (head_dim | kv_sb | kv_sh | kv_ss) % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
  if (head_dim > 64)
    return vec ? launch_f32<128, 4>(a, batch, s)
               : launch_f32<128, 1>(a, batch, s);
  return vec ? launch_f32<64, 4>(a, batch, s)
             : launch_f32<64, 1>(a, batch, s);
}

// dynamic shared bytes of a launch at head_dim hd (-1 outside the domain)
TPUDF_API int tpudf_plain_f32_smem(int hd) {
  using namespace tpudf;
  if (hd < 0 || hd > 128) return -1;
  return static_cast<int>(hd > 64 ? F32Smem<128, kRows>::kBytes
                                  : F32Smem<64, kRows>::kBytes);
}
