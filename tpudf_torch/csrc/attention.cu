// Per-image, per-head full-softmax attention over the fused bf16 qkv
// activation (B, S, 3Wa) laid out [q | k | v], with an optional per-key
// logit bias (ToMe proportional attention, log token size). One kernel,
// two output epilogues:
//   int8  K1 (b): the static int8 quant of o that feeds the out-projection
//         GEMM; replaces the attention loop of tpudf/ops/int8_block.py
//         `_attn_sublayer_kernel`, whose TPU kernel kept qkv in VMEM
//         between the QKV projection and this step.
//   bf16  K9: o itself, (B, S, Wa) bf16; replaces tpudf/ops/attention.py
//         `_attention_qkv_pallas` (inner `kernel`, `_one_head` without
//         int8_attn), the float tower's attention and the reference route
//         of `attn_out_int8`. The Pallas kernel sliced per-head columns of
//         the qkv block in VMEM; here each block reads its head's columns
//         from device memory.
// Same arithmetic in both: scores = (q . k) * scale in f32, + bias,
// p = e / sum(e) with e = exp(s - max) in f32, p rounded to bf16, o = p . v
// accumulated in f32, then o rounded once to the output.
//
// One block per (query tile of 64, head, image), four warps of 16 query
// rows, head_dim 64 or 128 (a template parameter), S <= kMaxSeq = 1024.
// The Q tile sits in shared memory until each warp has its fragments; the
// head's K and V stream through a two-stage cp.async ring of 64-key tiles
// (attn_stream in attn_tile.cuh): a pass over K for each row's max and
// sum, then a pass over K and V for p and p . v, both products on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulate). Shared memory:
// 46 KB at head_dim 64, 87 KB at 128, whatever S. At the float engine's
// shapes the bound is the bytes of qkv; K and V are re-read from L2 by
// each of the S/64 query-tile blocks of a head, K twice.
//
// K6, replacing tpudf/ops/int8_block.py `_attn_out_kernel` (wrapper
// `attn_out_int8`): qkv (B, S, 3Wa) bf16 and the residual x (B, S, W) ->
// per-head attention -> int8 quant of the f32 o -> int8 out-projection ->
// dequant + bias + residual -> bf16, in ONE launch over (128-query tile,
// image) blocks of 8 warps (attn_out_tile in attn_tile.cuh). The TPU kernel
// kept the attention output in VMEM; here it stays in a (128 x Wa) int8
// tile in shared memory. Per block the heads run one after another, K and
// V streamed from L2 as above; the out-projection's weight streams from L2
// for each block. 128 query rows (not the TPU kernel's 256, nor the K1
// attention's 64) give the out-projection the GEMM's own 128 x 128 tile;
// with the K/V ring the block's shared memory no longer depends on S (188
// KB at large-384's S = 576, Wa = 1024). At the detect core's shapes the
// bound is the tensor-core operations.
#include "attn_tile.cuh"

namespace tpudf {

constexpr int kQTile = 64;               // query rows per block
constexpr int kAttnWarps = 4;            // 16 query rows each

template <int HD, bool kI8Out>
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ key_bias,
                     const float* __restrict__ act_scale,
                     void* __restrict__ out, int seq, int heads,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + kQTile * row_ld<HD>();
  const int wa = heads * HD;                    // attention width
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const size_t row3 = static_cast<size_t>(3) * wa;         // qkv row stride
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;
  load_rows<HD>(qs, base, row3, q0, kQTile, seq);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;                 // this warp's first tile row
  // every warp joins the ring's barriers; rows past seq hold zero queries
  // (finite) and are never stored
  AttnWarp<HD> w;
  load_q<HD>(w, qs + r0 * row_ld<HD>(), lane);
  attn_stream<HD>(w, base + wa, base + 2 * wa, row3, seq,
                  key_bias == nullptr
                      ? nullptr
                      : key_bias + static_cast<size_t>(b) * seq,
                  scale, ring, lane);

  // ---- epilogue: rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3)
  const int g = lane >> 2, t = lane & 3;
  const float inv_out = kI8Out ? 127.0f / act_scale[0] : 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    const size_t row = (static_cast<size_t>(b) * seq + qi) * wa + h * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const size_t o_ix = row + dt * 8 + 2 * t;
      const float o0 = w.o[dt][2 * r], o1 = w.o[dt][2 * r + 1];
      if constexpr (kI8Out) {
        char2 q8;
        q8.x = quant_i8(o0, inv_out);
        q8.y = quant_i8(o1, inv_out);
        *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o_ix) = q8;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(out) + o_ix) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
}

template <int HD, bool kI8Out>
int launch_attention_hd(const void* qkv, const void* key_bias,
                        const void* act_scale, void* out, int batch, int seq,
                        int heads, float scale, void* stream) {
  const size_t smem =
      static_cast<size_t>(kQTile * row_ld<HD>() + ring_elems<HD>()) *
      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD, kI8Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  attention_kernel<HD, kI8Out><<<grid, kAttnWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(key_bias),
      static_cast<const float*>(act_scale), out, seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kI8Out>
int launch_attention(const void* qkv, const void* key_bias,
                     const void* act_scale, void* out, int batch, int seq,
                     int heads, int head_dim, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (seq > kMaxSeq || (kI8Out && act_scale == nullptr))
    return cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_attention_hd<64, kI8Out>(qkv, key_bias, act_scale, out,
                                           batch, seq, heads, scale, stream);
  if (head_dim == 128)
    return launch_attention_hd<128, kI8Out>(qkv, key_bias, act_scale, out,
                                            batch, seq, heads, scale, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K10: the backward of K9 (no logit bias), replacing tpudf/ops/attention.py
// `_attn_qkv_bwd_kernel`. Per image and head, from the saved qkv and the
// output's cotangent g:
//   P = softmax(scale q k^T) in f32;  dV = bf16(P)^T g;  dP = g V^T;
//   D = rowsum(dP * P);  dS = P * (dP - D) * scale;
//   dQ = bf16(dS) K;  dK = bf16(dS)^T Q
// with f32 accumulators, written as bf16 into dqkv (B, S, 3W) in the
// forward's [q | k | v] layout. P is rounded to bf16 only for dV and dS
// only for dQ and dK; D uses the unrounded P, as the TPU kernel does.
//
// The TPU kernel held one head's whole (S, S) f32 P in VMEM (JAX sends a
// shape to it while that tile and the qkv rows fit 12 MiB: S up to ~1,560
// at W = 128); at S = 576 one head's P is 1.3 MB, far beyond an SM's
// shared memory, and dK, dV sum over every query row. So the work is
// split as FlashAttention-2 splits it, into two launches over (64-row
// tile, head, image) blocks of four warps of 16 rows, each recomputing
// the scores it needs on the tensor cores (mma.sync m16n8k16 bf16, f32
// accumulate) instead of storing P, with the other side's rows streamed
// through a two-stage cp.async ring of 64-row tiles (as K9's attn_stream
// streams K and V), so that shared memory does not grow with S:
//   dq pass   (query tiles; Q and g of the tile in shared memory, K and V
//             streamed): four sweeps over the keys: the row max, the row
//             sum of exp(s - max) (the exact softmax, not an online one),
//             D, then dS and dQ += bf16(dS) K. It writes dQ and the rows'
//             max, sum and D (f32 scratch, 12 bytes a row).
//   dkv pass  (key tiles; K and V of the tile in shared memory, Q and g
//             streamed, the head's row statistics in shared memory): one
//             sweep over the queries in chunks of 16: S^T = K Q^T, P^T
//             from the saved max and sum, dV += bf16(P^T) g,
//             dP^T = V g^T, dS^T, dK += bf16(dS^T) Q.
// head_dim is a template parameter (64, or 128 for so400m's heads of 72
// padded by the caller, whose scale stays 72^-0.5: the scale is an
// argument and never derived from head_dim). Registers: the warp's own
// A fragments are read from shared memory for each 16-row chunk instead of
// being held, so a thread holds only its accumulators (dQ: HD/2 f32; dK
// and dV: HD) and two 16 x 16 score tiles. Ragged S (a multiple of 8, not
// of 64): keys past S score -inf in the dq pass and queries past S have
// P = 0 in the dkv pass; streamed rows past S repeat row S - 1 (finite,
// no read outside the tensor), rows of the block's own tile past S are
// zero and never stored. The scores and products never touch device
// memory; each block reads its head's qkv and g rows from L2. The card's
// bound at the MTL step's shapes is the bytes of qkv, g and dqkv at S =
// 256 and the tensor-core operations at S = 576 and above.

constexpr int kBwdTile = 64;             // rows of a block: 4 warps x 16

// the most dynamic shared memory a block may have on sm_90
constexpr size_t kMaxBlockSmem = 232448;

// c (16 x 16) += A . B^T for the 16 shared rows A at `a` and the 16 shared
// rows B at `b` (rows of HD dims; A's fragments by ldmatrix, B's rows as
// the n index of two n8 tiles): scores against keys, or dP against V
template <int HD>
__device__ __forceinline__ void mma_nt16(float (&c)[2][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int lane) {
  constexpr int ld = row_ld<HD>();
  const __nv_bfloat16* ar = a + (lane & 15) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* br =
      b + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    unsigned af[4], bfr[4];
    ldsm_x4(af, ar + kc * 16);
    ldsm_x4(bfr, br + kc * 16);
    mma_bf16(c[0], af, bfr[0], bfr[1]);
    mma_bf16(c[1], af, bfr[2], bfr[3]);
  }
}

// acc (16 x HD) += bf16(c) (16 x 16) . R for the 16 shared rows R at
// `rows` (the k index, dims as n; ldmatrix.trans)
template <int HD>
__device__ __forceinline__ void mma_nn16(float (&acc)[HD / 8][4],
                                         const float (&c)[2][4],
                                         const __nv_bfloat16* rows,
                                         int lane) {
  unsigned a[4];
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
  const __nv_bfloat16* r =
      rows + (lane & 15) * row_ld<HD>() + (lane >> 4) * 8;
#pragma unroll
  for (int dn = 0; dn < HD / 16; ++dn) {
    unsigned b[4];
    ldsm_x4_trans(b, r + dn * 16);
    mma_bf16(acc[2 * dn], a, b[0], b[1]);
    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero16(float (&c)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
}

// bf16 rows of a 16 x HD accumulator: tile rows row0 + g (e = 0, 1) and
// + 8 (e = 2, 3), each row `ld` apart, those < seq only
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, size_t ld,
                                          const float (&acc)[HD / 8][4],
                                          int row0, int seq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + row * ld + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// the scores of the warp's 16 query rows `qrows` against the 16 shared
// key rows `krows` (keys k0 ..): (q . k) * scale in f32, -inf past seq
template <int HD>
__device__ __forceinline__ void key_scores(float (&s)[2][4],
                                           const __nv_bfloat16* qrows,
                                           const __nv_bfloat16* krows,
                                           int k0, int seq, float scale,
                                           int lane) {
  zero16(s);
  mma_nt16<HD>(s, qrows, krows, lane);
  const int t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = key < seq ? __fmul_rn(s[n][e], scale) : neg_inf;
    }
}

// stats: (3, B, H, S) f32 — row max, row sum of exp(s - max), D
template <int HD>
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ gout,
                            __nv_bfloat16* __restrict__ dqkv,
                            float* __restrict__ stats, int seq, int heads,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = row_ld<HD>();
  constexpr int kTile = kKeyTile * ld;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = qs + kBwdTile * ld;
  __nv_bfloat16* ring = gs + kBwdTile * ld;
  // stage i of K at ring + i kTile, of V at ring + (2 + i) kTile
  auto kst = [&](int t) { return ring + (t & 1) * kTile; };
  auto vst = [&](int t) { return ring + (2 + (t & 1)) * kTile; };
  const int wa = heads * HD;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBwdTile;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;
  const __nv_bfloat16* kg = base + wa;
  const __nv_bfloat16* vg = base + 2 * wa;
  // rows past seq hold zero queries and cotangents: finite, never stored
  load_rows<HD>(qs, base, row3, q0, kBwdTile, seq);
  load_rows<HD>(gs, gout + static_cast<size_t>(b) * seq * wa + h * HD, wa,
                q0, kBwdTile, seq);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* qrows = qs + warp * 16 * ld;
  const __nv_bfloat16* grows = gs + warp * 16 * ld;
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float dsum[2] = {0.0f, 0.0f};
  float s[2][4], dp[2][4];

  // ---- sweeps 1 and 2 (K tiles): the row max, then the row sum of
  // exp(s - max) with the final max (the exact softmax of the TPU kernel)
  for (int sweep = 0; sweep < 2; ++sweep) {
    stage_rows<HD>(kst(0), kg, row3, 0, seq);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles)
        stage_rows<HD>(kst(t + 1), kg, row3, (t + 1) * kKeyTile, seq);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kKeyTile / 16; ++c) {
        key_scores<HD>(s, qrows, kst(t) + c * 16 * ld,
                       t * kKeyTile + c * 16, seq, scale, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            if (sweep == 0)
              mx[r] = fmaxf(mx[r], s[n][e]);
            else
              sum[r] += expf(s[n][e] - mx[r]);
          }
      }
      __syncthreads();                // the stage may be refilled
    }
    if (sweep == 0) {
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);

  // ---- sweeps 3 and 4 (K and V tiles): D = rowsum(dP * P) with
  // p = exp(s - max) / sum as the forward computes it, then dS and dQ
  float dq[HD / 8][4];
  zero_acc<HD>(dq);
  for (int sweep = 0; sweep < 2; ++sweep) {
    stage_rows<HD>(kst(0), kg, row3, 0, seq);
    stage_rows<HD>(vst(0), vg, row3, 0, seq);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) {
        stage_rows<HD>(kst(t + 1), kg, row3, (t + 1) * kKeyTile, seq);
        stage_rows<HD>(vst(t + 1), vg, row3, (t + 1) * kKeyTile, seq);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kKeyTile / 16; ++c) {
        key_scores<HD>(s, qrows, kst(t) + c * 16 * ld, t * kKeyTile + c * 16,
                       seq, scale, lane);
        zero16(dp);
        mma_nt16<HD>(dp, grows, vst(t) + c * 16 * ld, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = expf(s[n][e] - mx[r]) / sum[r];
            if (sweep == 0)
              dsum[r] += __fmul_rn(dp[n][e], p);
            else
              s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], dsum[r])),
                                  scale);
          }
        if (sweep == 1) mma_nn16<HD>(dq, s, kst(t) + c * 16 * ld, lane);
      }
      __syncthreads();
    }
    if (sweep == 0) {
      dsum[0] = quad_sum(dsum[0]);
      dsum[1] = quad_sum(dsum[1]);
    }
  }
  const int row0 = q0 + warp * 16;
  store_acc<HD>(dqkv + static_cast<size_t>(b) * seq * row3 + h * HD, row3,
                dq, row0, seq, lane);
  if ((lane & 3) == 0) {
    const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * seq;
    const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + (lane >> 2) + 8 * r;
      if (qi >= seq) continue;
      stats[head_row + qi] = mx[r];
      stats[n_rows + head_row + qi] = sum[r];
      stats[2 * n_rows + head_row + qi] = dsum[r];
    }
  }
}

// rows of the row statistics in the dkv pass: S rounded up to the
// streamed tiles
__host__ __device__ constexpr int bwd_stat_rows(int seq) {
  return (seq + kKeyTile - 1) / kKeyTile * kKeyTile;
}

template <int HD>
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ gout,
                             __nv_bfloat16* __restrict__ dqkv,
                             const float* __restrict__ stats, int seq,
                             int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = row_ld<HD>();
  constexpr int kTile = kKeyTile * ld;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBwdTile * ld;
  __nv_bfloat16* ring = vs + kBwdTile * ld;
  // stage i of Q at ring + i kTile, of g at ring + (2 + i) kTile
  auto qst = [&](int t) { return ring + (t & 1) * kTile; };
  auto gst = [&](int t) { return ring + (2 + (t & 1)) * kTile; };
  const int n_stat = bwd_stat_rows(seq);
  float* s_max = reinterpret_cast<float*>(ring + 4 * kTile);
  float* s_sum = s_max + n_stat;
  float* s_d = s_sum + n_stat;
  const int wa = heads * HD;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBwdTile;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;
  const __nv_bfloat16* gg = gout + static_cast<size_t>(b) * seq * wa + h * HD;
  // keys past seq are zero rows: finite, never stored
  load_rows<HD>(ks, base + wa, row3, k0, kBwdTile, seq);
  load_rows<HD>(vs, base + 2 * wa, row3, k0, kBwdTile, seq);
  const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * seq;
  const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
  for (int i = threadIdx.x; i < n_stat; i += blockDim.x) {
    const bool in = i < seq;
    s_max[i] = in ? stats[head_row + i] : 0.0f;
    s_sum[i] = in ? stats[n_rows + head_row + i] : 1.0f;
    s_d[i] = in ? stats[2 * n_rows + head_row + i] : 0.0f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* krows = ks + warp * 16 * ld;
  const __nv_bfloat16* vrows = vs + warp * 16 * ld;
  const int t4 = lane & 3;
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  float dk[HD / 8][4], dv[HD / 8][4];
  zero_acc<HD>(dk);
  zero_acc<HD>(dv);
  float p[2][4], ds[2][4];
  stage_rows<HD>(qst(0), base, row3, 0, seq);
  stage_rows<HD>(gst(0), gg, wa, 0, seq);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_rows<HD>(qst(t + 1), base, row3, (t + 1) * kKeyTile, seq);
      stage_rows<HD>(gst(t + 1), gg, wa, (t + 1) * kKeyTile, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKeyTile / 16; ++c) {
      const __nv_bfloat16* qrows = qst(t) + c * 16 * ld;
      const __nv_bfloat16* grows = gst(t) + c * 16 * ld;
      // S^T = K Q^T and P^T: rows are keys, columns queries
      zero16(p);
      zero16(ds);
      mma_nt16<HD>(p, krows, qrows, lane);
      mma_nt16<HD>(ds, vrows, grows, lane);     // dP^T = V g^T
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = t * kKeyTile + c * 16 + n * 8 + 2 * t4 + (e & 1);
          const float pv =
              qi < seq
                  ? expf(__fmul_rn(p[n][e], scale) - s_max[qi]) / s_sum[qi]
                  : 0.0f;
          p[n][e] = pv;
          ds[n][e] = __fmul_rn(__fmul_rn(pv, __fsub_rn(ds[n][e], s_d[qi])),
                               scale);
        }
      mma_nn16<HD>(dv, p, grows, lane);         // dV += bf16(P^T) g
      mma_nn16<HD>(dk, ds, qrows, lane);        // dK += bf16(dS^T) Q
    }
    __syncthreads();                  // the stage may be refilled
  }
  __nv_bfloat16* out = dqkv + static_cast<size_t>(b) * seq * row3 + h * HD;
  store_acc<HD>(out + wa, row3, dk, k0 + warp * 16, seq, lane);
  store_acc<HD>(out + 2 * wa, row3, dv, k0 + warp * 16, seq, lane);
}

template <int HD>
int launch_attention_bwd_hd(const void* qkv, const void* gout, void* dqkv,
                            void* stats, int batch, int seq, int heads,
                            float scale, void* stream) {
  constexpr size_t rows_smem =
      static_cast<size_t>(2 * kBwdTile * row_ld<HD>() + ring_elems<HD>()) *
      sizeof(__nv_bfloat16);
  const size_t smem_dkv =
      rows_smem + 3 * static_cast<size_t>(bwd_stat_rows(seq)) * sizeof(float);
  if (smem_dkv > kMaxBlockSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBwdTile - 1) / kBwdTile, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_bwd_dq_kernel<HD><<<grid, kAttnWarps * 32, rows_smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(stats), seq,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<HD><<<grid, kAttnWarps * 32, smem_dkv, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<const float*>(stats),
      seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                         void* stats, int batch, int seq, int heads,
                         int head_dim, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (head_dim == 64)
    return launch_attention_bwd_hd<64>(qkv, gout, dqkv, stats, batch, seq,
                                       heads, scale, stream);
  if (head_dim == 128)
    return launch_attention_bwd_hd<128>(qkv, gout, dqkv, stats, batch, seq,
                                        heads, scale, stream);
  return cudaErrorInvalidValue;
}

template <int HD>
__global__ void __launch_bounds__(kGemmThreads)
    attn_out_i8_kernel(AttnOutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_out_tile<HD, kEpiResidual>(p, blockIdx.y, blockIdx.x * kOutQTile,
                                  smem);
}

template <int HD>
int launch_attn_out(const AttnOutArgs& p, int batch, void* stream) {
  const size_t smem = attn_out_smem<HD>(p.proj.K);
  if (smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_out_i8_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kOutQTile - 1) / kOutQTile, batch);
  attn_out_i8_kernel<HD><<<grid, kGemmThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

TPUDF_API int tpudf_attention_i8(const void* qkv, const void* key_bias,
                                 const void* act_scale, void* o8, int batch,
                                 int seq, int heads, int head_dim,
                                 float scale, void* stream) {
  return tpudf::launch_attention<true>(qkv, key_bias, act_scale, o8, batch,
                                       seq, heads, head_dim, scale, stream);
}

TPUDF_API int tpudf_attention_bf16(const void* qkv, const void* key_bias,
                                   void* out, int batch, int seq, int heads,
                                   int head_dim, float scale, void* stream) {
  return tpudf::launch_attention<false>(qkv, key_bias, nullptr, out, batch,
                                        seq, heads, head_dim, scale, stream);
}

TPUDF_API int tpudf_attention_bwd_bf16(const void* qkv, const void* gout,
                                       void* dqkv, void* stats, int batch,
                                       int seq, int heads, int head_dim,
                                       float scale, void* stream) {
  return tpudf::launch_attention_bwd(qkv, gout, dqkv, stats, batch, seq,
                                     heads, head_dim, scale, stream);
}

// K6: out (B*S, W) bf16 = bf16(x + (quant(attention(qkv)) . wt^T dequantised
// + bias)); qkv (B, S, 3 * heads * head_dim), wt (W, heads * head_dim);
// head_dim 64 or 128, S <= kMaxSeq, and the block's shared memory (the
// (128 x Wa) int8 tile beside Q and the K/V ring) within the 227 KB a
// block may have: Wa <= 1024 at head_dim 64, Wa <= 768 at 128
TPUDF_API int tpudf_attn_out_i8(const void* qkv, const void* x,
                                const void* wt, const void* col_scale,
                                const void* bias, const void* act, void* out,
                                int batch, int seq, int heads, int head_dim,
                                int width, float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  const int wa = heads * head_dim;
  if (seq > kMaxSeq || width % kBN != 0 || wa % kBK != 0 ||
      (head_dim != 64 && head_dim != 128))
    return cudaErrorInvalidValue;
  AttnOutArgs p{static_cast<const __nv_bfloat16*>(qkv),
                GemmArgs{nullptr, static_cast<const int8_t*>(wt),
                         static_cast<const float*>(col_scale),
                         static_cast<const float*>(bias),
                         static_cast<const float*>(act), x, out, nullptr,
                         nullptr, batch * seq, width, wa},
                seq, heads, scale};
  if (head_dim == 64) return launch_attn_out<64>(p, batch, stream);
  return launch_attn_out<128>(p, batch, stream);
}
