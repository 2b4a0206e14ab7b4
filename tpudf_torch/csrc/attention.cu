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
// The TPU kernel held one head's whole (S, S) f32 P in VMEM; at S = 256
// that is 256 KB, more than an SM's shared memory, and dK, dV sum over
// every query row. So the work is split as FlashAttention-2 splits it,
// into two launches over (64-row tile, head, image) blocks of four warps
// of 16 rows, each recomputing the scores it needs on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulate) instead of storing P:
//   dq pass   (query tiles): K and V of the head in shared memory; per warp
//             four sweeps over the keys: the row max, the row sum of
//             exp(s - max), D, then dS and dQ += bf16(dS) K. It writes dQ
//             and the rows' max, sum and D (f32 scratch, 12 bytes a row).
//   dkv pass  (key tiles): Q and g of the head in shared memory; per warp
//             one sweep over the queries in chunks of 16: S^T = K Q^T,
//             P^T from the saved max and sum, dV += bf16(P^T) g,
//             dP^T = V g^T, dS^T, dK += bf16(dS^T) Q.
// The scores and products never touch device memory; each pass reads qkv
// and g of its head once per tile from L2. The card's bound at the MTL
// step's shape (16, 256, 2304) is the bytes of qkv, g and dqkv.

constexpr int kHd = 64;                  // K10's head_dim
constexpr int kBwdSeq = 256;             // K10's longest sequence
constexpr int kRowLd = row_ld<kHd>();

// A fragments (16 rows x 64 dims) of shared rows r0.. (ldmatrix)
__device__ __forceinline__ void load_a_rows(unsigned (&f)[kHd / 16][4],
                                            const __nv_bfloat16* rows,
                                            int lane) {
#pragma unroll
  for (int kc = 0; kc < kHd / 16; ++kc)
    ldsm_x4(f[kc], rows + (lane & 15) * kRowLd + kc * 16 + (lane >> 4) * 8);
}

// c[n] += A (16 x 64) . R^T for the 16 shared rows R at `rows` (the n index
// of two n8 tiles, dims as k): scores against keys, or dP against V
__device__ __forceinline__ void mma_rows_nt(float (&c)[2][4],
                                            const unsigned (&a)[kHd / 16][4],
                                            const __nv_bfloat16* rows,
                                            int lane) {
  const __nv_bfloat16* r =
      rows + ((lane & 7) + (lane >> 4) * 8) * kRowLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < kHd / 16; ++kc) {
    unsigned b[4];
    ldsm_x4(b, r + kc * 16);
    mma_bf16(c[0], a[kc], b[0], b[1]);
    mma_bf16(c[1], a[kc], b[2], b[3]);
  }
}

// acc (16 x 64) += A (16 x 16, the bf16 pack of c) . R for the 16 shared
// rows R at `rows` (the k index, dims as n; ldmatrix.trans)
__device__ __forceinline__ void mma_rows_nn(float (&acc)[kHd / 8][4],
                                            const float (&c)[2][4],
                                            const __nv_bfloat16* rows,
                                            int lane) {
  unsigned a[4];
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
  const __nv_bfloat16* r = rows + (lane & 15) * kRowLd + (lane >> 4) * 8;
#pragma unroll
  for (int dn = 0; dn < kHd / 16; ++dn) {
    unsigned b[4];
    ldsm_x4_trans(b, r + dn * 16);
    mma_bf16(acc[2 * dn], a, b[0], b[1]);
    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kHd / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
}

// bf16 rows of a 16 x 64 accumulator: tile rows row0 + g (e = 0, 1) and
// + 8 (e = 2, 3), each row `ld` apart, those < seq only
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, size_t ld,
                                          const float (&acc)[kHd / 8][4],
                                          int row0, int seq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + row * ld + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// stats: (3, B, H, S) f32 — row max, row sum of exp(s - max), D
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const __nv_bfloat16* __restrict__ gout,
                            __nv_bfloat16* __restrict__ dqkv,
                            float* __restrict__ stats, int seq, int heads,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seq_pad = (seq + 15) & ~15;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + seq_pad * kRowLd;
  __nv_bfloat16* qs = vs + seq_pad * kRowLd;
  __nv_bfloat16* gs = qs + kQTile * kRowLd;
  const int wa = heads * kHd;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * kHd;
  load_rows<kHd>(ks, base + wa, row3, 0, seq_pad, seq);
  load_rows<kHd>(vs, base + 2 * wa, row3, 0, seq_pad, seq);
  load_rows<kHd>(qs, base, row3, q0, kQTile, seq);
  load_rows<kHd>(gs, gout + static_cast<size_t>(b) * seq * wa + h * kHd, wa,
                 q0, kQTile, seq);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (q0 + r0 >= seq) return;               // no more barriers below
  const int t = lane & 3;
  unsigned qf[kHd / 16][4], gf[kHd / 16][4];
  load_a_rows(qf, qs + r0 * kRowLd, lane);
  load_a_rows(gf, gs + r0 * kRowLd, lane);
  const float neg_inf = __int_as_float(0xff800000);

  // scaled scores of keys 16 kc .. + 15, -inf past seq
  auto scores = [&](int kc, float (&s)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    mma_rows_nt(s, qf, ks + kc * 16 * kRowLd, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kc * 16 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < seq ? __fmul_rn(s[n][e], scale) : neg_inf;
      }
  };
  const int nk = seq_pad / 16;
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float dsum[2] = {0.0f, 0.0f};
  float s[2][4], dp[2][4];
  for (int kc = 0; kc < nk; ++kc) {
    scores(kc, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  for (int kc = 0; kc < nk; ++kc) {
    scores(kc, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[n][e] - mx[e >> 1]);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  // p = exp(s - max) / sum, as the forward computes it
  for (int kc = 0; kc < nk; ++kc) {
    scores(kc, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.0f;
    mma_rows_nt(dp, gf, vs + kc * 16 * kRowLd, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsum[e >> 1] += __fmul_rn(dp[n][e],
                                  expf(s[n][e] - mx[e >> 1]) / sum[e >> 1]);
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);
  float dq[kHd / 8][4];
  zero_acc(dq);
  for (int kc = 0; kc < nk; ++kc) {
    scores(kc, s);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.0f;
    mma_rows_nt(dp, gf, vs + kc * 16 * kRowLd, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[n][e] - mx[r]) / sum[r];
        s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], dsum[r])),
                            scale);
      }
    mma_rows_nn(dq, s, ks + kc * 16 * kRowLd, lane);
  }
  store_acc(dqkv + static_cast<size_t>(b) * seq * row3 + h * kHd, row3, dq,
            q0 + r0, seq, lane);
  if (t == 0) {
    const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * seq;
    const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + (lane >> 2) + 8 * r;
      if (qi >= seq) continue;
      stats[head_row + qi] = mx[r];
      stats[n_rows + head_row + qi] = sum[r];
      stats[2 * n_rows + head_row + qi] = dsum[r];
    }
  }
}

__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ gout,
                             __nv_bfloat16* __restrict__ dqkv,
                             const float* __restrict__ stats, int seq,
                             int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seq_pad = (seq + 15) & ~15;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = qs + seq_pad * kRowLd;
  __nv_bfloat16* ks = gs + seq_pad * kRowLd;
  __nv_bfloat16* vs = ks + kQTile * kRowLd;
  float* s_max = reinterpret_cast<float*>(vs + kQTile * kRowLd);
  float* s_sum = s_max + seq_pad;
  float* s_d = s_sum + seq_pad;
  const int wa = heads * kHd;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kQTile;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * kHd;
  load_rows<kHd>(qs, base, row3, 0, seq_pad, seq);
  load_rows<kHd>(gs, gout + static_cast<size_t>(b) * seq * wa + h * kHd, wa,
                 0, seq_pad, seq);
  load_rows<kHd>(ks, base + wa, row3, k0, kQTile, seq);
  load_rows<kHd>(vs, base + 2 * wa, row3, k0, kQTile, seq);
  const size_t n_rows = static_cast<size_t>(gridDim.z) * heads * seq;
  const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
  for (int i = threadIdx.x; i < seq_pad; i += blockDim.x) {
    const bool in = i < seq;
    s_max[i] = in ? stats[head_row + i] : 0.0f;
    s_sum[i] = in ? stats[n_rows + head_row + i] : 1.0f;
    s_d[i] = in ? stats[2 * n_rows + head_row + i] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;                 // this warp's first key
  if (k0 + r0 >= seq) return;
  const int t = lane & 3;
  unsigned kf[kHd / 16][4], vf[kHd / 16][4];
  load_a_rows(kf, ks + r0 * kRowLd, lane);
  load_a_rows(vf, vs + r0 * kRowLd, lane);
  float dk[kHd / 8][4], dv[kHd / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  float p[2][4], ds[2][4];
  for (int qc = 0; qc < seq_pad / 16; ++qc) {
    const __nv_bfloat16* qrows = qs + qc * 16 * kRowLd;
    const __nv_bfloat16* grows = gs + qc * 16 * kRowLd;
    // S^T = K Q^T and P^T: rows are keys, columns queries
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.0f;
    mma_rows_nt(p, kf, qrows, lane);
    mma_rows_nt(ds, vf, grows, lane);       // dP^T = V g^T
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qc * 16 + n * 8 + 2 * t + (e & 1);
        const float pv =
            qi < seq ? expf(__fmul_rn(p[n][e], scale) - s_max[qi]) / s_sum[qi]
                     : 0.0f;
        p[n][e] = pv;
        ds[n][e] = __fmul_rn(__fmul_rn(pv, __fsub_rn(ds[n][e], s_d[qi])),
                             scale);
      }
    mma_rows_nn(dv, p, grows, lane);        // dV += bf16(P^T) g
    mma_rows_nn(dk, ds, qrows, lane);       // dK += bf16(dS^T) Q
  }
  __nv_bfloat16* out = dqkv + static_cast<size_t>(b) * seq * row3 + h * kHd;
  store_acc(out + wa, row3, dk, k0 + r0, seq, lane);
  store_acc(out + 2 * wa, row3, dv, k0 + r0, seq, lane);
}

int launch_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                         void* stats, int batch, int seq, int heads,
                         int head_dim, float scale, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (head_dim != kHd || seq > kBwdSeq) return cudaErrorInvalidValue;
  const int seq_pad = (seq + 15) & ~15;
  const size_t rows_smem = static_cast<size_t>(2 * seq_pad + 2 * kQTile) *
                           kRowLd * sizeof(__nv_bfloat16);
  const size_t smem_dq = rows_smem;
  const size_t smem_dkv = rows_smem + 3 * seq_pad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_bwd_dq_kernel<<<grid, kAttnWarps * 32, smem_dq, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(stats), seq,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<<<grid, kAttnWarps * 32, smem_dkv, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<const float*>(stats),
      seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
__global__ void __launch_bounds__(kGemmThreads)
    attn_out_i8_kernel(AttnOutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_out_tile<HD, kEpiResidual>(p, blockIdx.y, blockIdx.x * kOutQTile,
                                  smem);
}

// the most dynamic shared memory a block may have on sm_90
constexpr size_t kMaxBlockSmem = 232448;

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
