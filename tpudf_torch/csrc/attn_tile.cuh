// Device pieces of the fused-QKV attention, shared by K1's and K9's
// attention kernel (attention.cu), K6 (attention.cu) and K7's attention
// phase (layer_int8.cu).
//
// `attn_rows`: one warp's 16 query rows against one head's keys, both
// products on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulate):
// scores = (q . k) * scale in f32, + an optional per-key bias, p = e / sum(e)
// with e = exp(s - max) in f32 over the full row held in registers (exact,
// not online), p rounded to bf16 for p . v, o accumulated in f32.
//
// `attn_out_tile`: K6's work for 128 query rows of one image: for each head
// in turn, the head's K and V (S <= 256 rows) and the tile's Q go to shared
// memory, each of the 8 warps runs attn_rows on 16 rows, and the f32 o is
// quantised to int8 (not rounded to bf16 first: the TPU kernel's order)
// into a (128 x Wa) int8 tile in shared memory. The out-projection then
// runs over that tile with the GEMM tile of gemm_i8.cuh, the int8 weight
// streamed from L2 by cp.async through the space K and V took, and the
// epilogue (dequant + bias + residual) writes the rows of this image only.
// The attention output never reaches device memory.
#pragma once

#include "gemm_i8.cuh"

namespace tpudf {

constexpr int kHd = 64;                  // head_dim the kernels are built for
constexpr int kMaxSeq = 256;
constexpr int kRowLd = kHd + 8;          // padded smem row: 144 bytes
constexpr int kOutQTile = 128;           // K6's query rows: 8 warps x 16

// o[dt][e]: rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp's 16 query
// rows at `qrows` (shared, kRowLd apart), dims 8 dt + 2t + (e & 1), against
// the seq keys of `ks` / `vs` (shared, zero-padded to a multiple of 16
// rows); key_bias: the image's (seq,) f32 per-key bias, or null.
// kSeqCap: the most keys a score row holds (64 or kMaxSeq).
template <int kSeqCap>
__device__ __forceinline__ void attn_rows(float (&o)[kHd / 8][4],
                                          const __nv_bfloat16* qrows,
                                          const __nv_bfloat16* ks,
                                          const __nv_bfloat16* vs, int seq,
                                          const float* key_bias, float scale,
                                          int lane) {
  const int t = lane & 3;
  const int seq_pad = (seq + 15) & ~15;
  const int ntiles = seq_pad / 8;           // even
  constexpr int kKeyTiles = kSeqCap / 8;    // n8 tiles of keys in a row

  // ---- scores: the warp's 16 rows x seq_pad keys, in registers
  unsigned qf[kHd / 16][4];
#pragma unroll
  for (int kc = 0; kc < kHd / 16; ++kc)
    ldsm_x4(qf[kc], qrows + (lane & 15) * kRowLd + kc * 16 + (lane >> 4) * 8);
  float sc[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; j += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = sc[j + 1][e] = 0.0f;
    if (j < ntiles) {
      // K rows are the n index: matrices (keys j8..+7 | +8..+15) x
      // (dims kc16..+7 | +8..+15) give b0, b1 of key tiles j and j+1
      const __nv_bfloat16* kr =
          ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * kRowLd +
          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < kHd / 16; ++kc) {
        unsigned r[4];
        ldsm_x4(r, kr + kc * 16);
        mma_bf16(sc[j], qf[kc], r[0], r[1]);
        mma_bf16(sc[j + 1], qf[kc], r[2], r[3]);
      }
    }
  }

  // ---- softmax over each row: thread holds rows g (e = 0, 1) and g + 8
  // (e = 2, 3) at keys 8j + 2t + (e & 1); a row lives in 4 lanes
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    if (j < ntiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        float s = neg_inf;
        if (key < seq) {
          s = __fmul_rn(sc[j][e], scale);
          if (key_bias != nullptr) s = __fadd_rn(s, key_bias[key]);
        }
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    if (j < ntiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = expf(sc[j][e] - mx[e >> 1]);   // masked: exp(-inf)
        sc[j][e] = ex;
        sum[e >> 1] += ex;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // ---- o = p . v: p = e / sum rounded to bf16 is the A fragment; V rows
  // are the k index, ldmatrix.trans gives b0, b1 of two 8-dim tiles
#pragma unroll
  for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < kKeyTiles / 2; ++kc) {
    if (2 * kc < ntiles) {
      unsigned a[4];
      a[0] = pack_bf16x2(sc[2 * kc][0] / sum[0], sc[2 * kc][1] / sum[0]);
      a[1] = pack_bf16x2(sc[2 * kc][2] / sum[1], sc[2 * kc][3] / sum[1]);
      a[2] = pack_bf16x2(sc[2 * kc + 1][0] / sum[0],
                         sc[2 * kc + 1][1] / sum[0]);
      a[3] = pack_bf16x2(sc[2 * kc + 1][2] / sum[1],
                         sc[2 * kc + 1][3] / sum[1]);
      const __nv_bfloat16* vr =
          vs + (kc * 16 + (lane & 15)) * kRowLd + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < kHd / 16; ++dn) {
        unsigned r[4];
        ldsm_x4_trans(r, vr + dn * 16);
        mma_bf16(o[2 * dn], a, r[0], r[1]);
        mma_bf16(o[2 * dn + 1], a, r[2], r[3]);
      }
    }
  }
}

// `n` rows of 64 bf16 from row r0 of a row-major matrix (rows `ld` apart)
// into shared rows of kRowLd, zero past seq; all threads of the block
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld,
                                          int r0, int n, int seq) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 v = zero;
    if (r0 + r < seq)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kRowLd + c) = v;
  }
}

struct AttnOutArgs {
  const __nv_bfloat16* qkv;   // (B, S, 3 Wa) bf16, [q | k | v]
  GemmArgs proj;              // the out-projection: bt (W, Wa) int8, its
                              // scales and bias, act = the o scale,
                              // residual (B*S, W), out; M = B*S, N = W,
                              // K = Wa (proj.a unused)
  int seq, heads;
  float scale;
};

// shared bytes of attn_out_tile: K, V (seq_pad rows) and Q (128 rows) of a
// head, then the (128 x Wa) int8 o tile
__host__ __device__ __forceinline__ size_t attn_out_smem(int seq, int wa) {
  const int seq_pad = (seq + 15) & ~15;
  return static_cast<size_t>(2 * seq_pad + kOutQTile) * kRowLd *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(kOutQTile) * (wa + 16);
}

// K6's work for query rows q0 .. q0 + 127 of image b (256 threads)
template <int kSeqCap, int MODE>
__device__ __forceinline__ void attn_out_tile(const AttnOutArgs& p, int b,
                                              int q0, unsigned char* smem) {
  const TileThread q = tile_thread();
  const int seq = p.seq, seq_pad = (seq + 15) & ~15;
  const int wa = p.heads * kHd, ldo = wa + 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + seq_pad * kRowLd;
  __nv_bfloat16* qs = vs + seq_pad * kRowLd;
  int8_t* o8 = reinterpret_cast<int8_t*>(qs + kOutQTile * kRowLd);
  const float inv = 127.0f / p.proj.act[0];
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base = p.qkv + static_cast<size_t>(b) * seq * row3;
  const int r0 = q.warp * 16;

  for (int h = 0; h < p.heads; ++h) {
    __syncthreads();                    // the last head's reads are done
    load_rows(ks, base + wa + h * kHd, row3, 0, seq_pad, seq);
    load_rows(vs, base + 2 * wa + h * kHd, row3, 0, seq_pad, seq);
    load_rows(qs, base + h * kHd, row3, q0, kOutQTile, seq);
    __syncthreads();
    // rows past seq hold zero queries: finite, never stored
    float o[kHd / 8][4];
    attn_rows<kSeqCap>(o, qs + r0 * kRowLd, ks, vs, seq, nullptr, p.scale,
                       q.lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int8_t* dst = o8 + (r0 + q.g + 8 * r) * ldo + h * kHd + 2 * q.t;
#pragma unroll
      for (int dt = 0; dt < kHd / 8; ++dt) {
        char2 c;
        c.x = quant_i8(o[dt][2 * r], inv);
        c.y = quant_i8(o[dt][2 * r + 1], inv);
        *reinterpret_cast<char2*>(dst + dt * 8) = c;
      }
    }
  }
  __syncthreads();                      // o8 complete; K, V, Q space free

  int8_t* bs = reinterpret_cast<int8_t*>(smem);
  const int m0 = b * seq + q0;
  const int m_end = b * seq + min(seq, q0 + kOutQTile);
  for (int n0 = 0; n0 < p.proj.N; n0 += kBN) {
    int acc[4][4][4];
    zero_acc(acc);
    first_b_stage(bs, p.proj, n0, q);
    mma_panel(acc, o8, ldo, bs, p.proj, n0, q);
    gemm_epilogue<MODE>(acc, p.proj, m0, m_end, n0, q);
  }
}

}  // namespace tpudf
