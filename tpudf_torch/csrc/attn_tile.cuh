// Device pieces of the fused-QKV attention on mma.sync, shared by K6
// (attention.cu) and K7's attention phase (layer_int8.cu); 9b and 17
// (attention_i8.cu) take the key tile and the online row statistics. (K1's
// attention, K9 and K10 run on wgmma and TMA: attention_sm90.cu.)
//
// `attn_stream`: each warp's 16 query rows (A fragments in registers)
// against one head's keys, the keys streamed through shared memory in
// tiles of kKeyTile rows (a two-stage cp.async ring: the next tile is in
// flight while the current one is multiplied), both products on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulate), in TWO passes
// over the keys:
//   pass 1 (K tiles)     s = (q . k) * scale in f32 (+ an optional
//                        per-key bias), the row max m and the row sum
//                        l = sum exp(s - m) (kept online: l is rescaled
//                        when m grows);
//   pass 2 (K, V tiles)  s again, p = exp(s - m) / l in f32, rounded to
//                        bf16 for p . v, o accumulated in f32.
// That is the TPU kernel's function: an exact softmax, not an online
// one, with p rounded where the TPU kernel rounds it. A full score row
// no longer has to fit a warp's registers (16 x 1024 f32 would be 64 KB a
// warp), so S goes to kMaxSeq (common.cuh); the price is a second sweep
// of QK^T.
// head_dim is a template parameter (16, 32, 64, 256, or 128 for so400m's
// heads of 72 padded by prepad_siglip_static); the softmax scale is an
// argument and is never derived from it. HV <= HD: the
// columns of o (and of V) one stream computes. At head_dim 256 a warp
// holding all of o (128 f32) beside its Q fragments (64) and scores (32)
// would spill, so the callers split the head's columns into two slices of
// 128 and run the stream once per slice: the full 256-deep scores each
// time (`out_hv`).
//
// `attn_out_tile`: K6's work for 128 query rows of one image: for each
// head in turn, the tile's Q goes to shared memory and each of the 8 warps
// runs attn_stream on 16 rows; the f32 o is quantised to int8 (not rounded
// to bf16 first: the TPU kernel's order) into a (128 x Wa) int8 tile in
// shared memory. The out-projection then runs over that tile with the
// GEMM tile of gemm_i8.cuh, the int8 weight streamed from L2 by cp.async
// through the space Q and the K/V ring took, and the epilogue (dequant +
// bias + residual) writes the rows of this image only. The attention
// output never reaches device memory.
#pragma once

#include "gemm_i8.cuh"

namespace tpudf {

constexpr int kKeyTile = 64;           // keys a stage of the K/V ring holds
constexpr int kOutQTile = 128;         // K6's query rows: 8 warps x 16

// bf16 elements of a shared row of HD: padded by 16 bytes, so that
// ldmatrix's eight row addresses hit distinct banks
template <int HD>
__host__ __device__ constexpr int row_ld() {
  return HD + 8;
}

// bf16 elements of the K/V ring: two stages of K (HD wide), two of V (HV
// wide)
template <int HD, int HV = HD>
__host__ __device__ constexpr int ring_elems() {
  return 2 * kKeyTile * (row_ld<HD>() + row_ld<HV>());
}

// the columns of o one attention stream computes at head_dim HD
template <int HD>
__host__ __device__ constexpr int out_hv() {
  return HD > 128 ? 128 : HD;
}

// `n` rows of HD bf16 from row r0 of a row-major matrix (rows `ld` apart)
// into shared rows of row_ld<HD>(), zero past seq; all threads of the
// block, plain loads
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t ld,
                                          int r0, int n, int seq) {
  constexpr int kChunks = HD / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = zero;
    if (r0 + r < seq)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * row_ld<HD>() + c) = v;
  }
}

// kKeyTile rows of HD bf16 from row r0 into a ring stage by cp.async; rows
// past seq repeat row seq - 1 (finite: their scores are masked to -inf and
// their p is 0); all threads of the block, not committed
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t ld, int r0, int seq) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int sr = min(r0 + r, seq - 1);
    cp_async16(dst + r * row_ld<HD>() + c,
               src + static_cast<size_t>(sr) * ld + c);
  }
}

// One warp's state: its 16 query rows as A fragments, the f32 output
// o[dt][e] (rows g (e = 0, 1) and g + 8 (e = 2, 3), dims 8 dt + 2t +
// (e & 1) of the stream's HV columns), and per row the max and the sum of
// exp(s - max)
template <int HD, int HV = HD>
struct AttnWarp {
  unsigned qf[HD / 16][4];
  float o[HV / 8][4];
  float mx[2], sum[2];
};

// the A fragments of the warp's 16 shared query rows at `qrows`
template <int HD, int HV>
__device__ __forceinline__ void load_q(AttnWarp<HD, HV>& w,
                                       const __nv_bfloat16* qrows, int lane) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    ldsm_x4(w.qf[kc], qrows + (lane & 15) * row_ld<HD>() + kc * 16 +
                          (lane >> 4) * 8);
}

// s[j][e]: rows g (e = 0, 1) and g + 8 (e = 2, 3) against keys
// k0 + 8j + 2t + (e & 1) of the shared tile `ks`: (q . k) * scale + bias
// in f32, -inf past seq
template <int HD, int HV>
__device__ __forceinline__ void tile_scores(float (&s)[kKeyTile / 8][4],
                                            const AttnWarp<HD, HV>& w,
                                            const __nv_bfloat16* ks, int k0,
                                            int seq, const float* key_bias,
                                            float scale, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; j += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = 0.0f;
    // K rows are the n index: matrices (keys 8j..+7 | +8..+15) x (dims
    // 16kc..+7 | +8..+15) give b0, b1 of key tiles j and j + 1
    const __nv_bfloat16* kr =
        ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * row_ld<HD>() +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      unsigned r[4];
      ldsm_x4(r, kr + kc * 16);
      mma_bf16(s[j], w.qf[kc], r[0], r[1]);
      mma_bf16(s[j + 1], w.qf[kc], r[2], r[3]);
    }
  }
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      float v = neg_inf;
      if (key < seq) {
        v = __fmul_rn(s[j][e], scale);
        if (key_bias != nullptr) v = __fadd_rn(v, key_bias[key]);
      }
      s[j][e] = v;
    }
}

// pass 1 on one tile: the row max over the quad's lanes, the thread's part
// of the row sum rescaled to it (the quad shares each row's max, so the
// four parts add up at the end)
__device__ __forceinline__ void online_stats(
    const float (&s)[kKeyTile / 8][4], float (&mx)[2], float (&sum)[2]) {
  float tm[2] = {mx[0], mx[1]};
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tm[e >> 1] = fmaxf(tm[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = quad_max(tm[r]);
    if (tm[r] != mx[r]) sum[r] *= expf(mx[r] - tm[r]);
    mx[r] = tm[r];
  }
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[j][e] - mx[e >> 1]);
}

// pass 2 on one tile: o += bf16(exp(s - m) / l) . v for the shared V tile
// `vs` (HV columns, rows row_ld<HV>() apart); the score accumulators of two
// key tiles, once rounded, are the A fragment (no trip through shared
// memory), V rows the k index (ldmatrix.trans gives b0, b1 of two 8-dim
// tiles)
template <int HD, int HV>
__device__ __forceinline__ void tile_pv(AttnWarp<HD, HV>& w,
                                        const float (&s)[kKeyTile / 8][4],
                                        const __nv_bfloat16* vs, int lane) {
#pragma unroll
  for (int kc = 0; kc < kKeyTile / 16; ++kc) {
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = expf(s[2 * kc + n][e] - w.mx[e >> 1]) / w.sum[e >> 1];
    unsigned a[4];
    a[0] = pack_bf16x2(p[0][0], p[0][1]);
    a[1] = pack_bf16x2(p[0][2], p[0][3]);
    a[2] = pack_bf16x2(p[1][0], p[1][1]);
    a[3] = pack_bf16x2(p[1][2], p[1][3]);
    const __nv_bfloat16* vr =
        vs + (kc * 16 + (lane & 15)) * row_ld<HV>() + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < HV / 16; ++dn) {
      unsigned r[4];
      ldsm_x4_trans(r, vr + dn * 16);
      mma_bf16(w.o[2 * dn], a, r[0], r[1]);
      mma_bf16(w.o[2 * dn + 1], a, r[2], r[3]);
    }
  }
}

// The attention of every warp's 16 query rows (w.qf) against keys
// [0, seq) of one head: K rows at kg and V rows at vg (the HV columns of
// this stream) in device memory, `ld` elements apart, streamed through
// the ring at `ring` (ring_elems<HD, HV>() shared bf16); key_bias: the
// image's (seq,) f32 per-key bias, or null. Leaves w.o, w.mx and w.sum
// (the full row sums). Every thread of the block calls it (it holds
// barriers); the caller's own shared reads must be done before, as the
// ring's first stages are issued at once.
template <int HD, int HV = HD>
__device__ __forceinline__ void attn_stream(AttnWarp<HD, HV>& w,
                                            const __nv_bfloat16* kg,
                                            const __nv_bfloat16* vg,
                                            size_t ld, int seq,
                                            const float* key_bias,
                                            float scale,
                                            __nv_bfloat16* ring, int lane) {
  constexpr int kTile = kKeyTile * row_ld<HD>();
  constexpr int kTileV = kKeyTile * row_ld<HV>();
  // stage i of K at ring + i kTile, of V at ring + 2 kTile + i kTileV
  auto kst = [&](int t) { return ring + (t & 1) * kTile; };
  auto vst = [&](int t) { return ring + 2 * kTile + (t & 1) * kTileV; };
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  w.mx[0] = w.mx[1] = neg_inf;
  w.sum[0] = w.sum[1] = 0.0f;
  float s[kKeyTile / 8][4];

  // ---- pass 1: row max and row sum over the K tiles
  stage_rows<HD>(kst(0), kg, ld, 0, seq);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      stage_rows<HD>(kst(t + 1), kg, ld, (t + 1) * kKeyTile, seq);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile_scores<HD>(s, w, kst(t), t * kKeyTile, seq, key_bias, scale,
                    lane);
    online_stats(s, w.mx, w.sum);
    __syncthreads();                  // the stage may be refilled
  }
  w.sum[0] = quad_sum(w.sum[0]);
  w.sum[1] = quad_sum(w.sum[1]);

  // ---- pass 2: p = exp(s - m) / l, o += bf16(p) . v over K and V tiles
#pragma unroll
  for (int dt = 0; dt < HV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[dt][e] = 0.0f;
  stage_rows<HD>(kst(0), kg, ld, 0, seq);
  stage_rows<HV>(vst(0), vg, ld, 0, seq);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_rows<HD>(kst(t + 1), kg, ld, (t + 1) * kKeyTile, seq);
      stage_rows<HV>(vst(t + 1), vg, ld, (t + 1) * kKeyTile, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    tile_scores<HD>(s, w, kst(t), t * kKeyTile, seq, key_bias, scale,
                    lane);
    tile_pv(w, s, vst(t), lane);
    __syncthreads();
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

// bf16 elements before K6's int8 o tile: the Q tile (128 rows) and the
// K/V ring; at head_dim 256 they share their space (each warp has its Q
// fragments in registers before the ring is filled), so that Wa = 768
// fits; at least the out-projection's two weight stages (2 kStageBytes
// bytes), which stream through the same space
template <int HD>
__host__ __device__ constexpr int attn_out_front() {
  constexpr int q = kOutQTile * row_ld<HD>();
  constexpr int ring = ring_elems<HD, out_hv<HD>()>();
  constexpr int front = HD > 128 ? (q > ring ? q : ring) : q + ring;
  return front > kStageBytes ? front : kStageBytes;
}

// shared bytes of attn_out_tile: the front (Q and the ring), then the
// (128 x Wa) int8 o tile; independent of S
template <int HD>
__host__ __device__ constexpr size_t attn_out_smem(int wa) {
  return static_cast<size_t>(attn_out_front<HD>()) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(kOutQTile) * (wa + 16);
}

// K6's work for query rows q0 .. q0 + 127 of image b (256 threads)
template <int HD, int MODE>
__device__ __forceinline__ void attn_out_tile(const AttnOutArgs& p, int b,
                                              int q0, unsigned char* smem) {
  constexpr int HV = out_hv<HD>();
  constexpr bool kShared = HD > 128;         // Q and the ring overlap
  const TileThread q = tile_thread();
  const int seq = p.seq;
  const int wa = p.heads * HD, ldo = wa + 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = kShared ? qs : qs + kOutQTile * row_ld<HD>();
  int8_t* o8 = reinterpret_cast<int8_t*>(qs + attn_out_front<HD>());
  const float inv = 127.0f / p.proj.act[0];
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base = p.qkv + static_cast<size_t>(b) * seq * row3;
  const int r0 = q.warp * 16;

  for (int h = 0; h < p.heads; ++h) {
    __syncthreads();                    // the last head's reads are done
    load_rows<HD>(qs, base + h * HD, row3, q0, kOutQTile, seq);
    __syncthreads();
    // rows past seq hold zero queries: finite, never stored
    AttnWarp<HD, HV> w;
    load_q<HD>(w, qs + r0 * row_ld<HD>(), q.lane);
    if (kShared) __syncthreads();       // every warp's Q read: the ring may
    for (int sl = 0; sl < HD / HV; ++sl) {       // overwrite it
      attn_stream<HD, HV>(w, base + wa + h * HD,
                              base + 2 * wa + h * HD + sl * HV, row3, seq,
                              nullptr, p.scale, ring, q.lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int8_t* dst =
            o8 + (r0 + q.g + 8 * r) * ldo + h * HD + sl * HV + 2 * q.t;
#pragma unroll
        for (int dt = 0; dt < HV / 8; ++dt) {
          char2 c;
          c.x = quant_i8(w.o[dt][2 * r], inv);
          c.y = quant_i8(w.o[dt][2 * r + 1], inv);
          *reinterpret_cast<char2*>(dst + dt * 8) = c;
        }
      }
    }
  }
  __syncthreads();                      // o8 complete; Q and ring free

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
