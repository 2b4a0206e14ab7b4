// Kernel 9b: the fused-QKV attention with dynamically quantised int8
// products, replacing tpudf/ops/attention.py `_attention_qkv_pallas` with
// int8_attn=True (`_one_head`, lines 209-246), which the static-W8A8
// block's reference route runs under TPUDF_INT8_ATTN=1 (int8_block.py
// `_attn_out_reference`). Per image and head, the TPU kernel's function:
//   aq = amax|q| + 1e-6 over the head's rows of one query block of
//        qb = min(256, S) rows (the Pallas grid's q block; the q axis is
//        zero-padded to a multiple of qb), ak, av = amax|k|, amax|v| + 1e-6
//        over all S rows;
//   q8 = clip(round(q * (127 / aq)), +-127), k8 and v8 likewise;
//   s = int32(q8 . k8) * ((aq * ak) / (127 * 127) * scale) in f32;
//   p = e / sum(e), e = exp(s - max) in f32 (an exact softmax);
//   ap = max p + 1e-20 per row (= 1 / l, as the row's largest e is 1);
//   p8 = round(p * (127 / ap)), not clipped (p <= ap);
//   o = int32(p8 . v8) * (ap * (av / (127 * 127))), rounded to bf16.
//
// Two launches. The amax pass: one block per (head, image) reduces |q|
// over each query block and |k|, |v| over the sequence into a (B, H,
// nqb + 2) f32 table (exact: a max does not depend on its order). The
// main pass: one block per (64-query tile, head, image), four warps of 16
// rows; qb is 256 or S, so a tile never straddles two query blocks. The
// tile's q is quantised into shared memory once; the head's K and V are
// quantised tile by tile (64 keys) into shared memory as they stream in,
// in two passes over the keys as in attn_tile.cuh: the first for each
// row's max and sum, the second for p8 and p8 . v8. Both products run on
// the tensor cores as int8 mma.sync m16n8k32 with exact int32 sums (p8 .
// v8 at most 127 * 127 * S, under 2^31 for S <= kMaxSeq), each rounded
// once to f32, as JAX converts its int32 dot (past S = 1040 that
// rounding can lose bits). The
// p8 fragment is built in registers from the score accumulators: the
// product sums over keys, so the keys may go in any order that A and B
// share, and V is stored transposed with its keys in the order in which
// a thread holds its scores (`vt_pos`). Bound at the reference route's
// (8, 1024, 6144): the bytes of qkv and the output. Head_dim 64, 128 or
// 256 (16 and 32 arrive zero-padded to 64: the padded columns quantise to
// 0 and add nothing); at 256 one block per 128-column slice of the head's
// o (its int32 o would be 128 registers a thread beside 32 of q8
// fragments and 64 of scores and codes), each computing the full
// 256-deep scores, its V codes 10 KB of the 44 KB of static shared memory.
//
// Kernel 17: the same main pass with static scales, replacing
// scripts/micro_attn_static.py's `kernel` (`static_variant` -> `build` ->
// `fn`, `_one_head` at lines 40-59), a probe of whether fixed per-tensor
// scales aq = ak = av (3.0 there) beat the amax pass. One launch, no amax
// table: the five constants 127 / aq, 127 / ak, 127 / av,
// (aq * ak) / 127^2 * scale and av / 127^2 come in as arguments, computed
// by the caller in double and rounded once to f32, as JAX rounds the probe's
// Python-float constants. The probe runs only at head_dim 128 (its
// pl.multiple_of(h * d, 128) slice), so only that width is built. Bound at
// its (8, 1024, 6144): the bytes of qkv and the output.
#include "attn_tile.cuh"

namespace tpudf {

constexpr int kI8QTile = 64;            // query rows per block: 4 warps
constexpr int kI8Warps = 4;
constexpr int kVtLd = kKeyTile + 16;    // bytes of a transposed V row

// the main pass's f32 constants: 127 / aq, 127 / ak, 127 / av, the score
// factor (aq * ak) / 127^2 * scale and av / 127^2 (kernel 17 passes them;
// 9b derives them from the amax table)
struct I8AttnScales {
  float inv_q, inv_k, inv_v, fac, cv;
};

// bytes of a q8 / k8 row in shared memory (16 bytes of padding keep the
// lds32 of 8 rows x 4 lanes on distinct banks)
template <int HD>
__host__ __device__ constexpr int i8_ld() {
  return HD + 16;
}

__global__ void __launch_bounds__(256)
    attention_i8_amax_kernel(const __nv_bfloat16* __restrict__ qkv,
                             float* __restrict__ amax, int seq, int heads,
                             int head_dim, int qb) {
  __shared__ float red[8];
  const int h = blockIdx.x, b = blockIdx.y;
  const int wa = heads * head_dim, chunks = head_dim / 8;
  const int nqb = (seq + qb - 1) / qb;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * head_dim;
  float* out = amax + (static_cast<size_t>(b) * heads + h) * (nqb + 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int seg = 0; seg < nqb + 2; ++seg) {
    const int col = seg < nqb ? 0 : (seg == nqb ? wa : 2 * wa);
    const int r0 = seg < nqb ? seg * qb : 0;
    const int r1 = seg < nqb ? min(seq, r0 + qb) : seq;
    float m = 0.0f;
    for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x) {
      float f[8];
      load8(base + static_cast<size_t>(r0 + i / chunks) * row3 + col +
                (i % chunks) * 8,
            f);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
    }
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_max(lane < 8 ? red[lane] : 0.0f);
      if (lane == 0) out[seg] = __fadd_rn(m, 1e-6f);
    }
    __syncthreads();
  }
}

// the position of key x (0..63 of a tile) in a transposed V row: keys
// 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16 go to 4t .. 4t + 3, the bytes lane
// t's A fragment holds for them
__device__ __forceinline__ int vt_pos(int x) {
  const int y = x & 15;
  return (x & ~15) + 4 * ((y & 7) >> 1) + 2 * (y >> 3) + (y & 1);
}

__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<unsigned>(a) & 0xffu) |
         ((static_cast<unsigned>(b) & 0xffu) << 8) |
         ((static_cast<unsigned>(c) & 0xffu) << 16) |
         ((static_cast<unsigned>(d) & 0xffu) << 24);
}

// rows r0 .. r0 + n - 1 (zero past seq) of one head's HD columns at `src`
// (rows `ld` apart) as int8 codes clip(round(x * inv), +-127): row-major
// into `dst` (rows i8_ld<HD>() bytes apart) or, with kTransposed, into
// `dst` (dims kVtLd bytes apart) at the keys' vt_pos; all threads
template <int HD, bool kTransposed>
__device__ __forceinline__ void quant_rows_i8(int8_t* dst,
                                              const __nv_bfloat16* src,
                                              size_t ld, int r0, int n,
                                              int seq, float inv) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float f[8];
    if (r0 + r < seq) {
      load8(src + static_cast<size_t>(r0 + r) * ld + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    if constexpr (kTransposed) {
      const int pos = vt_pos(r);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[(c + j) * kVtLd + pos] = quant_i8(f[j], inv);
    } else {
      __align__(8) int8_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
      *reinterpret_cast<uint2*>(dst + r * i8_ld<HD>() + c) =
          *reinterpret_cast<uint2*>(v);
    }
  }
}

// s[j][e]: the warp's rows g (e = 0, 1) and g + 8 (e = 2, 3) against keys
// k0 + 8j + 2t + (e & 1) of the int8 tile `k8`: int32(q8 . k8) * fac in
// f32, -inf past seq
template <int HD>
__device__ __forceinline__ void scores_i8(float (&s)[kKeyTile / 8][4],
                                          const unsigned (&qa)[HD / 32][4],
                                          const int8_t* k8, int k0, int seq,
                                          float fac, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    int acc[4] = {0, 0, 0, 0};
    const int8_t* kr = k8 + (j * 8 + g) * i8_ld<HD>() + 4 * t;
#pragma unroll
    for (int kc = 0; kc < HD / 32; ++kc) {
      const unsigned b[2] = {lds32(kr + kc * 32), lds32(kr + kc * 32 + 16)};
      mma_s8(acc, qa[kc], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < seq ? __fmul_rn(static_cast<float>(acc[e]), fac)
                          : neg_inf;
    }
  }
}

// kStatic: the scales are `st` (kernel 17; amax and qb unused); else
// from the amax table (9b). Grid y: head x slice of HV columns of o.
template <int HD, bool kStatic, int HV = HD>
__global__ void __launch_bounds__(kI8Warps * 32)
    attention_i8_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ amax,
                        __nv_bfloat16* __restrict__ out, int seq, int heads,
                        int qb, float scale, I8AttnScales st) {
  __shared__ __align__(16) int8_t q8s[kI8QTile * i8_ld<HD>()];
  __shared__ __align__(16) int8_t k8s[kKeyTile * i8_ld<HD>()];
  __shared__ __align__(16) int8_t v8t[HV * kVtLd];
  const int wa = heads * HD;
  const int b = blockIdx.z, h = blockIdx.y / (HD / HV);
  const int c0 = (blockIdx.y % (HD / HV)) * HV;   // this block's o columns
  const int q0 = blockIdx.x * kI8QTile;
  if constexpr (!kStatic) {
    const int nqb = (seq + qb - 1) / qb;
    const float* am =
        amax + (static_cast<size_t>(b) * heads + h) * (nqb + 2);
    const float aq = am[q0 / qb], ak = am[nqb], av = am[nqb + 1];
    st.fac = __fmul_rn(__fdiv_rn(__fmul_rn(aq, ak), 16129.0f), scale);
    st.inv_q = __fdiv_rn(127.0f, aq);
    st.inv_k = __fdiv_rn(127.0f, ak);
    st.inv_v = __fdiv_rn(127.0f, av);
    st.cv = __fdiv_rn(av, 16129.0f);
  }
  const float fac = st.fac, inv_k = st.inv_k, inv_v = st.inv_v;
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;

  quant_rows_i8<HD, false>(q8s, base, row3, q0, kI8QTile, seq, st.inv_q);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  // A fragments of the warp's rows: rows g, g + 8 x k 4t.. and 16 + 4t..
  unsigned qa[HD / 32][4];
#pragma unroll
  for (int kc = 0; kc < HD / 32; ++kc) {
    const int8_t* qr = q8s + (r0 + g) * i8_ld<HD>() + kc * 32 + 4 * t;
    qa[kc][0] = lds32(qr);
    qa[kc][1] = lds32(qr + 8 * i8_ld<HD>());
    qa[kc][2] = lds32(qr + 16);
    qa[kc][3] = lds32(qr + 8 * i8_ld<HD>() + 16);
  }
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float s[kKeyTile / 8][4];

  // ---- pass 1: row max and row sum
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();                    // the last tile's reads are done
    quant_rows_i8<HD, false>(k8s, base + wa, row3, kt * kKeyTile, kKeyTile,
                             seq, inv_k);
    __syncthreads();
    scores_i8<HD>(s, qa, k8s, kt * kKeyTile, seq, fac, lane);
    online_stats(s, mx, sum);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  float inv_ap[2], o_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ap = __fadd_rn(__fdiv_rn(1.0f, sum[r]), 1e-20f);
    inv_ap[r] = __fdiv_rn(127.0f, ap);
    o_scale[r] = __fmul_rn(ap, st.cv);
  }

  // ---- pass 2: p8 = round(p * 127 / ap), o += p8 . v8 (int32)
  int acc[HV / 8][4];
#pragma unroll
  for (int dt = 0; dt < HV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    quant_rows_i8<HD, false>(k8s, base + wa, row3, kt * kKeyTile, kKeyTile,
                             seq, inv_k);
    quant_rows_i8<HV, true>(v8t, base + 2 * wa + c0, row3, kt * kKeyTile,
                            kKeyTile, seq, inv_v);
    __syncthreads();
    scores_i8<HD>(s, qa, k8s, kt * kKeyTile, seq, fac, lane);
    int p8[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fdiv_rn(expf(s[j][e] - mx[r]), sum[r]);
        p8[j][e] = static_cast<int>(rintf(__fmul_rn(p, inv_ap[r])));
      }
    // 32 keys a product: score tiles 4kc .. 4kc + 3
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 32; ++kc) {
      const int j = 4 * kc;
      const unsigned a[4] = {
          pack_s8x4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]),
          pack_s8x4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]),
          pack_s8x4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]),
          pack_s8x4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3])};
#pragma unroll
      for (int dt = 0; dt < HV / 8; ++dt) {
        const int8_t* vr = v8t + (dt * 8 + g) * kVtLd + kc * 32 + 4 * t;
        const unsigned bv[2] = {lds32(vr), lds32(vr + 16)};
        mma_s8(acc[dt], a, bv);
      }
    }
  }

  // ---- rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3), bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(b) * seq + qi) * wa + h * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HV / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(
              __fmul_rn(static_cast<float>(acc[dt][2 * r]), o_scale[r]),
              __fmul_rn(static_cast<float>(acc[dt][2 * r + 1]), o_scale[r]));
  }
}

// 9b at heads of 384 to 1280 (the multiples of 128 past 256 that JAX's lane
// rule admits at W <= 1280): a tile's q codes would be 96 to 320 fragment
// registers a thread and, with a key tile's codes, more than static shared
// memory holds, so both sit in dynamic shared memory (64 rows of hd + 16
// bytes each: 162 KB at 1280 with the V codes) and the scores read their A
// and B fragments from it, 32 dims at a time; the int32 sums over those
// depth chunks are the full-depth sums. o in 128-column slices (grid y:
// head x slice), each block computing the full-depth scores.
constexpr int kI8WideSlice = 128;

// rows r0 .. r0 + n - 1 (zero past seq) of one head's hd columns at `src`
// (rows `sld` apart) as int8 codes clip(round(x * inv), +-127), row-major
// into `dst` (rows `ld` bytes apart); all threads
__device__ __forceinline__ void quant_rows_i8_wide(int8_t* dst, int ld,
                                                   const __nv_bfloat16* src,
                                                   size_t sld, int r0, int n,
                                                   int seq, float inv,
                                                   int hd) {
  const int chunks = hd / 8;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    float f[8];
    if (r0 + r < seq) {
      load8(src + static_cast<size_t>(r0 + r) * sld + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    __align__(8) int8_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
    *reinterpret_cast<uint2*>(dst + r * ld + c) =
        *reinterpret_cast<uint2*>(v);
  }
}

// scores_i8 over hd dims with both operands' fragments read from shared
// memory: the warp's rows r0 + g (e = 0, 1) and + 8 (e = 2, 3) of `q8`
// against keys k0 + 8j + 2t + (e & 1) of `k8` (rows `ld` bytes apart)
__device__ __forceinline__ void scores_i8_wide(float (&s)[kKeyTile / 8][4],
                                               const int8_t* q8,
                                               const int8_t* k8, int ld,
                                               int hd, int r0, int k0,
                                               int seq, float fac,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  int acc[kKeyTile / 8][4];
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int kc = 0; kc < hd / 32; ++kc) {
    const int8_t* qr = q8 + (r0 + g) * ld + kc * 32 + 4 * t;
    const unsigned qa[4] = {lds32(qr), lds32(qr + 8 * ld), lds32(qr + 16),
                            lds32(qr + 8 * ld + 16)};
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const int8_t* kr = k8 + (j * 8 + g) * ld + kc * 32 + 4 * t;
      const unsigned b[2] = {lds32(kr), lds32(kr + 16)};
      mma_s8(acc[j], qa, b);
    }
  }
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < seq ? __fmul_rn(static_cast<float>(acc[j][e]), fac)
                          : neg_inf;
    }
}

// dynamic shared bytes of the wide kernel at head_dim hd: the q and k
// codes (64 rows of hd + 16 bytes each) and the transposed V codes
__host__ __device__ constexpr int i8_wide_smem(int hd) {
  return 2 * kI8QTile * (hd + 16) + kI8WideSlice * kVtLd;
}

__global__ void __launch_bounds__(kI8Warps * 32)
    attention_i8_wide_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const float* __restrict__ amax,
                             __nv_bfloat16* __restrict__ out, int seq,
                             int heads, int hd, int qb, float scale) {
  extern __shared__ __align__(16) int8_t smem_i8[];
  constexpr int HV = kI8WideSlice;
  const int ld = hd + 16, n_sl = hd / HV;
  int8_t* q8s = smem_i8;
  int8_t* k8s = q8s + kI8QTile * ld;
  int8_t* v8t = k8s + kKeyTile * ld;
  const int wa = heads * hd;
  const int b = blockIdx.z, h = blockIdx.y / n_sl;
  const int c0 = (blockIdx.y % n_sl) * HV;   // this block's o columns
  const int q0 = blockIdx.x * kI8QTile;
  const int nqb = (seq + qb - 1) / qb;
  const float* am = amax + (static_cast<size_t>(b) * heads + h) * (nqb + 2);
  const float aq = am[q0 / qb], ak = am[nqb], av = am[nqb + 1];
  const float fac = __fmul_rn(__fdiv_rn(__fmul_rn(aq, ak), 16129.0f), scale);
  const float inv_k = __fdiv_rn(127.0f, ak), inv_v = __fdiv_rn(127.0f, av);
  const float cv = __fdiv_rn(av, 16129.0f);
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * hd;

  quant_rows_i8_wide(q8s, ld, base, row3, q0, kI8QTile, seq,
                     __fdiv_rn(127.0f, aq), hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float s[kKeyTile / 8][4];

  // ---- pass 1: row max and row sum
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();                    // the last tile's reads are done
    quant_rows_i8_wide(k8s, ld, base + wa, row3, kt * kKeyTile, kKeyTile,
                       seq, inv_k, hd);
    __syncthreads();
    scores_i8_wide(s, q8s, k8s, ld, hd, r0, kt * kKeyTile, seq, fac, lane);
    online_stats(s, mx, sum);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  float inv_ap[2], o_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ap = __fadd_rn(__fdiv_rn(1.0f, sum[r]), 1e-20f);
    inv_ap[r] = __fdiv_rn(127.0f, ap);
    o_scale[r] = __fmul_rn(ap, cv);
  }

  // ---- pass 2: p8 = round(p * 127 / ap), o += p8 . v8 (int32)
  int acc[HV / 8][4];
#pragma unroll
  for (int dt = 0; dt < HV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    quant_rows_i8_wide(k8s, ld, base + wa, row3, kt * kKeyTile, kKeyTile,
                       seq, inv_k, hd);
    quant_rows_i8<HV, true>(v8t, base + 2 * wa + c0, row3, kt * kKeyTile,
                            kKeyTile, seq, inv_v);
    __syncthreads();
    scores_i8_wide(s, q8s, k8s, ld, hd, r0, kt * kKeyTile, seq, fac, lane);
    int p8[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fdiv_rn(expf(s[j][e] - mx[r]), sum[r]);
        p8[j][e] = static_cast<int>(rintf(__fmul_rn(p, inv_ap[r])));
      }
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 32; ++kc) {
      const int j = 4 * kc;
      const unsigned a[4] = {
          pack_s8x4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]),
          pack_s8x4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]),
          pack_s8x4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]),
          pack_s8x4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3])};
#pragma unroll
      for (int dt = 0; dt < HV / 8; ++dt) {
        const int8_t* vr = v8t + (dt * 8 + g) * kVtLd + kc * 32 + 4 * t;
        const unsigned bv[2] = {lds32(vr), lds32(vr + 16)};
        mma_s8(acc[dt], a, bv);
      }
    }
  }

  // ---- rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3), bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(b) * seq + qi) * wa + h * hd + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HV / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(
              __fmul_rn(static_cast<float>(acc[dt][2 * r]), o_scale[r]),
              __fmul_rn(static_cast<float>(acc[dt][2 * r + 1]), o_scale[r]));
  }
}

int launch_attention_i8_wide(const void* qkv, void* amax, void* out,
                             int batch, int seq, int heads, int hd, int qb,
                             float scale, cudaStream_t s) {
  const int smem = i8_wide_smem(hd);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_i8_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      i8_wide_smem(1280));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (static_cast<long long>(heads) * (hd / kI8WideSlice) > 65535)
    return cudaErrorInvalidValue;
  attention_i8_amax_kernel<<<dim3(heads, batch), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<float*>(amax), seq,
      heads, hd, qb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kI8QTile - 1) / kI8QTile,
                  heads * (hd / kI8WideSlice), batch);
  attention_i8_wide_kernel<<<grid, kI8Warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(amax), static_cast<__nv_bfloat16*>(out), seq,
      heads, hd, qb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_attention_i8(const void* qkv, void* amax, void* out, int batch,
                        int seq, int heads, int qb, float scale,
                        cudaStream_t s) {
  attention_i8_amax_kernel<<<dim3(heads, batch), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<float*>(amax), seq,
      heads, HD, qb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int HV = HD > 128 ? 128 : HD;
  if (static_cast<long long>(heads) * (HD / HV) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kI8QTile - 1) / kI8QTile, heads * (HD / HV), batch);
  attention_i8_kernel<HD, false, HV><<<grid, kI8Warps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(amax), static_cast<__nv_bfloat16*>(out), seq,
      heads, qb, scale, I8AttnScales{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// 9b: qkv (B, S, 3 * heads * head_dim) bf16 -> out (B, S, heads *
// head_dim) bf16; amax: (B, heads, ceil(S / qb) + 2) f32 scratch; qb =
// min(256, S), so that the 64-row query tiles never straddle a block;
// head_dim 64, 128 or 256 (16 and 32 arrive zero-padded to 64) or a wide
// one (384 .. 1280, the multiples of 128), S <= kMaxSeq
TPUDF_API int tpudf_attention_i8dyn(const void* qkv, void* amax, void* out,
                                    int batch, int seq, int heads,
                                    int head_dim, int qb, float scale,
                                    void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || qb <= 0 ||
      (qb < seq && qb % kI8QTile != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_attention_i8<64>(qkv, amax, out, batch, seq, heads, qb,
                                   scale, s);
  if (head_dim == 128)
    return launch_attention_i8<128>(qkv, amax, out, batch, seq, heads, qb,
                                    scale, s);
  if (head_dim == 256)
    return launch_attention_i8<256>(qkv, amax, out, batch, seq, heads, qb,
                                    scale, s);
  if (head_dim >= 384 && head_dim <= 1280 && head_dim % 128 == 0)
    return launch_attention_i8_wide(qkv, amax, out, batch, seq, heads,
                                    head_dim, qb, scale, s);
  return cudaErrorInvalidValue;
}

// 17: qkv (B, S, 3 * heads * 128) bf16 -> out (B, S, heads * 128) bf16
// with static scales: inv_q = 127 / aq, inv_k, inv_v likewise, fac = (aq *
// ak) / 127^2 * scale, cv = av / 127^2, each rounded once to f32 by the
// caller; S <= kMaxSeq. The probe pads queries to its 256-row blocks; no
// row depends on another's block here, so nothing is padded.
TPUDF_API int tpudf_attention_i8_static(const void* qkv, void* out, int batch,
                                        int seq, int heads, int head_dim,
                                        float inv_q, float inv_k,
                                        float inv_v, float fac, float cv,
                                        void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || head_dim != 128)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kI8QTile - 1) / kI8QTile, heads, batch);
  attention_i8_kernel<128, true>
      <<<grid, kI8Warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(qkv), nullptr,
          static_cast<__nv_bfloat16*>(out), seq, heads, 0, 0.0f,
          I8AttnScales{inv_q, inv_k, inv_v, fac, cv});
  return static_cast<int>(cudaGetLastError());
}
