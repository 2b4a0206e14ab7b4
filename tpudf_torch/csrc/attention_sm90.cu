// K9, K1's attention and K10 on Hopper's own machinery: wgmma products and
// TMA loads through mbarrier rings (sm90.cuh).
//
// K9, replacing tpudf/ops/attention.py `_attention_qkv_pallas` (inner
// `kernel`, `_one_head` without int8_attn): the fused bf16 qkv (B, S, 3Wa),
// laid out [q | k | v] with heads contiguous, and an optional (B, S) f32
// per-key logit bias (ToMe proportional attention) -> o (B, S, Wa) bf16.
// The TPU kernel's function, an exact softmax in two sweeps over the keys:
//   pass 1  s = (q . k) * scale in f32, + bias, -inf for keys past S; the
//           row max m and the row sum l = sum exp(s - m), kept online over
//           64-key tiles (l rescaled when m grows; each thread sums its 16
//           keys of a tile in key order, the four threads of a row add up
//           at the end);
//   pass 2  s again, p = exp(s - m) / l in f32, rounded to bf16 for p . v,
//           o accumulated in f32 and rounded once to bf16.
// A block is two consumer warpgroups of 64 query rows (wgmma's M) and a
// producer warpgroup (setmaxnreg: 24 registers for the producer, 240 for
// the consumers), one block an SM, persistent over work items of (128
// query rows, head, image). The producer's first thread loads each item's
// Q (double-buffered) and streams the head's K tiles (pass 1) and K and V
// tiles (pass 2), 64 keys each, with the bias tile beside each K tile
// (the wrapper pads each image's bias row to whole tiles), through a ring
// of 6 (head_dim 64) or 4 (128) stages that runs on across items: each box
// of 64 columns by TMA from a 3-D tensor map over qkv (3Wa columns, S
// rows, B images), whose rows past S arrive as zeros (a ragged tile never
// reads the next image; those keys are still masked, as a zero key scores
// 0). QK^T runs as wgmma with Q and K both K-major in shared
// memory; p is formed in registers from the score accumulators and is
// wgmma's register A against V, read with the transpose bit; tile t's p is
// formed while tile t - 1's p . v runs. o leaves through the warpgroup's
// rows of the Q buffer and a TMA store. Head_dim 64 or 128 (a template
// parameter; so400m's heads of 72 arrive zero-padded to 128, with their
// own scale: the scale is an argument, never derived from head_dim), S <=
// kMaxSeq (common.cuh): nothing in the block grows with S. Each score
// costs an expf in each pass and a division in the second: on the card
// these instructions and the products take about half of the time each,
// and do not overlap (PERF.md).
//
// K1's attention, replacing the attention loop of tpudf/ops/int8_block.py
// `_attn_sublayer_kernel` (the rest of K1 is the LN-quant and the int8
// GEMMs): the same kernel and order (the template's OUT = kOutI8) on
// kernels 11 and 12's softmax sequence (scores and bias carry log2 e, e =
// ex2(s - m), p = e r with r = 1 / l refined once a row: p moves by a few
// f32 ulps against K9's expf and division), and o leaves as int8 codes
// clip(round(o * 127 / act),
// +-127) of the f32 accumulators (round half to even, as the TPU kernel
// quantises the f32 output), each thread storing its two neighbouring
// columns of a row straight from the registers, rows past S not written:
// (B S, Wa) int8, the out-projection GEMM's input. Its tiles are 64, 128
// or 256 wide, or 80: so400m's heads of 72 sit zero-padded in 128-column
// slots of qkv (the pre-padded static tree), and the kernel reads each
// head's first 80 columns (a 64-column box in the 128-byte swizzle and a
// 16-column one in the 32-byte swizzle, kernels 11 and 12's tile, from a
// second tensor map over qkv), columns 72-79 as they are, and writes codes
// 0 in its columns 80-127: 80/128 of the products and of the bytes of the
// 128-wide tile. At the detect cores' shapes the softmax's instructions
// and the products bound it, as they bound K9.
//
// Wide heads (384 to 1280, the multiples of 128 past 256 that JAX's lane
// rule admits at W <= 1280), K9 and K1 alike: a work item is 128 query rows
// and one 128-column slice of o; Q streams beside K in 64-column chunks,
// the scores summed over the head's chunks (`attention_fwd_wide_sm90`).
// K10 at those heads streams the rows a block owns in chunks as well
// (`attention_bwd_dq_wide_sm90`, `attention_bwd_dkv_wide_sm90`).
//
// K10, replacing `_attn_qkv_bwd_kernel` (the backward of K9 without a
// bias), from qkv and the cotangent g (B, S, Wa): the same P, then
//   dV = bf16(P)^T g;  dP = g V^T;  D = rowsum(dP * P) (unrounded P);
//   dS = P * (dP - D) * scale;  dQ = bf16(dS) K;  dK = bf16(dS)^T Q,
// f32 sums, each output rounded once into dqkv (B, S, 3Wa) in the
// forward's [q | k | v] layout. FlashAttention-2's split in two launches,
// each block two consumer warpgroups and a producer warpgroup as above,
// one block an SM:
//   dq pass   (128 query rows; Q and g loaded once, K and V streamed in
//             64-key tiles): four sweeps over the keys, the row max, the
//             row sum against the final max (the exact softmax of the TPU
//             kernel), D, then dS and dQ += bf16(dS) K (register A, K
//             read with the transpose bit); S = Q K^T and dP = g V^T as
//             wgmma with both operands K-major. It writes dQ and the rows'
//             max, sum and D into a (3, B, H, S) f32 scratch.
//   dkv pass  (128 key rows; K and V loaded once, Q and g streamed in
//             64-query chunks, the head's row statistics in shared
//             memory): S^T = K Q^T and dP^T = V g^T, then P^T from the
//             saved max and sum (0 for queries past S), dS^T, dV +=
//             bf16(P^T) g and dK += bf16(dS^T) Q (register A, g and Q read
//             with the transpose bit).
// At head_dim 128 a consumer thread of the dkv pass holds dK and dV (64
// f32 each) beside S^T and dP^T (32 each) in its 240 registers. Any S up
// to kMaxSeqBwd (the statistics' shared memory; JAX's own fit stops near
// 1,570), ragged ones included. The outputs leave through the block's own
// tiles in shared memory and TMA stores.
#include <algorithm>
#include <chrono>

#include "attn_sm90.cuh"

namespace tpudf {
namespace {

using namespace sm90;

constexpr int kMaxSeqBwd = 2048;     // K10: the statistics' shared memory

// Heads of 256 (the widest head_dim JAX's lane rule admits at W <= 1280
// that a block can hold): K9 keeps one Q buffer (64 KB) and two ring
// stages; K10's blocks keep one stage (their Q and g, or K and V, take
// 128 KB) and split the head's columns: each block owns one 128-wide
// slice of dq, or of dk and dv, and computes the full 256-deep S and dP,
// so the score work repeats once per slice.
template <int HD>
__host__ __device__ constexpr int fwd_q_bufs() {
  return HD > 128 ? 1 : 2;
}

template <int HD>
__host__ __device__ constexpr int fwd_stages() {
  return HD > 128 ? 2 : stages<HD>();
}

template <int HD>
__host__ __device__ constexpr int bwd_stages() {
  return HD > 128 ? 1 : stages<HD>();
}

// the columns of dq (dk, dv) one K10 block owns
template <int HD>
__host__ __device__ constexpr int bwd_slice() {
  return HD > 128 ? 128 : HD;
}

// ---------------------------------------------------------- K9 and K1

// what a forward kernel writes: K9's bf16 o, or K1's int8 codes of the
// f32 o, clip(round(o * 127 / act), +-127) (the quant of the int8
// out-projection's input), or those codes from K9's exact softmax (expf
// and the division: K7's attention, whose split form runs here)
constexpr int kOutBf16 = 0, kOutI8 = 1, kOutI8Exact = 2;

// shared memory: fwd_q_bufs Q buffers (128 rows each), then kStages
// stages of a K tile, a V tile and the bias tile (64 f32, padded to 1
// KB), then the barriers; a tile W = 80 wide is sm90.cuh's 80-wide tile
template <int W>
struct FwdSmem {
  static constexpr int kStages = fwd_stages<W>();
  static constexpr int kQBufs = fwd_q_bufs<W>();
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kQBufs * tile_bytes<W>(kBlockRows);
  static constexpr int kV = tile_bytes<W>(kTileRows);
  static constexpr int kBias = 2 * tile_bytes<W>(kTileRows);
  static constexpr int kStage = kBias + 1024;
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;
};

// zero codes in columns col0 .. col0 + n - 1 (n a multiple of 16, col0
// and ld of 16) of the warpgroup's rows row0 + .. below seq of image b
__device__ __forceinline__ void zero_i8_cols(int8_t* o8, int ld, int col0,
                                             int n, int b, int row0, int seq,
                                             const Consumer& c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + c.row + 8 * r;
    if (qi >= seq) continue;
    int8_t* dst = o8 + (static_cast<size_t>(b) * seq + qi) * ld + col0;
    for (int j = c.t; j < n / 16; j += 4)
      *reinterpret_cast<uint4*>(dst + 16 * j) = make_uint4(0, 0, 0, 0);
  }
}

// a block's work item: 128 query rows of one head of one image
struct FwdItem {
  int q0, h, b;
};

__device__ __forceinline__ FwdItem fwd_item(int it, int n_qt, int heads) {
  return {(it % n_qt) * kBlockRows, (it / n_qt) % heads, it / (n_qt * heads)};
}

// The blocks are persistent: block x takes items x, x + gridDim.x, ...
// (query tiles fastest, so that the blocks running together share heads
// in L2), and the ring runs on across items, so that the next item's Q
// and first tiles load while the last one finishes. Q is double-buffered
// (at head_dim 256 single: the next item's Q waits for this one's end).
// In pass 2 a warpgroup forms tile t's p while tile t - 1's p . v runs
// on the tensor cores (FlashAttention-3's order within a warpgroup: the
// product of t's scores, then t - 1's p . v, wait for the first).
// W: the tile's columns, 64, 128 or 256, or 80 (K1 only: the first 80
// columns of each head, whose head stride hs is 128); hs: a head's
// columns in qkv (W but at 80). OUT: kOutBf16 (K9: o through the Q
// buffer and a TMA store) or kOutI8 (K1: int8 codes of o stored from
// the accumulators, codes 0 in a head's columns W .. hs - 1).
template <int W, int OUT>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_sm90(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap qkv16_map,
                       const __grid_constant__ CUtensorMap bias_map,
                       const __grid_constant__ CUtensorMap out_map,
                       int8_t* __restrict__ o8,
                       const float* __restrict__ act, int has_bias,
                       int batch, int seq, int heads, int hs, float scale) {
  using L = FwdSmem<W>;
  constexpr bool kNarrow = W == 80;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;            // two slots each (kQBufs used)
  uint64_t* q_empty = bars + 2;
  const Ring<L::kStages> ring{bars + 4, bars + 4 + L::kStages};
  auto stage = [&](int r) {
    return smem + L::kStage0 + ring.stage(r) * L::kStage;
  };
  const int wa = heads * hs;
  const int n_qt = (seq + kBlockRows - 1) / kBlockRows;
  const int n_items = n_qt * heads * batch;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kWarpgroups * 128);
    }
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], kWarpgroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: one lane issues every load
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    const uint32_t k_bytes = tile_bytes<W>(kTileRows) + (has_bias ? 256 : 0);
    int r = 0;
    for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
      const FwdItem w = fwd_item(it, n_qt, heads);
      const int qb = n % L::kQBufs, round = n / L::kQBufs;
      if (round > 0) mbar_wait(&q_empty[qb], (round - 1) & 1);
      mbar_expect_tx(&q_full[qb], tile_bytes<W>(kBlockRows));
      unsigned char* q = smem + L::kQ + qb * tile_bytes<W>(kBlockRows);
      for (int rr = 0; rr < kBlockRows / kTileRows; ++rr) {
        const int row = w.q0 + rr * kTileRows;
        for (int c = 0; c < W / 64; ++c)
          tma_load_3d(q + c * kBlockSub + rr * kBox, &qkv_map, &q_full[qb],
                      w.h * hs + 64 * c, row, w.b);
        if (kNarrow)
          tma_load_3d(q + kBlockSub + rr * kTileRows * kNarrowRow,
                      &qkv16_map, &q_full[qb], w.h * hs + 64, row, w.b);
      }
      for (int i = 0; i < 2 * ntiles; ++i, ++r) {
        const bool pass2 = i >= ntiles;
        const int k0 = (pass2 ? i - ntiles : i) * kTileRows;
        uint64_t* full = ring.producer_acquire(
            r, k_bytes + (pass2 ? tile_bytes<W>(kTileRows) : 0));
        unsigned char* st = stage(r);
        for (int c = 0; c < W / 64; ++c) {
          tma_load_3d(st + c * kBox, &qkv_map, full, wa + w.h * hs + 64 * c,
                      k0, w.b);
          if (pass2)
            tma_load_3d(st + L::kV + c * kBox, &qkv_map, full,
                        2 * wa + w.h * hs + 64 * c, k0, w.b);
        }
        if (kNarrow) {
          tma_load_3d(st + kBox, &qkv16_map, full, wa + w.h * hs + 64, k0,
                      w.b);
          if (pass2)
            tma_load_3d(st + L::kV + kBox, &qkv16_map, full,
                        2 * wa + w.h * hs + 64, k0, w.b);
        }
        if (has_bias)
          tma_load_1d(st + L::kBias, &bias_map, full,
                      w.b * ntiles * kTileRows + k0);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  const float neg_inf = __int_as_float(0xff800000);
  // K1 runs kernels 11 and 12's softmax: scores (and the bias) carry log2 e
  constexpr bool kEx2 = OUT == kOutI8;
  const float mul = kEx2 ? __fmul_rn(scale, kLog2e) : scale;
  const float bias_mul = kEx2 ? kLog2e : 1.0f;
  float inv = 0.0f;                     // 127 / act (K1, K7)
  if constexpr (OUT != kOutBf16) {
    const float a = __ldg(act);
    inv = div_rn(127.0f, a, rcp_refined(a));
  }
  float s[32], o[kNarrow ? 32 : W / 2], o16[8];   // o16: W = 80 only
  zero(s);
  auto bias_of = [&](int r) {
    return has_bias ? reinterpret_cast<const float*>(stage(r) + L::kBias)
                    : nullptr;
  };
  int r = 0;
  for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
    const FwdItem w = fwd_item(it, n_qt, heads);
    const int qb = n % L::kQBufs;
    mbar_wait(&q_full[qb], (n / L::kQBufs) & 1);
    if (w.q0 + c.wg * 64 >= seq) {
      // rows all past seq: keep the barriers' counts, skip the work
      for (int i = 0; i < 2 * ntiles; ++i, ++r) {
        ring.consumer_wait(r);
        ring.release(r);
      }
      mbar_arrive(&q_empty[qb]);
      continue;
    }
    unsigned char* qbuf = smem + L::kQ + qb * tile_bytes<W>(kBlockRows);
    unsigned char* qw = qbuf + c.wg * kBox;
    const uint64_t qd = desc_k(qw);
    const uint64_t qd16 = desc_32(qbuf + kBlockSub + c.wg * 64 * kNarrowRow);
    // tile t's scores, and the p . v of the tile at `rows`
    auto issue_s = [&](int t) {
      if constexpr (kNarrow)
        issue_nt80(s, qd, qd16, stage(t));
      else
        issue_nt<W>(s, qd, kBlockSub, stage(t));
    };
    auto issue_pv = [&](uint32_t (&a)[4][4], const unsigned char* rows) {
      if constexpr (kNarrow)
        issue_nn80(o, o16, a, rows);
      else
        issue_nn<W>(o, a, rows);
    };
    float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};

    // pass 1: the row max and the row sum, online over the K tiles
    for (int t = 0; t < ntiles; ++t) {
      ring.consumer_wait(r + t);
      issue_s(r + t);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      mask_scores(s, t * kTileRows, seq, bias_of(r + t), mul, c.t, bias_mul);
      ring.release(r + t);
      online_stats<kEx2>(s, mx, sum);
    }
    r += ntiles;
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float rsum[2] = {rcp_refined(sum[0]), rcp_refined(sum[1])};

    // pass 2: p = exp(s - m) / l, o += bf16(p) . v; tile t's p is formed
    // while tile t - 1's p . v runs
    auto form_p = [&](int t) {
      mask_scores(s, t * kTileRows, seq, bias_of(r + t), mul, c.t, bias_mul);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        s[k] = prob_of<kEx2>(s[k], mx[(k >> 1) & 1], sum[(k >> 1) & 1],
                             rsum[(k >> 1) & 1]);
    };
    zero(o);
    if constexpr (kNarrow) zero(o16);
    uint32_t a[4][4];
    ring.consumer_wait(r);
    issue_s(r);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    form_p(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    for (int t = 1; t < ntiles; ++t) {
      ring.consumer_wait(r + t);
      issue_s(r + t);
      wg_commit();
      issue_pv(a, stage(r + t - 1) + L::kV);
      wg_commit();
      wg_wait<1>();                   // tile t's scores; t - 1's p . v runs
      fence_regs(s);
      form_p(t);
      wg_wait<0>();
      fence_regs(o);
      if constexpr (kNarrow) fence_regs(o16);
      fence_regs(a);
      ring.release(r + t - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    }
    issue_pv(a, stage(r + ntiles - 1) + L::kV);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    if constexpr (kNarrow) fence_regs(o16);
    ring.release(r + ntiles - 1);
    r += ntiles;
    const int row0 = w.q0 + c.wg * 64;
    if constexpr (OUT == kOutBf16) {
      // o through this warpgroup's rows of the Q buffer, then Q is free
      store_tile<W>(o, qw, &out_map, w.h * W, row0, w.b, c);
      mbar_arrive(&q_empty[qb]);
    } else {
      // Q is read: free it; the codes go from the accumulators
      mbar_arrive(&q_empty[qb]);
      store_i8<kNarrow ? 64 : W>(o, o8, wa, w.h * hs, w.b, row0, seq, inv,
                                 c);
      if constexpr (kNarrow) {
        store_i8<16>(o16, o8, wa, w.h * hs + 64, w.b, row0, seq, inv, c);
        zero_i8_cols(o8, wa, w.h * hs + W, hs - W, w.b, row0, seq, c);
      }
    }
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

// the bias map of a launch: the (B, S rounded up to 64) f32 rows padded to
// whole tiles, so that every box starts on a 256-byte boundary (boxes that
// started off a 16-byte one, at b * S floats with S % 4 != 0, faulted on
// the card: CUDA error 715); with no bias, `fallback` (never read)
bool map_bias(CUtensorMap* m, const void* key_bias, int batch, int seq,
              const CUtensorMap& fallback) {
  if (key_bias == nullptr) {
    *m = fallback;
    return true;
  }
  const long long rows = static_cast<long long>(batch) *
                         ((seq + kTileRows - 1) / kTileRows) * kTileRows;
  return rows <= kMaxRows &&
         map_f32_1d(m, key_bias, static_cast<uint64_t>(rows), kTileRows);
}

template <int W, int OUT>
int launch_fwd(const void* qkv, const void* key_bias, void* out,
               const void* act, int batch, int seq, int heads, int hs,
               float scale, cudaStream_t stream) {
  const int wa = heads * hs;
  CUtensorMap qkv_map, qkv16_map, bias_map, out_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * wa, seq, batch, kTileRows))
    return cudaErrorInvalidValue;
  qkv16_map = qkv_map;
  out_map = qkv_map;                        // K1: never read
  if ((W == 80 && !map_bf16_3d(&qkv16_map, qkv, 3 * wa, seq, batch,
                               kTileRows, 16)) ||
      (OUT == kOutBf16 &&
       !map_bf16_3d(&out_map, out, wa, seq, batch, kTileRows)) ||
      !map_bias(&bias_map, key_bias, batch, seq, qkv_map))
    return cudaErrorInvalidValue;
  static const cudaError_t attr =
      registers_suffice(attention_fwd_sm90<W, OUT>)
          ? cudaFuncSetAttribute(attention_fwd_sm90<W, OUT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(FwdSmem<W>::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long n_items = static_cast<long long>(
      (seq + kBlockRows - 1) / kBlockRows) * heads * batch;
  if (n_items > 2147483647ll) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(n_items, sm_count()));
  attention_fwd_sm90<W, OUT>
      <<<grid, kThreads, FwdSmem<W>::kBytes, stream>>>(
          qkv_map, qkv16_map, bias_map, out_map,
          OUT != kOutBf16 ? static_cast<int8_t*>(out) : nullptr,
          static_cast<const float*>(act), key_bias != nullptr, batch, seq,
          heads, hs, scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------- K9 and K1, wide heads

// Heads of 384 to 1280 (the multiples of 128 past 256 that JAX's lane
// rule admits at W <= 1280): a block's Q (128 rows x head_dim: 96 KB at
// 384) no longer fits beside a ring, so nothing of the head stays
// resident. A work item is (128 query rows, one 128-column slice of o,
// head, image); for each 64-key tile its full-depth scores are summed over
// 64-column chunks, each stage of the ring a Q chunk (re-read from L2 for
// every key tile) and a K chunk; the tile's last chunk brings the bias
// tile and, in pass 2, the V slice. The softmax and its order are the
// narrow kernel's; the score work repeats once per slice of o. No product
// overlaps another: correctness, not speed (no config has such heads).
constexpr int kWideSlice = 128;      // columns of o (dq, dk, dv) an item owns

struct WideFwdSmem {
  static constexpr int kStages = 4;
  static constexpr int kQ = 0;                     // Q chunk: 128 x 64
  static constexpr int kK = kBlockSub;             // K chunk: 64 x 64
  static constexpr int kV = kK + kBox;             // V slice: 64 x 128
  static constexpr int kBias = kV + 2 * kBox;
  static constexpr int kStage = kBias + 1024;
  static constexpr int kOut = kStages * kStage;    // K9's o: 128 x 128
  static constexpr int kBars = kOut + 2 * kBlockSub;
  static constexpr size_t kBytes = kBars + 8 * 2 * kStages + 1024;
};

// whether hd is a wide head the kernels take
__host__ __device__ constexpr bool wide_head(int hd) {
  return hd >= 384 && hd <= 1280 && hd % 128 == 0;
}

struct WideItem {
  int q0, sl, h, b;
};

__device__ __forceinline__ WideItem wide_item(int it, int n_qt, int n_sl,
                                              int heads) {
  return {(it % n_qt) * kBlockRows, (it / n_qt) % n_sl,
          (it / (n_qt * n_sl)) % heads, it / (n_qt * n_sl * heads)};
}

template <int OUT>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_wide_sm90(const __grid_constant__ CUtensorMap qkv_map,
                            const __grid_constant__ CUtensorMap bias_map,
                            const __grid_constant__ CUtensorMap out_map,
                            int8_t* __restrict__ o8,
                            const float* __restrict__ act, int has_bias,
                            int batch, int seq, int heads, int hd,
                            float scale) {
  using L = WideFwdSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const Ring<L::kStages> ring{bars, bars + L::kStages};
  auto stage = [&](int r) { return smem + ring.stage(r) * L::kStage; };
  const int wa = heads * hd, n_ch = hd / 64, n_sl = hd / kWideSlice;
  const int n_qt = (seq + kBlockRows - 1) / kBlockRows;
  const int n_items = n_qt * n_sl * heads * batch;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], kWarpgroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: per key tile and pass, the head's chunks in turn
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    int r = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const WideItem w = wide_item(it, n_qt, n_sl, heads);
      for (int i = 0; i < 2 * ntiles; ++i) {
        const bool pass2 = i >= ntiles;
        const int k0 = (pass2 ? i - ntiles : i) * kTileRows;
        for (int ch = 0; ch < n_ch; ++ch, ++r) {
          const bool last = ch == n_ch - 1;
          uint64_t* full = ring.producer_acquire(
              r, 3 * kBox + (last && pass2 ? 2 * kBox : 0) +
                     (last && has_bias ? 256 : 0));
          unsigned char* st = stage(r);
          const int col = w.h * hd + 64 * ch;
          tma_load_3d(st + L::kQ, &qkv_map, full, col, w.q0, w.b);
          tma_load_3d(st + L::kQ + kBox, &qkv_map, full, col,
                      w.q0 + kTileRows, w.b);
          tma_load_3d(st + L::kK, &qkv_map, full, wa + col, k0, w.b);
          if (last && pass2)
            for (int v = 0; v < 2; ++v)
              tma_load_3d(st + L::kV + v * kBox, &qkv_map, full,
                          2 * wa + w.h * hd + w.sl * kWideSlice + 64 * v, k0,
                          w.b);
          if (last && has_bias)
            tma_load_1d(st + L::kBias, &bias_map, full,
                        w.b * ntiles * kTileRows + k0);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  const float neg_inf = __int_as_float(0xff800000);
  constexpr bool kEx2 = OUT == kOutI8;  // K1: kernels 11 and 12's softmax
  const float mul = kEx2 ? __fmul_rn(scale, kLog2e) : scale;
  const float bias_mul = kEx2 ? kLog2e : 1.0f;
  float inv = 0.0f;                     // 127 / act (K1, K7)
  if constexpr (OUT != kOutBf16) {
    const float a = __ldg(act);
    inv = div_rn(127.0f, a, rcp_refined(a));
  }
  float s[32], o[kWideSlice / 2];
  zero(s);
  int r = 0;
  // a tile's scores over the head's chunks; the stage of its last chunk
  // (bias, V slice) is left to the caller to release
  auto scores = [&](int k0) {
    for (int ch = 0; ch < n_ch; ++ch) {
      ring.consumer_wait(r);
      issue_nt_chunk(s, desc_k(stage(r) + L::kQ + c.wg * kBox),
                     stage(r) + L::kK, ch > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      if (ch + 1 < n_ch) ring.release(r++);
    }
    mask_scores(s, k0, seq,
                has_bias ? reinterpret_cast<const float*>(stage(r) + L::kBias)
                         : nullptr,
                mul, c.t, bias_mul);
  };
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const WideItem w = wide_item(it, n_qt, n_sl, heads);
    if (w.q0 + c.wg * 64 >= seq) {
      // rows all past seq: keep the barriers' counts, skip the work
      for (int i = 0; i < 2 * ntiles * n_ch; ++i, ++r) {
        ring.consumer_wait(r);
        ring.release(r);
      }
      continue;
    }
    float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
    for (int t = 0; t < ntiles; ++t) {            // pass 1
      scores(t * kTileRows);
      ring.release(r++);
      online_stats<kEx2>(s, mx, sum);
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float rsum[2] = {rcp_refined(sum[0]), rcp_refined(sum[1])};
    zero(o);
    for (int t = 0; t < ntiles; ++t) {            // pass 2
      scores(t * kTileRows);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        s[k] = prob_of<kEx2>(s[k], mx[(k >> 1) & 1], sum[(k >> 1) & 1],
                             rsum[(k >> 1) & 1]);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
      issue_nn<kWideSlice>(o, a, stage(r) + L::kV);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(a);
      ring.release(r++);
    }
    const int row0 = w.q0 + c.wg * 64;
    const int col0 = w.h * hd + w.sl * kWideSlice;
    if constexpr (OUT == kOutBf16)
      store_tile<kWideSlice>(o, smem + L::kOut + c.wg * kBox, &out_map, col0,
                             row0, w.b, c);
    else
      store_i8<kWideSlice>(o, o8, wa, col0, w.b, row0, seq, inv, c);
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int OUT>
int launch_fwd_wide(const void* qkv, const void* key_bias, void* out,
                    const void* act, int batch, int seq, int heads, int hd,
                    float scale, cudaStream_t stream) {
  const int wa = heads * hd;
  CUtensorMap qkv_map, bias_map, out_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * wa, seq, batch, kTileRows))
    return cudaErrorInvalidValue;
  out_map = qkv_map;                        // K1: never read
  if ((OUT == kOutBf16 &&
       !map_bf16_3d(&out_map, out, wa, seq, batch, kTileRows)) ||
      !map_bias(&bias_map, key_bias, batch, seq, qkv_map))
    return cudaErrorInvalidValue;
  static const cudaError_t attr =
      registers_suffice(attention_fwd_wide_sm90<OUT>)
          ? cudaFuncSetAttribute(attention_fwd_wide_sm90<OUT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(WideFwdSmem::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long n_items = static_cast<long long>(
      (seq + kBlockRows - 1) / kBlockRows) * (hd / kWideSlice) * heads *
      batch;
  if (n_items > 2147483647ll) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(n_items, sm_count()));
  attention_fwd_wide_sm90<OUT><<<grid, kThreads, WideFwdSmem::kBytes,
                                 stream>>>(
      qkv_map, bias_map, out_map,
      OUT != kOutBf16 ? static_cast<int8_t*>(out) : nullptr,
      static_cast<const float*>(act), key_bias != nullptr, batch, seq, heads,
      hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- K10

// dq pass: Q and g (128 rows each), then kStages stages of a K and a V
// tile, then the barriers
template <int HD>
struct DqSmem {
  static constexpr int kStages = bwd_stages<HD>();
  static constexpr int kQ = 0;
  static constexpr int kG = tile_bytes<HD>(kBlockRows);
  static constexpr int kStage0 = 2 * tile_bytes<HD>(kBlockRows);
  static constexpr int kV = tile_bytes<HD>(kTileRows);
  static constexpr int kStage = 2 * tile_bytes<HD>(kTileRows);
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// dkv pass: K and V (128 rows each), kStages stages of a Q and a g chunk,
// the barriers, then the head's row statistics (4 x n_stat f32: max, sum,
// D and the sum's reciprocal)
template <int HD>
struct DkvSmem {
  static constexpr int kStages = bwd_stages<HD>();
  static constexpr int kK = 0;
  static constexpr int kV = tile_bytes<HD>(kBlockRows);
  static constexpr int kStage0 = 2 * tile_bytes<HD>(kBlockRows);
  static constexpr int kG = tile_bytes<HD>(kTileRows);
  static constexpr int kStage = 2 * tile_bytes<HD>(kTileRows);
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr int kStats = kBars + 128;
  static size_t bytes(int n_stat) {
    return kStats + 16 * static_cast<size_t>(n_stat) + 1024;
  }
};

// rows of the statistics the dkv pass holds: S rounded up to the chunks
__host__ __device__ constexpr int stat_rows(int seq) {
  return (seq + kTileRows - 1) / kTileRows * kTileRows;
}

// stats: (3, B, H, S) f32 — row max, row sum of exp(s - max), D; grid z:
// image x slice of the head's columns (HV of them), the statistics
// written by slice 0
template <int HD, int HV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap qkv_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap dqkv_map,
                          float* __restrict__ stats, int seq, int heads,
                          float scale) {
  using L = DqSmem<HD>;
  constexpr int kSlices = HD / HV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* qg_full = bars;
  const Ring<L::kStages> ring{bars + 1, bars + 1 + L::kStages};
  auto stage = [&](int i) {
    return smem + L::kStage0 + ring.stage(i) * L::kStage;
  };
  const int wa = heads * HD;
  const int b = blockIdx.z / kSlices, sl = blockIdx.z % kSlices;
  const int h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const int n_wg = active_warpgroups(q0, seq);
  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 128 * n_wg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: Q and g once, then K tiles (sweeps 1, 2) and K and V
    // tiles (sweeps 3, 4)
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    mbar_expect_tx(qg_full, 2 * tile_bytes<HD>(kBlockRows));
    for (int c = 0; c < HD / 64; ++c)
      for (int r = 0; r < kBlockRows / kTileRows; ++r) {
        const int off = c * kBlockSub + r * kBox;
        tma_load_3d(smem + L::kQ + off, &qkv_map, qg_full, h * HD + 64 * c,
                    q0 + r * kTileRows, b);
        tma_load_3d(smem + L::kG + off, &g_map, qg_full, h * HD + 64 * c,
                    q0 + r * kTileRows, b);
      }
    for (int i = 0; i < 4 * ntiles; ++i) {
      const bool with_v = i >= 2 * ntiles;
      const int k0 = (i % ntiles) * kTileRows;
      uint64_t* full = ring.producer_acquire(
          i, tile_bytes<HD>(kTileRows) * (with_v ? 2 : 1));
      unsigned char* st = stage(i);
      for (int c = 0; c < HD / 64; ++c) {
        tma_load_3d(st + c * kBox, &qkv_map, full, wa + h * HD + 64 * c, k0,
                    b);
        if (with_v)
          tma_load_3d(st + L::kV + c * kBox, &qkv_map, full,
                      2 * wa + h * HD + 64 * c, k0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  if (c.wg >= n_wg) return;
  unsigned char* qw = smem + L::kQ + c.wg * kBox;
  const uint64_t qd = desc_k(qw);
  const uint64_t gd = desc_k(smem + L::kG + c.wg * kBox);
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float dsum[2] = {0.0f, 0.0f}, rsum[2] = {1.0f, 1.0f};
  float s[32], dp[32], dq[HV / 2];
  zero(s);
  zero(dp);
  zero(dq);
  mbar_wait(qg_full, 0);
  for (int sweep = 0; sweep < 4; ++sweep) {
    for (int t = 0; t < ntiles; ++t) {
      const int i = sweep * ntiles + t;
      ring.consumer_wait(i);
      const unsigned char* st = stage(i);
      issue_nt<HD>(s, qd, kBlockSub, st);
      if (sweep >= 2) issue_nt<HD>(dp, gd, kBlockSub, st + L::kV);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      mask_scores(s, t * kTileRows, seq, nullptr, scale, c.t);
      if (sweep == 0) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], s[k]);
      } else if (sweep == 1) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          sum[(k >> 1) & 1] += expf(s[k] - mx[(k >> 1) & 1]);
      } else {
        // p = exp(s - max) / sum, as the forward computes it
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int r = (k >> 1) & 1;
          const float p = div_rn(expf(s[k] - mx[r]), sum[r], rsum[r]);
          if (sweep == 2)
            dsum[r] += __fmul_rn(dp[k], p);
          else
            s[k] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[k], dsum[r])), scale);
        }
        if (sweep == 3) {
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
          // dQ += bf16(dS) K, this block's columns of K
          issue_nn<HV>(dq, a, st + sl * (HV / 64) * kBox);
          wg_commit();
          wg_wait<0>();
          fence_regs(dq);
        }
      }
      ring.release(i);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (sweep == 0) mx[r] = quad_max(mx[r]);
      if (sweep == 1) {
        sum[r] = quad_sum(sum[r]);
        rsum[r] = rcp_refined(sum[r]);
      }
      if (sweep == 2) dsum[r] = quad_sum(dsum[r]);
    }
  }
  const int r0 = q0 + c.wg * 64;
  store_tile<HV>(dq, qw, &dqkv_map, h * HD + sl * HV, r0, b, c);
  if (c.t == 0 && sl == 0) {
    const size_t n_rows =
        static_cast<size_t>(gridDim.z / kSlices) * heads * seq;
    const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + c.row + 8 * r;
      if (qi >= seq) continue;
      stats[head_row + qi] = mx[r];
      stats[n_rows + head_row + qi] = sum[r];
      stats[2 * n_rows + head_row + qi] = dsum[r];
    }
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int HD, int HV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkv_sm90(const __grid_constant__ CUtensorMap qkv_map,
                           const __grid_constant__ CUtensorMap g_map,
                           const __grid_constant__ CUtensorMap dqkv_map,
                           const float* __restrict__ stats, int seq,
                           int heads, float scale) {
  using L = DkvSmem<HD>;
  constexpr int kSlices = HD / HV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  const Ring<L::kStages> ring{bars + 1, bars + 1 + L::kStages};
  auto stage = [&](int i) {
    return smem + L::kStage0 + ring.stage(i) * L::kStage;
  };
  const int n_stat = stat_rows(seq);
  float* s_max = reinterpret_cast<float*>(smem + L::kStats);
  float* s_sum = s_max + n_stat;
  float* s_d = s_sum + n_stat;
  float* s_rcp = s_d + n_stat;
  const int wa = heads * HD;
  const int b = blockIdx.z / kSlices, sl = blockIdx.z % kSlices;
  const int h = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const int n_wg = active_warpgroups(k0, seq);
  const size_t n_rows =
      static_cast<size_t>(gridDim.z / kSlices) * heads * seq;
  const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
  for (int i = threadIdx.x; i < n_stat; i += blockDim.x) {
    const bool in = i < seq;
    s_max[i] = in ? stats[head_row + i] : 0.0f;
    s_sum[i] = in ? stats[n_rows + head_row + i] : 1.0f;
    s_d[i] = in ? stats[2 * n_rows + head_row + i] : 0.0f;
    s_rcp[i] = rcp_refined(s_sum[i]);
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 128 * n_wg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: K and V once, then Q and g chunks
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    mbar_expect_tx(kv_full, 2 * tile_bytes<HD>(kBlockRows));
    for (int c = 0; c < HD / 64; ++c)
      for (int r = 0; r < kBlockRows / kTileRows; ++r) {
        const int off = c * kBlockSub + r * kBox;
        tma_load_3d(smem + L::kK + off, &qkv_map, kv_full,
                    wa + h * HD + 64 * c, k0 + r * kTileRows, b);
        tma_load_3d(smem + L::kV + off, &qkv_map, kv_full,
                    2 * wa + h * HD + 64 * c, k0 + r * kTileRows, b);
      }
    for (int i = 0; i < ntiles; ++i) {
      uint64_t* full =
          ring.producer_acquire(i, 2 * tile_bytes<HD>(kTileRows));
      unsigned char* st = stage(i);
      for (int c = 0; c < HD / 64; ++c) {
        tma_load_3d(st + c * kBox, &qkv_map, full, h * HD + 64 * c,
                    i * kTileRows, b);
        tma_load_3d(st + L::kG + c * kBox, &g_map, full, h * HD + 64 * c,
                    i * kTileRows, b);
      }
    }
    return;
  }

  // ---- consumers: 64 key rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  if (c.wg >= n_wg) return;
  unsigned char* kw = smem + L::kK + c.wg * kBox;
  unsigned char* vw = smem + L::kV + c.wg * kBox;
  const uint64_t kd = desc_k(kw), vd = desc_k(vw);
  float st_[32], dpt[32], dk[HV / 2], dv[HV / 2];
  zero(st_);
  zero(dpt);
  zero(dk);
  zero(dv);
  mbar_wait(kv_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    ring.consumer_wait(i);
    const unsigned char* st = stage(i);
    issue_nt<HD>(st_, kd, kBlockSub, st);           // S^T = K Q^T
    issue_nt<HD>(dpt, vd, kBlockSub, st + L::kG);   // dP^T = V g^T
    wg_commit();
    wg_wait<0>();
    fence_regs(st_);
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * j + e;
        const int qi = i * kTileRows + 8 * j + 2 * c.t + (e & 1);
        float p = div_rn(expf(__fmul_rn(st_[k], scale) - s_max[qi]),
                         s_sum[qi], s_rcp[qi]);
        p = qi < seq ? p : 0.0f;
        st_[k] = p;
        dpt[k] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[k], s_d[qi])), scale);
      }
    uint32_t ap[4][4], ads[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(ap[kk], st_, kk);
      acc_to_a(ads[kk], dpt, kk);
    }
    // dV += bf16(P^T) g and dK += bf16(dS^T) Q, this block's columns
    const int cs = sl * (HV / 64) * kBox;
    issue_nn<HV>(dv, ap, st + L::kG + cs);
    issue_nn<HV>(dk, ads, st + cs);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    ring.release(i);
  }
  store_tile<HV>(dk, kw, &dqkv_map, wa + h * HD + sl * HV, k0 + c.wg * 64,
                 b, c);
  store_tile<HV>(dv, vw, &dqkv_map, 2 * wa + h * HD + sl * HV,
                 k0 + c.wg * 64, b, c);
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int HD>
int launch_bwd(const void* qkv, const void* gout, void* dqkv, void* stats,
               int batch, int seq, int heads, float scale,
               cudaStream_t stream) {
  const int wa = heads * HD;
  const size_t smem_dkv = DkvSmem<HD>::bytes(stat_rows(seq));
  if (seq > kMaxSeqBwd || smem_dkv > kMaxBlockSmem)
    return cudaErrorInvalidValue;
  CUtensorMap qkv_map, g_map, dqkv_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * wa, seq, batch, kTileRows) ||
      !map_bf16_3d(&g_map, gout, wa, seq, batch, kTileRows) ||
      !map_bf16_3d(&dqkv_map, dqkv, 3 * wa, seq, batch, kTileRows))
    return cudaErrorInvalidValue;
  constexpr int HV = bwd_slice<HD>();
  static const cudaError_t attr = [] {
    if (!registers_suffice(attention_bwd_dq_sm90<HD, HV>) ||
        !registers_suffice(attention_bwd_dkv_sm90<HD, HV>))
      return cudaErrorInvalidDeviceFunction;
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_sm90<HD, HV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(DqSmem<HD>::kBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_bwd_dkv_sm90<HD, HV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxBlockSmem));
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (static_cast<long long>(batch) * (HD / HV) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads,
                  batch * (HD / HV));
  attention_bwd_dq_sm90<HD, HV>
      <<<grid, kThreads, DqSmem<HD>::kBytes, stream>>>(
          qkv_map, g_map, dqkv_map, static_cast<float*>(stats), seq, heads,
          scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_sm90<HD, HV><<<grid, kThreads, smem_dkv, stream>>>(
      qkv_map, g_map, dqkv_map, static_cast<const float*>(stats), seq, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ K10, wide heads

// Heads of 384 to 1280: the dq block's Q and g (192 KB at 384) and the dkv
// block's K and V no longer fit, so the rows a block owns stream too, in
// 64-column chunks beside the other side's chunks, and each block owns one
// 128-column slice of dq, or of dk and dv. The sweeps, the exact softmax
// and D from the unrounded P are the narrow kernels'; S and dP are summed
// over the head's chunks, and the slice a product reads (K for dQ; Q and g
// for dK and dV) rides on a tile's last chunk. The output leaves through
// its own staging tile.
struct WideDqSmem {
  static constexpr int kStages = 2;
  static constexpr int kQ = 0;                     // Q chunk: 128 x 64
  static constexpr int kK = kBlockSub;             // K chunk: 64 x 64
  static constexpr int kG = kK + kBox;             // g chunk: 128 x 64
  static constexpr int kV = kG + kBlockSub;        // V chunk: 64 x 64
  static constexpr int kKs = kV + kBox;            // K slice: 64 x 128
  static constexpr int kStage = kKs + 2 * kBox;
  static constexpr int kOut = kStages * kStage;    // dq: 128 x 128
  static constexpr int kBars = kOut + 2 * kBlockSub;
  static constexpr size_t kBytes = kBars + 8 * 2 * kStages + 1024;
};

struct WideDkvSmem {
  static constexpr int kStages = 2;
  static constexpr int kK = 0;                     // K chunk: 128 x 64
  static constexpr int kV = kBlockSub;             // V chunk: 128 x 64
  static constexpr int kQ = 2 * kBlockSub;         // Q chunk: 64 x 64
  static constexpr int kG = kQ + kBox;             // g chunk: 64 x 64
  static constexpr int kQs = kG + kBox;            // Q slice: 64 x 128
  static constexpr int kGs = kQs + 2 * kBox;       // g slice: 64 x 128
  static constexpr int kStage = kGs + 2 * kBox;
  static constexpr int kOut = kStages * kStage;    // dk, then dv: 128 x 128
  static constexpr int kBars = kOut + 2 * kBlockSub;
  static constexpr int kStats = kBars + 128;
  static size_t bytes(int n_stat) {
    return kStats + 16 * static_cast<size_t>(n_stat) + 1024;
  }
};

// grid: (query tiles, heads, image x slice of dq); the statistics written
// by slice 0
template <int HV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_wide_sm90(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const __grid_constant__ CUtensorMap dqkv_map,
                               float* __restrict__ stats, int seq, int heads,
                               int hd, float scale) {
  using L = WideDqSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const Ring<L::kStages> ring{bars, bars + L::kStages};
  auto stage = [&](int i) { return smem + ring.stage(i) * L::kStage; };
  const int wa = heads * hd, n_ch = hd / 64, n_sl = hd / HV;
  const int b = blockIdx.z / n_sl, sl = blockIdx.z % n_sl;
  const int h = blockIdx.y, q0 = blockIdx.x * kBlockRows;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const int n_wg = active_warpgroups(q0, seq);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 128 * n_wg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: per sweep and key tile, the head's chunks of Q and K
    // (and from sweep 2 of g and V); the K slice on sweep 3's last chunks
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    int i = 0;
    for (int sweep = 0; sweep < 4; ++sweep)
      for (int t = 0; t < ntiles; ++t)
        for (int ch = 0; ch < n_ch; ++ch, ++i) {
          const bool last = ch == n_ch - 1, with_g = sweep >= 2;
          const int k0 = t * kTileRows, col = h * hd + 64 * ch;
          uint64_t* full = ring.producer_acquire(
              i, 3 * kBox + (with_g ? 3 * kBox : 0) +
                     (sweep == 3 && last ? 2 * kBox : 0));
          unsigned char* st = stage(i);
          for (int rr = 0; rr < 2; ++rr)
            tma_load_3d(st + L::kQ + rr * kBox, &qkv_map, full, col,
                        q0 + rr * kTileRows, b);
          tma_load_3d(st + L::kK, &qkv_map, full, wa + col, k0, b);
          if (with_g) {
            for (int rr = 0; rr < 2; ++rr)
              tma_load_3d(st + L::kG + rr * kBox, &g_map, full, col,
                          q0 + rr * kTileRows, b);
            tma_load_3d(st + L::kV, &qkv_map, full, 2 * wa + col, k0, b);
          }
          if (sweep == 3 && last)
            for (int v = 0; v < 2; ++v)
              tma_load_3d(st + L::kKs + v * kBox, &qkv_map, full,
                          wa + h * hd + sl * HV + 64 * v, k0, b);
        }
    return;
  }

  // ---- consumers: 64 query rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  if (c.wg >= n_wg) return;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float dsum[2] = {0.0f, 0.0f}, rsum[2] = {1.0f, 1.0f};
  float s[32], dp[32], dq[HV / 2];
  zero(s);
  zero(dp);
  zero(dq);
  int i = 0;
  for (int sweep = 0; sweep < 4; ++sweep) {
    for (int t = 0; t < ntiles; ++t) {
      for (int ch = 0; ch < n_ch; ++ch) {
        ring.consumer_wait(i);
        const unsigned char* st = stage(i);
        issue_nt_chunk(s, desc_k(st + L::kQ + c.wg * kBox), st + L::kK,
                       ch > 0);
        if (sweep >= 2)
          issue_nt_chunk(dp, desc_k(st + L::kG + c.wg * kBox), st + L::kV,
                         ch > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (ch + 1 < n_ch) ring.release(i++);
      }
      const unsigned char* st = stage(i);
      mask_scores(s, t * kTileRows, seq, nullptr, scale, c.t);
      if (sweep == 0) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], s[k]);
      } else if (sweep == 1) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          sum[(k >> 1) & 1] += expf(s[k] - mx[(k >> 1) & 1]);
      } else {
        // p = exp(s - max) / sum, as the forward computes it
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int r = (k >> 1) & 1;
          const float p = div_rn(expf(s[k] - mx[r]), sum[r], rsum[r]);
          if (sweep == 2)
            dsum[r] += __fmul_rn(dp[k], p);
          else
            s[k] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[k], dsum[r])), scale);
        }
        if (sweep == 3) {
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
          // dQ += bf16(dS) K, this block's columns of K
          issue_nn<HV>(dq, a, st + L::kKs);
          wg_commit();
          wg_wait<0>();
          fence_regs(dq);
        }
      }
      ring.release(i++);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (sweep == 0) mx[r] = quad_max(mx[r]);
      if (sweep == 1) {
        sum[r] = quad_sum(sum[r]);
        rsum[r] = rcp_refined(sum[r]);
      }
      if (sweep == 2) dsum[r] = quad_sum(dsum[r]);
    }
  }
  const int r0 = q0 + c.wg * 64;
  store_tile<HV>(dq, smem + L::kOut + c.wg * kBox, &dqkv_map,
                 h * hd + sl * HV, r0, b, c);
  if (c.t == 0 && sl == 0) {
    const size_t n_rows = static_cast<size_t>(gridDim.z / n_sl) * heads * seq;
    const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + c.row + 8 * r;
      if (qi >= seq) continue;
      stats[head_row + qi] = mx[r];
      stats[n_rows + head_row + qi] = sum[r];
      stats[2 * n_rows + head_row + qi] = dsum[r];
    }
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

template <int HV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkv_wide_sm90(const __grid_constant__ CUtensorMap qkv_map,
                                const __grid_constant__ CUtensorMap g_map,
                                const __grid_constant__ CUtensorMap dqkv_map,
                                const float* __restrict__ stats, int seq,
                                int heads, int hd, float scale) {
  using L = WideDkvSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const Ring<L::kStages> ring{bars, bars + L::kStages};
  auto stage = [&](int i) { return smem + ring.stage(i) * L::kStage; };
  const int n_stat = stat_rows(seq);
  float* s_max = reinterpret_cast<float*>(smem + L::kStats);
  float* s_sum = s_max + n_stat;
  float* s_d = s_sum + n_stat;
  float* s_rcp = s_d + n_stat;
  const int wa = heads * hd, n_ch = hd / 64, n_sl = hd / HV;
  const int b = blockIdx.z / n_sl, sl = blockIdx.z % n_sl;
  const int h = blockIdx.y, k0 = blockIdx.x * kBlockRows;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const int n_wg = active_warpgroups(k0, seq);
  const size_t n_rows = static_cast<size_t>(gridDim.z / n_sl) * heads * seq;
  const size_t head_row = (static_cast<size_t>(b) * heads + h) * seq;
  for (int i = threadIdx.x; i < n_stat; i += blockDim.x) {
    const bool in = i < seq;
    s_max[i] = in ? stats[head_row + i] : 0.0f;
    s_sum[i] = in ? stats[n_rows + head_row + i] : 1.0f;
    s_d[i] = in ? stats[2 * n_rows + head_row + i] : 0.0f;
    s_rcp[i] = rcp_refined(s_sum[i]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 128 * n_wg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: per query chunk, the head's chunks of K, V, Q and g;
    // the Q and g slices on each chunk's last
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    int j = 0;
    for (int i = 0; i < ntiles; ++i)
      for (int ch = 0; ch < n_ch; ++ch, ++j) {
        const bool last = ch == n_ch - 1;
        const int col = h * hd + 64 * ch, r0 = i * kTileRows;
        uint64_t* full =
            ring.producer_acquire(j, 6 * kBox + (last ? 4 * kBox : 0));
        unsigned char* st = stage(j);
        for (int rr = 0; rr < 2; ++rr) {
          tma_load_3d(st + L::kK + rr * kBox, &qkv_map, full, wa + col,
                      k0 + rr * kTileRows, b);
          tma_load_3d(st + L::kV + rr * kBox, &qkv_map, full, 2 * wa + col,
                      k0 + rr * kTileRows, b);
        }
        tma_load_3d(st + L::kQ, &qkv_map, full, col, r0, b);
        tma_load_3d(st + L::kG, &g_map, full, col, r0, b);
        if (last)
          for (int v = 0; v < 2; ++v) {
            const int sc = h * hd + sl * HV + 64 * v;
            tma_load_3d(st + L::kQs + v * kBox, &qkv_map, full, sc, r0, b);
            tma_load_3d(st + L::kGs + v * kBox, &g_map, full, sc, r0, b);
          }
      }
    return;
  }

  // ---- consumers: 64 key rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  if (c.wg >= n_wg) return;
  float st_[32], dpt[32], dk[HV / 2], dv[HV / 2];
  zero(st_);
  zero(dpt);
  zero(dk);
  zero(dv);
  int j = 0;
  for (int i = 0; i < ntiles; ++i) {
    for (int ch = 0; ch < n_ch; ++ch) {
      ring.consumer_wait(j);
      const unsigned char* st = stage(j);
      // S^T = K Q^T and dP^T = V g^T, chunk by chunk
      issue_nt_chunk(st_, desc_k(st + L::kK + c.wg * kBox), st + L::kQ,
                     ch > 0);
      issue_nt_chunk(dpt, desc_k(st + L::kV + c.wg * kBox), st + L::kG,
                     ch > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(st_);
      fence_regs(dpt);
      if (ch + 1 < n_ch) ring.release(j++);
    }
    const unsigned char* st = stage(j);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * jj + e;
        const int qi = i * kTileRows + 8 * jj + 2 * c.t + (e & 1);
        float p = div_rn(expf(__fmul_rn(st_[k], scale) - s_max[qi]),
                         s_sum[qi], s_rcp[qi]);
        p = qi < seq ? p : 0.0f;
        st_[k] = p;
        dpt[k] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpt[k], s_d[qi])), scale);
      }
    uint32_t ap[4][4], ads[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(ap[kk], st_, kk);
      acc_to_a(ads[kk], dpt, kk);
    }
    // dV += bf16(P^T) g and dK += bf16(dS^T) Q, this block's columns
    issue_nn<HV>(dv, ap, st + L::kGs);
    issue_nn<HV>(dk, ads, st + L::kQs);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    ring.release(j++);
  }
  unsigned char* out = smem + L::kOut + c.wg * kBox;
  store_tile<HV>(dk, out, &dqkv_map, wa + h * hd + sl * HV, k0 + c.wg * 64,
                 b, c);
  store_tile<HV>(dv, out, &dqkv_map, 2 * wa + h * hd + sl * HV,
                 k0 + c.wg * 64, b, c);
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

int launch_bwd_wide(const void* qkv, const void* gout, void* dqkv,
                    void* stats, int batch, int seq, int heads, int hd,
                    float scale, cudaStream_t stream) {
  constexpr int HV = kWideSlice;
  const int wa = heads * hd;
  const size_t smem_dkv = WideDkvSmem::bytes(stat_rows(seq));
  if (seq > kMaxSeqBwd || smem_dkv > kMaxBlockSmem)
    return cudaErrorInvalidValue;
  CUtensorMap qkv_map, g_map, dqkv_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * wa, seq, batch, kTileRows) ||
      !map_bf16_3d(&g_map, gout, wa, seq, batch, kTileRows) ||
      !map_bf16_3d(&dqkv_map, dqkv, 3 * wa, seq, batch, kTileRows))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    if (!registers_suffice(attention_bwd_dq_wide_sm90<HV>) ||
        !registers_suffice(attention_bwd_dkv_wide_sm90<HV>))
      return cudaErrorInvalidDeviceFunction;
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_wide_sm90<HV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(WideDqSmem::kBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_bwd_dkv_wide_sm90<HV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxBlockSmem));
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (static_cast<long long>(batch) * (hd / HV) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads,
                  batch * (hd / HV));
  attention_bwd_dq_wide_sm90<HV>
      <<<grid, kThreads, WideDqSmem::kBytes, stream>>>(
          qkv_map, g_map, dqkv_map, static_cast<float*>(stats), seq, heads,
          hd, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_wide_sm90<HV><<<grid, kThreads, smem_dkv, stream>>>(
      qkv_map, g_map, dqkv_map, static_cast<const float*>(stats), seq, heads,
      hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpudf

// K9: out (B, S, Wa) bf16 from qkv (B, S, 3 Wa) bf16 and an optional f32
// key bias (B, S rounded up to 64), zero past S; head_dim 64, 128 or 256
// (16 and 32 arrive zero-padded to 64) or a wide one (384 .. 1280, the
// multiples of 128), S <= kMaxSeq, B * S <= kMaxRows, 16-byte aligned rows
TPUDF_API int tpudf_attention_qkv_sm90(const void* qkv, const void* key_bias,
                                       void* out, int batch, int seq,
                                       int heads, int head_dim, float scale,
                                       void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd<64, kOutBf16>(qkv, key_bias, out, nullptr, batch,
                                      seq, heads, 64, scale, s);
    case 128:
      return launch_fwd<128, kOutBf16>(qkv, key_bias, out, nullptr, batch,
                                       seq, heads, 128, scale, s);
    case 256:
      return launch_fwd<256, kOutBf16>(qkv, key_bias, out, nullptr, batch,
                                       seq, heads, 256, scale, s);
  }
  if (wide_head(head_dim))
    return launch_fwd_wide<kOutBf16>(qkv, key_bias, out, nullptr, batch, seq,
                                     heads, head_dim, scale, s);
  return cudaErrorInvalidValue;
}

// K1's attention: o8 (B * S, heads * head_stride) int8, the codes of the
// f32 o clip(round(o * 127 / act[0]), +-127), from qkv (B, S, 3 * heads *
// head_stride) bf16 and an optional f32 key bias (B, S rounded up to 64);
// width, the tile a head runs on: 64, 128 or 256 (head_stride the same;
// 16 and 32 arrive zero-padded to 64), 80 (head_stride 128: the first 80
// columns of each head read, codes 0 in its columns 80 .. 127), or a wide
// head_dim (384 .. 1280, head_stride the same); S <= kMaxSeq. exact: K9's
// softmax sequence in place of K1's (K7's split form; not at width 80)
TPUDF_API int tpudf_attention_i8_sm90(const void* qkv, const void* key_bias,
                                      const void* act, void* o8, int batch,
                                      int seq, int heads, int head_stride,
                                      int width, float scale, int exact,
                                      void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || act == nullptr ||
      (width == 80 ? head_stride != 128 || exact : head_stride != width))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    switch (width) {
      case 64:
        return launch_fwd<64, kOutI8Exact>(qkv, key_bias, o8, act, batch,
                                           seq, heads, 64, scale, s);
      case 128:
        return launch_fwd<128, kOutI8Exact>(qkv, key_bias, o8, act, batch,
                                            seq, heads, 128, scale, s);
      case 256:
        return launch_fwd<256, kOutI8Exact>(qkv, key_bias, o8, act, batch,
                                            seq, heads, 256, scale, s);
    }
    if (wide_head(width))
      return launch_fwd_wide<kOutI8Exact>(qkv, key_bias, o8, act, batch, seq,
                                          heads, width, scale, s);
    return cudaErrorInvalidValue;
  }
  switch (width) {
    case 64:
      return launch_fwd<64, kOutI8>(qkv, key_bias, o8, act, batch, seq,
                                    heads, 64, scale, s);
    case 80:
      return launch_fwd<80, kOutI8>(qkv, key_bias, o8, act, batch, seq,
                                    heads, 128, scale, s);
    case 128:
      return launch_fwd<128, kOutI8>(qkv, key_bias, o8, act, batch, seq,
                                     heads, 128, scale, s);
    case 256:
      return launch_fwd<256, kOutI8>(qkv, key_bias, o8, act, batch, seq,
                                     heads, 256, scale, s);
  }
  if (wide_head(width))
    return launch_fwd_wide<kOutI8>(qkv, key_bias, o8, act, batch, seq, heads,
                                   width, scale, s);
  return cudaErrorInvalidValue;
}

// K10: dqkv (B, S, 3 Wa) bf16 from qkv and g (B, S, Wa) bf16; stats: a (3,
// B, heads, S) f32 scratch; head_dim 64, 128 or 256 (16 and 32 arrive
// zero-padded to 64) or a wide one (384 .. 1280), S <= kMaxSeqBwd
TPUDF_API int tpudf_attention_qkv_bwd_sm90(const void* qkv, const void* gout,
                                           void* dqkv, void* stats,
                                           int batch, int seq, int heads,
                                           int head_dim, float scale,
                                           void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_bwd<64>(qkv, gout, dqkv, stats, batch, seq, heads, scale,
                          s);
  if (head_dim == 128)
    return launch_bwd<128>(qkv, gout, dqkv, stats, batch, seq, heads, scale,
                           s);
  if (head_dim == 256)
    return launch_bwd<256>(qkv, gout, dqkv, stats, batch, seq, heads, scale,
                           s);
  if (wide_head(head_dim))
    return launch_bwd_wide(qkv, gout, dqkv, stats, batch, seq, heads,
                           head_dim, scale, s);
  return cudaErrorInvalidValue;
}

// dynamic shared bytes of a launch at head_dim hd and sequence seq: which 0
// K9, 1 K10's dq pass, 2 its dkv pass
template <int HD>
int sm90_smem(int which, int seq) {
  using namespace tpudf;
  if (which == 0) return static_cast<int>(FwdSmem<HD>::kBytes);
  if (which == 1) return static_cast<int>(DqSmem<HD>::kBytes);
  return static_cast<int>(DkvSmem<HD>::bytes(stat_rows(seq)));
}

TPUDF_API int tpudf_sm90_smem(int which, int hd, int seq) {
  using namespace tpudf;
  if (hd == 64) return sm90_smem<64>(which, seq);
  if (hd == 128) return sm90_smem<128>(which, seq);
  if (hd == 256) return sm90_smem<256>(which, seq);
  if (!wide_head(hd)) return -1;
  if (which == 0) return static_cast<int>(WideFwdSmem::kBytes);
  if (which == 1) return static_cast<int>(WideDqSmem::kBytes);
  return static_cast<int>(WideDkvSmem::bytes(stat_rows(seq)));
}

// the host's cost of a K9 launch's tensor map: mean ns of `reps` encodes
// of the map over a (4, 1024, 6144) bf16 qkv at `base` (never read)
TPUDF_API int tpudf_sm90_encode_ns(const void* base, int reps) {
  using namespace tpudf;
  CUtensorMap m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!sm90::map_bf16_3d(&m, base, 6144, 1024, 4, kTileRows)) return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return static_cast<int>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
      (reps > 0 ? reps : 1));
}
