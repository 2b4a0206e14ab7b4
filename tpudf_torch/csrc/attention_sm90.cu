// K9 and K10 on Hopper's own machinery: wgmma products and TMA loads
// through mbarrier rings (sm90.cuh).
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

#include "sm90.cuh"

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

// ----------------------------------------------------------------- K9

// shared memory: fwd_q_bufs Q buffers (128 rows each), then kStages
// stages of a K tile, a V tile and the bias tile (64 f32, padded to 1
// KB), then the barriers
template <int HD>
struct FwdSmem {
  static constexpr int kStages = fwd_stages<HD>();
  static constexpr int kQBufs = fwd_q_bufs<HD>();
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kQBufs * tile_bytes<HD>(kBlockRows);
  static constexpr int kV = tile_bytes<HD>(kTileRows);
  static constexpr int kBias = 2 * tile_bytes<HD>(kTileRows);
  static constexpr int kStage = kBias + 1024;
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;
};


// s = (q . k) * scale (+ bias) in f32, -inf for keys k0 + .. past seq;
// the mask only on a ragged tile, as selects
__device__ __forceinline__ void mask_scores(float (&s)[32], int k0, int seq,
                                            const float* bias, float scale,
                                            int t) {
  const float neg_inf = __int_as_float(0xff800000);
  if (bias != nullptr) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      s[k] = __fadd_rn(__fmul_rn(s[k], scale),
                       bias[8 * (k >> 2) + 2 * t + (k & 1)]);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = __fmul_rn(s[k], scale);
  }
  if (k0 + kTileRows > seq) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      s[k] = k0 + 8 * (k >> 2) + 2 * t + (k & 1) < seq ? s[k] : neg_inf;
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
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_sm90(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap bias_map,
                       const __grid_constant__ CUtensorMap out_map,
                       int has_bias, int batch, int seq, int heads,
                       float scale) {
  using L = FwdSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;            // two slots each (kQBufs used)
  uint64_t* q_empty = bars + 2;
  const Ring<L::kStages> ring{bars + 4, bars + 4 + L::kStages};
  auto stage = [&](int r) {
    return smem + L::kStage0 + ring.stage(r) * L::kStage;
  };
  const int wa = heads * HD;
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
    const uint32_t k_bytes = tile_bytes<HD>(kTileRows) + (has_bias ? 256 : 0);
    int r = 0;
    for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
      const FwdItem w = fwd_item(it, n_qt, heads);
      const int qb = n % L::kQBufs, round = n / L::kQBufs;
      if (round > 0) mbar_wait(&q_empty[qb], (round - 1) & 1);
      mbar_expect_tx(&q_full[qb], tile_bytes<HD>(kBlockRows));
      unsigned char* q = smem + L::kQ + qb * tile_bytes<HD>(kBlockRows);
      for (int c = 0; c < HD / 64; ++c)
        for (int rr = 0; rr < kBlockRows / kTileRows; ++rr)
          tma_load_3d(q + c * kBlockSub + rr * kBox, &qkv_map, &q_full[qb],
                      w.h * HD + 64 * c, w.q0 + rr * kTileRows, w.b);
      for (int i = 0; i < 2 * ntiles; ++i, ++r) {
        const bool pass2 = i >= ntiles;
        const int k0 = (pass2 ? i - ntiles : i) * kTileRows;
        uint64_t* full = ring.producer_acquire(
            r, k_bytes + (pass2 ? tile_bytes<HD>(kTileRows) : 0));
        unsigned char* st = stage(r);
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(st + c * kBox, &qkv_map, full, wa + w.h * HD + 64 * c,
                      k0, w.b);
          if (pass2)
            tma_load_3d(st + L::kV + c * kBox, &qkv_map, full,
                        2 * wa + w.h * HD + 64 * c, k0, w.b);
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
  float s[32], o[HD / 2];
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
    unsigned char* qw =
        smem + L::kQ + qb * tile_bytes<HD>(kBlockRows) + c.wg * kBox;
    const uint64_t qd = desc_k(qw);
    float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};

    // pass 1: the row max and the row sum, online over the K tiles
    for (int t = 0; t < ntiles; ++t) {
      ring.consumer_wait(r + t);
      issue_nt<HD>(s, qd, kBlockSub, stage(r + t));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      mask_scores(s, t * kTileRows, seq, bias_of(r + t), scale, c.t);
      ring.release(r + t);
      float tm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int k = 0; k < 32; ++k)
        tm[(k >> 1) & 1] = fmaxf(tm[(k >> 1) & 1], s[k]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        tm[q] = quad_max(tm[q]);
        if (tm[q] != mx[q]) sum[q] *= expf(mx[q] - tm[q]);
        mx[q] = tm[q];
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        sum[(k >> 1) & 1] += expf(s[k] - mx[(k >> 1) & 1]);
    }
    r += ntiles;
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float rsum[2] = {rcp_refined(sum[0]), rcp_refined(sum[1])};

    // pass 2: p = exp(s - m) / l, o += bf16(p) . v; tile t's p is formed
    // while tile t - 1's p . v runs
    auto form_p = [&](int t) {
      mask_scores(s, t * kTileRows, seq, bias_of(r + t), scale, c.t);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        s[k] = div_rn(expf(s[k] - mx[(k >> 1) & 1]), sum[(k >> 1) & 1],
                      rsum[(k >> 1) & 1]);
    };
    zero(o);
    uint32_t a[4][4];
    ring.consumer_wait(r);
    issue_nt<HD>(s, qd, kBlockSub, stage(r));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    form_p(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    for (int t = 1; t < ntiles; ++t) {
      ring.consumer_wait(r + t);
      issue_nt<HD>(s, qd, kBlockSub, stage(r + t));
      wg_commit();
      issue_nn<HD>(o, a, stage(r + t - 1) + L::kV);
      wg_commit();
      wg_wait<1>();                   // tile t's scores; t - 1's p . v runs
      fence_regs(s);
      form_p(t);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(a);
      ring.release(r + t - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
    }
    issue_nn<HD>(o, a, stage(r + ntiles - 1) + L::kV);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    ring.release(r + ntiles - 1);
    r += ntiles;
    // o through this warpgroup's rows of the Q buffer, then Q is free
    store_tile<HD>(o, qw, &out_map, w.h * HD, w.q0 + c.wg * 64, w.b, c);
    mbar_arrive(&q_empty[qb]);
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}


template <int HD>
int launch_fwd(const void* qkv, const void* key_bias, void* out, int batch,
               int seq, int heads, float scale, cudaStream_t stream) {
  const int wa = heads * HD;
  CUtensorMap qkv_map, bias_map, out_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * wa, seq, batch, kTileRows) ||
      !map_bf16_3d(&out_map, out, wa, seq, batch, kTileRows))
    return cudaErrorInvalidValue;
  if (key_bias != nullptr) {
    // the bias rows padded to whole tiles, so that every box starts on a
    // 256-byte boundary (boxes that started off a 16-byte one, at b * S
    // floats with S % 4 != 0, faulted on the card: CUDA error 715)
    const long long rows = static_cast<long long>(batch) *
                           ((seq + kTileRows - 1) / kTileRows) * kTileRows;
    if (rows > kMaxRows ||
        !map_f32_1d(&bias_map, key_bias, static_cast<uint64_t>(rows),
                    kTileRows))
      return cudaErrorInvalidValue;
  } else {
    bias_map = qkv_map;                     // never read
  }
  static const cudaError_t attr =
      registers_suffice(attention_fwd_sm90<HD>)
          ? cudaFuncSetAttribute(attention_fwd_sm90<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(FwdSmem<HD>::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long n_items = static_cast<long long>(
      (seq + kBlockRows - 1) / kBlockRows) * heads * batch;
  if (n_items > 2147483647ll) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(n_items, sm_count()));
  attention_fwd_sm90<HD><<<grid, kThreads, FwdSmem<HD>::kBytes, stream>>>(
      qkv_map, bias_map, out_map, key_bias != nullptr, batch, seq, heads,
      scale);
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

}  // namespace
}  // namespace tpudf

// K9: out (B, S, Wa) bf16 from qkv (B, S, 3 Wa) bf16 and an optional f32
// key bias (B, S rounded up to 64), zero past S; head_dim 64, 128 or 256
// (16 and 32 arrive zero-padded to 64), S <= kMaxSeq, B * S <= kMaxRows,
// 16-byte aligned rows
TPUDF_API int tpudf_attention_qkv_sm90(const void* qkv, const void* key_bias,
                                       void* out, int batch, int seq,
                                       int heads, int head_dim, float scale,
                                       void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_fwd<64>(qkv, key_bias, out, batch, seq, heads, scale, s);
  if (head_dim == 128)
    return launch_fwd<128>(qkv, key_bias, out, batch, seq, heads, scale, s);
  if (head_dim == 256)
    return launch_fwd<256>(qkv, key_bias, out, batch, seq, heads, scale, s);
  return cudaErrorInvalidValue;
}

// K10: dqkv (B, S, 3 Wa) bf16 from qkv and g (B, S, Wa) bf16; stats: a (3,
// B, heads, S) f32 scratch; head_dim 64, 128 or 256 (16 and 32 arrive
// zero-padded to 64), S <= kMaxSeqBwd
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
  if (hd == 64) return sm90_smem<64>(which, seq);
  if (hd == 128) return sm90_smem<128>(which, seq);
  if (hd == 256) return sm90_smem<256>(which, seq);
  return -1;
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
