// K6's tile on wgmma and TMA: the attention of one 128-query row tile of
// one image, its int8 codes, and the int8 out-projection of those codes,
// by a thread-block cluster. Shared by K6 (attention.cu) and K7's
// attention phase (layer_int8.cu).
//
// The work of a row tile is split over the C CTAs of a cluster (C <= 8):
// - CTA rank k takes heads k, k + C, ...: each head as K1's attention
//   launch computes it (attention_sm90.cu, `attention_fwd_sm90<W,
//   kOutI8>`): Q of the head's 128 rows, then its K tiles (pass 1: the
//   row max and sum, online) and its K and V tiles (pass 2: p = 2^(s - m)
//   r rounded to bf16, o += p . v), 64 keys a tile through a TMA ring,
//   both products on wgmma, the scores carrying log2 e (K7's attention
//   phase takes K9's exact softmax instead: expf and the division); the
//   f32 o is quantised to int8 codes, clip(round(o * 127 / act), +-127);
// - the codes go into the o PANEL of every CTA of the cluster: 128 rows x
//   Wa bytes in the 128-byte swizzle that wgmma's K-major descriptor
//   reads (i8_sm90.cuh's panel layout), written by generic stores from
//   the accumulators, to the other CTAs through distributed shared memory
//   (`mapa`), fenced to the async proxy; a cluster barrier (release /
//   acquire) then makes every panel whole;
// - CTA rank k then computes the out-projection's 128-column tiles k, k +
//   C, ... against its whole panel: the weight (N, Wa) streams through a
//   TMA ring in 128 x 128 boxes, wgmma s8 sums exactly in int32, and the
//   epilogue (dequant + bias + residual: bf16 for K6, K7's f32 mid-layer
//   residual) stores from the registers. The codes never reach device
//   memory.
// The int32 sums are exact and each head's codes come from the same
// instructions as K1's attention launch, so the output equals K1's
// attention launch followed by the int8 GEMM in GEMM_RESIDUAL mode bit for
// bit, whatever C is.
//
// A block is sm90.cuh's warp-specialised block: two consumer warpgroups of
// 64 rows (wgmma's M) and a producer warpgroup whose first thread issues
// every TMA load. W, the tile's width, is the head's columns in qkv (64,
// 128 or 256; heads of 16 and 32 arrive zero-padded to 64, as K1's); a
// head's live columns (the panel's share of it) may be fewer.
#pragma once

#include "attn_sm90.cuh"
#include "i8_sm90.cuh"

namespace tpudf {
namespace sm90 {

constexpr int kAoMaxCluster = 8;     // the portable cluster size
// the registers of a thread after setmaxnreg in K6's and K7's blocks: the
// producer's loop over a unit's heads and column tiles holds more than
// sm90.cuh's 24 (ptxas spilled it there); the same total as kProducerRegs
// and kConsumerRegs
constexpr int kAoProducerRegs = 40;
constexpr int kAoConsumerRegs = 232;
static_assert(128 * kAoProducerRegs + kWarpgroups * 128 * kAoConsumerRegs ==
                  128 * kProducerRegs + kWarpgroups * 128 * kConsumerRegs,
              "K6's register split");

// ---------------------------------------------------------- clusters

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

// the cluster-wide barrier, in its two halves: every thread of every CTA
// arrives (release: its writes before, remote ones included, are seen by
// the threads that wait) and later waits (acquire), once a phase
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of `p`'s byte in the shared memory of the cluster's CTA
// `rank` (a generic address: plain stores reach it)
__device__ __forceinline__ unsigned char* map_rank(unsigned char* p,
                                                   int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<unsigned char*>(out);
}

// generic stores, local and remote, made visible to the async proxy (the
// wgmma that reads the panels)
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---------------------------------------------------------- the tile

// what the tile computes: qkv (B, S, 3 heads hs) bf16 through `qkv_map`
// (boxes of 64 x 64), the weight (N, heads live) int8 through `w_map`
// (boxes of 128 x 128), its per-column scale and bias, act the codes'
// activation scale; the residual and the output (B S, N) row-major
struct AoArgs {
  const float* act;
  const float* col_scale;
  const float* bias;
  const void* residual;
  void* out;
  int seq, heads, live, n_out;
  float scale;
};

// where a block keeps the tile: the panel, the Q buffer and its barriers,
// the attention ring (K then V tiles, `a_stride` bytes a stage) and the
// weight ring (a 16 KB box at the start of each `w_stride` bytes). K6's
// weight ring reuses the Q buffer and the attention ring (the producer
// first waits for their last reads), its stages 16 KB apart; K7's two
// rings are one ring whose stages hold a K and a V tile or a weight box
// (kOneRing: `wring` unused).
struct AoSmem {
  unsigned char* panel;
  unsigned char* q;
  uint64_t* q_full;
  uint64_t* q_empty;
  RingN aring;
  unsigned char* a_base;
  int a_stride;
  RingN wring;
  unsigned char* w_base;
  int w_stride;
};

// a block's running counts across its units: Q buffers used, items of the
// attention ring and of the weight ring (K7: `ra` counts its one ring)
struct AoCounts {
  int nq, ra, rw;
};

template <bool kOneRing>
__device__ __forceinline__ const RingN& w_ring(const AoSmem& m) {
  if constexpr (kOneRing) return m.aring;
  else return m.wring;
}

template <bool kOneRing>
__device__ __forceinline__ int& w_count(AoCounts& n) {
  if constexpr (kOneRing) return n.ra;
  else return n.rw;
}

// the producer's first thread: the unit (image b, rows q0 ..) of cluster
// rank `rank` of `csize`: each of its heads' Q, K and V tiles, then the
// weight boxes of its column tiles; it arrives on the cluster barrier that
// closes the panels before it waits for any release of the weight ring,
// and waits on it before it returns
template <int W, bool kOneRing>
__device__ __forceinline__ void ao_load(const AoArgs& p, const AoSmem& m,
                                        AoCounts& n,
                                        const CUtensorMap* qkv_map,
                                        const CUtensorMap* w_map, int b,
                                        int q0, int rank, int csize) {
  const int hs = W, wa3 = p.heads * hs;
  const int ntiles = (p.seq + kTileRows - 1) / kTileRows;
  for (int h = rank; h < p.heads; h += csize, ++n.nq) {
    if (n.nq > 0) mbar_wait(m.q_empty, (n.nq - 1) & 1);
    mbar_expect_tx(m.q_full, tile_bytes<W>(kBlockRows));
    for (int rr = 0; rr < kBlockRows / kTileRows; ++rr)
      for (int c = 0; c < W / 64; ++c)
        tma_load_3d(m.q + c * kBlockSub + rr * kBox, qkv_map, m.q_full,
                    h * hs + 64 * c, q0 + rr * kTileRows, b);
    for (int i = 0; i < 2 * ntiles; ++i, ++n.ra) {
      const bool pass2 = i >= ntiles;
      const int k0 = (pass2 ? i - ntiles : i) * kTileRows;
      uint64_t* full = m.aring.producer_acquire(
          n.ra, tile_bytes<W>(kTileRows) * (pass2 ? 2 : 1));
      unsigned char* st = m.a_base + m.aring.stage(n.ra) * m.a_stride;
      for (int c = 0; c < W / 64; ++c) {
        tma_load_3d(st + c * kBox, qkv_map, full, wa3 + h * hs + 64 * c, k0,
                    b);
        if (pass2)
          tma_load_3d(st + tile_bytes<W>(kTileRows) + c * kBox, qkv_map, full,
                      2 * wa3 + h * hs + 64 * c, k0, b);
      }
    }
  }
  cluster_arrive();                     // this thread writes no panel
  if constexpr (!kOneRing) {
    // the weight ring reuses the Q buffer and the attention ring: wait for
    // their last reads
    for (int i = max(0, n.ra - m.aring.n); i < n.ra; ++i)
      mbar_wait(&m.aring.empty[i % m.aring.n], (i / m.aring.n) & 1);
    if (n.nq > 0) mbar_wait(m.q_empty, (n.nq - 1) & 1);
  }
  int& rw = w_count<kOneRing>(n);
  const RingN& wr = w_ring<kOneRing>(m);
  const int nk = (p.heads * p.live + kQK - 1) / kQK;
  for (int tn = rank; tn < p.n_out / kQBoxRows; tn += csize)
    for (int kt = 0; kt < nk; ++kt, ++rw) {
      uint64_t* full = wr.producer_acquire(rw, kQSlice);
      tma_load_3d(m.w_base + wr.stage(rw) * m.w_stride, w_map, full,
                  kt * kQK, tn * kQBoxRows, 0);
    }
  cluster_wait();
}

// the byte of panel column `col` in panel row `pr` (a 16-byte chunk's
// first byte where col % 16 == 0)
__device__ __forceinline__ int panel_at(int pr, int col) {
  return (col / kQK) * kQSlice + pr * kQK +
         ((((col % kQK) >> 4) ^ (pr & 7)) << 4) + (col & 15);
}

// a barrier of the two consumer warpgroups (256 threads; id 3: 0 is the
// block's, 1 and 2 each warpgroup's)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// One head's attention for the calling warpgroup's 64 rows (row0 ..): the
// forward kernel's instructions in its order (attention_sm90.cu
// `attention_fwd_sm90`), o left in `o`: with kEx2 K1's attention launch's
// (scores carrying log2 e, p = 2^(s - m) r), else K9's (expf and the
// division, the exact softmax K7's twin and the TPU kernel compute; `mul`
// the scale, with log2 e where kEx2). Pass 2 forms tile t's p while tile t
// - 1's p . v runs where the ring holds two stages or more; with one (the
// widest panels) each tile's p . v retires before its stage is released,
// the same products in the same order.
template <int W, bool kEx2>
__device__ __forceinline__ void ao_head(float (&o)[W / 2], float (&s)[32],
                                        const AoSmem& m, int& ra, int seq,
                                        float mul, const Consumer& c) {
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const uint64_t qd = desc_k(m.q + c.wg * kBox);
  auto stage = [&](int r) { return m.a_base + m.aring.stage(r) * m.a_stride; };
  float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float sum[2] = {0.0f, 0.0f};
  const int r = ra;

  // pass 1: the row max and the row sum, online over the K tiles
  for (int t = 0; t < ntiles; ++t) {
    m.aring.consumer_wait(r + t);
    issue_nt<W>(s, qd, kBlockSub, stage(r + t));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    mask_scores(s, t * kTileRows, seq, nullptr, mul, c.t);
    m.aring.release(r + t);
    online_stats<kEx2>(s, mx, sum);
  }
  const int r2 = r + ntiles;
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  const float rsum[2] = {rcp_refined(sum[0]), rcp_refined(sum[1])};

  // pass 2: p = 2^(s - m) r, o += bf16(p) . v
  auto form_p = [&](int t) {
    mask_scores(s, t * kTileRows, seq, nullptr, mul, c.t);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      s[k] = prob_of<kEx2>(s[k], mx[(k >> 1) & 1], sum[(k >> 1) & 1],
                           rsum[(k >> 1) & 1]);
  };
  zero(o);
  uint32_t a[4][4];
  if (m.aring.n == 1) {
    for (int t = 0; t < ntiles; ++t) {
      m.aring.consumer_wait(r2 + t);
      issue_nt<W>(s, qd, kBlockSub, stage(r2 + t));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      form_p(t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
      issue_nn<W>(o, a, stage(r2 + t) + tile_bytes<W>(kTileRows));
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(a);
      m.aring.release(r2 + t);
    }
    ra = r2 + ntiles;
    return;
  }
  m.aring.consumer_wait(r2);
  issue_nt<W>(s, qd, kBlockSub, stage(r2));
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  form_p(0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
  for (int t = 1; t < ntiles; ++t) {
    m.aring.consumer_wait(r2 + t);
    issue_nt<W>(s, qd, kBlockSub, stage(r2 + t));
    wg_commit();
    issue_nn<W>(o, a, stage(r2 + t - 1) + tile_bytes<W>(kTileRows));
    wg_commit();
    wg_wait<1>();                       // tile t's scores; t - 1's p . v runs
    fence_regs(s);
    form_p(t);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(a);
    m.aring.release(r2 + t - 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
  }
  issue_nn<W>(o, a, stage(r2 + ntiles - 1) + tile_bytes<W>(kTileRows));
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  m.aring.release(r2 + ntiles - 1);
  ra = r2 + ntiles;
}

// the consumers (both warpgroups): the unit's heads of this rank, their
// codes into this CTA's panel and from there, 16 bytes a store, into the
// other CTAs' panels; the cluster barrier; then this rank's column tiles
// of the out-projection into the output (MODE: kEpiResidual or
// kEpiResF32Out; kEx2: the softmax of `ao_head`). `first_row`: the unit's
// first row of the (B S, N) output, b * S + q0.
template <int W, int MODE, bool kOneRing, bool kEx2>
__device__ __forceinline__ void ao_compute(const AoArgs& p, const AoSmem& m,
                                           AoCounts& n, int q0,
                                           long long first_row, int rank,
                                           int csize, const Consumer& c) {
  const int seq = p.seq, ld = p.live;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  const float mul = kEx2 ? __fmul_rn(p.scale, kLog2e) : p.scale;
  const float inv = inv_of(p.act);
  const int row0 = q0 + c.wg * 64;         // this warpgroup's first row
  float s[32], o[W / 2];
  zero(s);
  for (int h = rank; h < p.heads; h += csize, ++n.nq) {
    mbar_wait(m.q_full, n.nq & 1);
    if (row0 >= seq) {
      // rows all past seq: keep the barriers' counts, skip the work
      for (int i = 0; i < 2 * ntiles; ++i, ++n.ra) {
        m.aring.consumer_wait(n.ra);
        m.aring.release(n.ra);
      }
      mbar_arrive(m.q_empty);
      continue;
    }
    ao_head<W, kEx2>(o, s, m, n.ra, seq, mul, c);
    mbar_arrive(m.q_empty);             // Q is read
    // the codes of the head's live columns into this CTA's panel; rows
    // past seq are not written (their outputs are not stored)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pr = c.wg * 64 + c.row + 8 * rr;      // the panel's row
      if (q0 + pr >= seq) continue;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        if (8 * j >= ld) continue;
        char2 q;
        q.x = quant_i8(o[4 * j + 2 * rr], inv);
        q.y = quant_i8(o[4 * j + 2 * rr + 1], inv);
        *reinterpret_cast<char2*>(m.panel +
                                  panel_at(pr, h * ld + 8 * j + 2 * c.t)) = q;
      }
    }
  }
  // this rank's heads, whole, into the other CTAs' panels: 16-byte chunks
  // of its rows below seq
  consumers_sync();
  const int rows = min(kBlockRows, seq - q0), chunks = ld / 16;
  const int tid = threadIdx.x;
  for (int h = rank; h < p.heads; h += csize)
    for (int i = tid; i < rows * chunks; i += kWarpgroups * 128) {
      const int at = panel_at(i / chunks, h * ld + 16 * (i % chunks));
      const uint4 v = *reinterpret_cast<const uint4*>(m.panel + at);
      for (int d = 1; d < csize; ++d)
        *reinterpret_cast<uint4*>(
            map_rank(m.panel, rank + d < csize ? rank + d : rank + d - csize) +
            at) = v;
    }
  fence_proxy_async_all();
  cluster_arrive();
  cluster_wait();                       // every panel of the cluster whole

  // the out-projection of this rank's column tiles against the panel
  int& rw = w_count<kOneRing>(n);
  const RingN& wr = w_ring<kOneRing>(m);
  const int nk = (p.heads * ld + kQK - 1) / kQK;
  const int nvalid = min(64, seq - row0);
  const float a_div = act_div(p.act);
  auto wstage = [&](int i) {
    return static_cast<const unsigned char*>(m.w_base +
                                             wr.stage(i) * m.w_stride);
  };
  for (int tn = rank; tn < p.n_out / kQBoxRows; tn += csize) {
    int acc[64];
    zero_acc(acc);
    ring_product(acc, wr, rw, nk, m.panel, wstage, 0, c);
    if (nvalid > 0)
      epi_rows<MODE>(acc, p.out, p.residual, p.col_scale, p.bias, a_div,
                      0.0f, p.n_out, tn * kQBoxRows, first_row + c.wg * 64,
                      nvalid, c);
  }
}

// the producer warpgroup's other threads: their part in the cluster
// barrier of a unit
__device__ __forceinline__ void ao_idle() { cluster_sync(); }

// the tile's shared memory in K6 (attention.cu): the panel (ceil(Wa / 128)
// slices of 16 KB) at 0, the Q buffer (128 rows x W bf16) at `q`,
// a_stages stages of a K and a V tile at `a`, then the barriers at `bars`;
// the weight ring's w_stages stages of 16 KB lie over the Q buffer and
// the attention ring
struct AoLayout {
  int q, a, a_stride, a_stages, w_stages, bars;
  size_t bytes;
};

__host__ __device__ constexpr int ao_max_stages(int w) {
  return w == 64 ? 6 : (w == 128 ? 4 : 2);
}

__host__ __device__ inline AoLayout ao_layout(int w, int wa) {
  AoLayout L{};
  L.q = ln_panel_bytes(wa);
  L.a = L.q + kBlockRows * w * 2;
  L.a_stride = 2 * kTileRows * w * 2;
  const int room = static_cast<int>(kMaxBlockSmem) - 1024 - 256 - L.a;
  L.a_stages = room / L.a_stride < ao_max_stages(w) ? room / L.a_stride
                                                    : ao_max_stages(w);
  L.bars = L.a + L.a_stages * L.a_stride;
  L.w_stages = (L.bars - L.q) / kQSlice < 8 ? (L.bars - L.q) / kQSlice : 8;
  L.bytes = static_cast<size_t>(L.bars) + 8 * (2 + 2 * L.a_stages +
                                               2 * L.w_stages) + 1024;
  return L;
}

// The cluster size of K6 over `units` row tiles: the C in 1 .. 8 (at
// most `heads`) that minimises the waves of clusters (the card holding
// waves[C - 1] clusters of C CTAs at a time: the occupancy query's count,
// fewer than sms / C where a GPC's SMs do not divide by C) times a CTA's
// work, its ceil(heads / C) heads (two sweeps over the keys, about six
// tiles' products and softmax a key tile of W columns) and its
// ceil(n_tiles / C) column tiles of the out-projection (int8: half a bf16
// product a K column); the smallest such C.
inline int ao_cluster(long long units, int heads, int n_tiles, int seq,
                      int w, int wa, const int (&waves)[kAoMaxCluster]) {
  int best = 1;
  long long best_cost = -1;
  const long long keys = (seq + kTileRows - 1) / kTileRows * kTileRows;
  for (int c = 1; c <= kAoMaxCluster && c <= heads; ++c) {
    const long long per_wave = waves[c - 1] > 0 ? waves[c - 1] : 1;
    const long long cost =
        (units + per_wave - 1) / per_wave *
        ((heads + c - 1) / c * 6 * keys * w +
         static_cast<long long>(n_tiles + c - 1) / c * 64 * wa);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = c;
    }
  }
  return best;
}

}  // namespace sm90
}  // namespace tpudf
