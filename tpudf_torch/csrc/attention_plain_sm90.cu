// Kernels 11 and 12 in bf16 on Hopper's own machinery: wgmma products and
// TMA loads through an mbarrier ring (sm90.cuh), K9's block.
//
// Replaces tpudf/ops/attention.py `_attn_kernel` (launched by
// `_attention_pallas`, the (B, H, S, D) layout; kernel 11) and the inner
// `kernel` of `_attention_pallas_bshd` (the (B, S, H, D) layout; kernel
// 12), bf16 q, k, v of one head_dim (64, 72 or 128), Sq != Skv allowed:
//   pass 1  s = (q . k) * scale in f32, -inf for keys past Skv; the row max
//           m and the row sum l = sum exp(s - m), online over 64-key tiles
//           (each thread sums its 16 keys of a tile in key order,
//           rescaling at a new max; the four threads of a row add up at
//           the end);
//   pass 2  s again, p = exp(s - m) / l in f32, rounded to bf16 for p . v,
//           o summed in f32 and rounded once to bf16.
// One source serves both layouts: q, k, v and o are read and written
// through 4-D tensor maps (columns, rows, heads, images) built from the
// tensors' strides, so the (B, S, H, D) layout is read where it lies and
// never transposed. Rows past Sq or Skv, and columns past head_dim, arrive
// as zeros; keys past Skv are masked as well (Skv = 100 or 577 is a
// softmax over Skv keys, not over zeros), and the output's TMA store clips
// rows past Sq and columns past head_dim.
//
// The block is K9's (attention_sm90.cu): two consumer warpgroups of 64
// query rows and a producer warpgroup (setmaxnreg), one block an SM,
// persistent over work items of (128 query rows, head, image), query tiles
// fastest so that the blocks running together share a head's K and V in
// L2. The producer loads each item's Q (double-buffered) and streams the
// head's K tiles (pass 1) and K and V tiles (pass 2), 64 keys each, through
// a ring that runs on across items. QK^T is wgmma with Q and K both
// K-major; p is wgmma's register A against V, read with the transpose bit;
// tile t's p is formed while tile t - 1's p . v runs. The tile is W
// columns wide: 64 and 128 at heads of 64 and 128; a head of 72 runs an
// 80-wide tile, a 64-column sub-tile in the 128-byte swizzle and a
// 16-column one in the 32-byte swizzle (its own tensor maps, descriptors
// and wgmma: k16 step 5 of QK^T, an N = 16 product beside the N = 64 one
// for p . v), whose columns 72-79 arrive as zeros and add exact zeros to
// the scores and to o: 80/72 of the products, where a 128-wide tile (the
// head's map read 128 columns wide, zero past 72) costs 128/72. A map over
// (H D, S, B) would read the next head's columns there; the maps here are
// over (D, S, H, B). The softmax scale is an argument, never derived from
// the tile.
// The softmax runs sm90.cuh's cheaper instructions (ex2 on scores that
// carry log2 e, p = e r with r formed once a row) in place of K9's expf and
// division: the same function, a quarter less device time (PERF.md). At
// head_dim 64 and these shapes the f32 instructions of the softmax, not
// the products or the bytes, bound the tile.
#include <algorithm>

#include "sm90.cuh"

namespace tpudf {
namespace {

using namespace sm90;

// shared memory: two Q buffers (128 rows each), then kStages stages of a
// K tile and a V tile, then the barriers. A tile of R rows is W / 64
// sub-tiles of R rows of 128 bytes and, at W = 80, one of R rows of 32
// bytes after them (sub-tile c at c R 128 bytes in either case)
template <int W>
struct PlainSmem {
  static constexpr int kStages = stages<W>();
  static constexpr int kQ = 0;
  static constexpr int kStage0 = 2 * tile_bytes<W>(kBlockRows);
  static constexpr int kV = tile_bytes<W>(kTileRows);
  static constexpr int kStage = 2 * tile_bytes<W>(kTileRows);
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;
};

// the 64-column sub-tiles of a tile W wide (W = 80: and the 16-column
// one of sm90.cuh's 80-wide tile)
template <int W>
constexpr int kSubs = W / 64;

// W = 80: the warpgroup's (64 x 80) output through its rows of the Q
// buffer: the 64 columns as `store_tile_4d` stages them, the 16 in the
// 32-byte swizzle (a row's 16-byte chunk j at chunk j ^ (row / 4 % 2)) at
// `rows16`; then two TMA stores, clipped past Sq and past head_dim
__device__ __forceinline__ void store_tile80(
    const float (&o)[32], const float (&o16)[8], unsigned char* rows,
    unsigned char* rows16, const CUtensorMap* map, const CUtensorMap* map16,
    int row0, int h, int b, const Consumer& c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c.row + 8 * r;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          rows16 + row * kNarrowRow + ((j ^ ((row >> 2) & 1)) << 4) +
          4 * c.t) = __floats2bfloat162_rn(o16[4 * j + 2 * r],
                                           o16[4 * j + 2 * r + 1]);
  }
  stage_tile<64>(o, rows, c);
  if ((threadIdx.x & 127) == 0) {
    tma_store_4d(map, rows, 0, row0, h, b);
    tma_store_4d(map16, rows16, 64, row0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
  warpgroup_sync(c.wg);
}

// s = (q . k) * mul in f32, -inf for keys k0 + .. past skv; the mask only
// on a ragged tile, as selects
__device__ __forceinline__ void scale_mask(float (&s)[32], int k0, int skv,
                                           float mul, int t) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int k = 0; k < 32; ++k) s[k] = __fmul_rn(s[k], mul);
  if (k0 + kTileRows > skv) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      s[k] = k0 + 8 * (k >> 2) + 2 * t + (k & 1) < skv ? s[k] : neg_inf;
  }
}

// a block's work item: 128 query rows of one head of one image
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item(int it, int n_qt, int heads) {
  return {(it % n_qt) * kBlockRows, (it / n_qt) % heads, it / (n_qt * heads)};
}

// the tensor maps of a launch: q, k, v and o in 64-column boxes, and at W
// = 80 in 16-column boxes (the same maps elsewhere, never read)
struct Maps {
  CUtensorMap q, k, v, o, q16, k16, v16, o16;
};

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    attention_plain_sm90(const __grid_constant__ Maps maps, int batch,
                         int heads, int sq, int skv, float mul) {
  using L = PlainSmem<W>;
  constexpr bool kNarrow = W == 80;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;            // two each
  uint64_t* q_empty = bars + 2;
  const Ring<L::kStages> ring{bars + 4, bars + 4 + L::kStages};
  auto stage = [&](int r) {
    return smem + L::kStage0 + ring.stage(r) * L::kStage;
  };
  const int n_qt = (sq + kBlockRows - 1) / kBlockRows;
  const int n_items = n_qt * heads * batch;
  const int ntiles = (skv + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
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
    int r = 0;
    for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
      const Item w = item(it, n_qt, heads);
      if (n >= 2) mbar_wait(&q_empty[n & 1], ((n >> 1) - 1) & 1);
      mbar_expect_tx(&q_full[n & 1], tile_bytes<W>(kBlockRows));
      unsigned char* q = smem + L::kQ + (n & 1) * tile_bytes<W>(kBlockRows);
      for (int rr = 0; rr < kBlockRows / kTileRows; ++rr) {
        const int row = w.q0 + rr * kTileRows;
        for (int c = 0; c < kSubs<W>; ++c)
          tma_load_4d(q + c * kBlockSub + rr * kBox, &maps.q, &q_full[n & 1],
                      64 * c, row, w.h, w.b);
        if (kNarrow)
          tma_load_4d(q + kBlockSub + rr * kTileRows * kNarrowRow, &maps.q16,
                      &q_full[n & 1], 64, row, w.h, w.b);
      }
      for (int i = 0; i < 2 * ntiles; ++i, ++r) {
        const bool pass2 = i >= ntiles;
        const int k0 = (pass2 ? i - ntiles : i) * kTileRows;
        uint64_t* full = ring.producer_acquire(
            r, tile_bytes<W>(kTileRows) * (pass2 ? 2 : 1));
        unsigned char* st = stage(r);
        for (int c = 0; c < kSubs<W>; ++c) {
          tma_load_4d(st + c * kBox, &maps.k, full, 64 * c, k0, w.h, w.b);
          if (pass2)
            tma_load_4d(st + L::kV + c * kBox, &maps.v, full, 64 * c, k0,
                        w.h, w.b);
        }
        if (kNarrow) {
          tma_load_4d(st + kBox, &maps.k16, full, 64, k0, w.h, w.b);
          if (pass2)
            tma_load_4d(st + L::kV + kBox, &maps.v16, full, 64, k0, w.h,
                        w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  const float neg_inf = __int_as_float(0xff800000);
  float s[32], o[kNarrow ? 32 : W / 2], o16[8];  // o16: W = 80 only
  zero(s);
  int r = 0;
  for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
    const Item w = item(it, n_qt, heads);
    mbar_wait(&q_full[n & 1], (n >> 1) & 1);
    if (w.q0 + c.wg * 64 >= sq) {
      // rows all past Sq: keep the barriers' counts, skip the work
      for (int i = 0; i < 2 * ntiles; ++i, ++r) {
        ring.consumer_wait(r);
        ring.release(r);
      }
      mbar_arrive(&q_empty[n & 1]);
      continue;
    }
    unsigned char* qb = smem + L::kQ + (n & 1) * tile_bytes<W>(kBlockRows);
    unsigned char* qw = qb + c.wg * kBox;
    unsigned char* qw16 = qb + kBlockSub + c.wg * 64 * kNarrowRow;
    const uint64_t qd = desc_k(qw), qd16 = desc_32(qw16);
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
      scale_mask(s, t * kTileRows, skv, mul, c.t);
      ring.release(r + t);
      float tm[2] = {mx[0], mx[1]};
#pragma unroll
      for (int k = 0; k < 32; ++k)
        tm[(k >> 1) & 1] = fmaxf(tm[(k >> 1) & 1], s[k]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        tm[q] = quad_max(tm[q]);
        if (tm[q] != mx[q]) sum[q] *= ex2(mx[q] - tm[q]);
        mx[q] = tm[q];
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        sum[(k >> 1) & 1] += ex2(s[k] - mx[(k >> 1) & 1]);
    }
    r += ntiles;
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float rsum[2] = {rcp_refined(sum[0]), rcp_refined(sum[1])};

    // pass 2: p = exp(s - m) / l, o += bf16(p) . v; tile t's p is formed
    // while tile t - 1's p . v runs
    auto form_p = [&](int t) {
      scale_mask(s, t * kTileRows, skv, mul, c.t);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int q = (k >> 1) & 1;
        s[k] = __fmul_rn(ex2(s[k] - mx[q]), rsum[q]);
      }
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
    // o through this warpgroup's rows of the Q buffer, then Q is free
    if constexpr (kNarrow)
      store_tile80(o, o16, qw, qw16, &maps.o, &maps.o16, w.q0 + c.wg * 64,
                   w.h, w.b, c);
    else
      store_tile_4d<W>(o, qw, &maps.o, w.q0 + c.wg * 64, w.h, w.b, c);
    mbar_arrive(&q_empty[n & 1]);
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

// the layout of one side (q and o, or k and v): rows, and element strides
// of image, head and row
struct Side {
  const void* p;
  int rows, sb, sh, ss;
};

bool map_side(CUtensorMap* m, const Side& s, int hd, int heads, int batch,
              uint32_t box_cols) {
  return map_bf16_4d(m, s.p, hd, s.rows, heads, batch, s.ss, s.sh, s.sb,
                     kTileRows, box_cols);
}

template <int W>
int launch(const Side& q, const Side& k, const Side& v, const Side& o,
           int batch, int heads, int hd, float scale, cudaStream_t stream) {
  Maps m;
  bool ok = map_side(&m.q, q, hd, heads, batch, 64) &&
            map_side(&m.k, k, hd, heads, batch, 64) &&
            map_side(&m.v, v, hd, heads, batch, 64) &&
            map_side(&m.o, o, hd, heads, batch, 64);
  if (W == 80) {
    ok = ok && map_side(&m.q16, q, hd, heads, batch, 16) &&
         map_side(&m.k16, k, hd, heads, batch, 16) &&
         map_side(&m.v16, v, hd, heads, batch, 16) &&
         map_side(&m.o16, o, hd, heads, batch, 16);
  } else {
    m.q16 = m.q;
    m.k16 = m.k;
    m.v16 = m.v;
    m.o16 = m.o;
  }
  if (!ok) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      registers_suffice(attention_plain_sm90<W>)
          ? cudaFuncSetAttribute(attention_plain_sm90<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(PlainSmem<W>::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long n_items = static_cast<long long>(
      (q.rows + kBlockRows - 1) / kBlockRows) * heads * batch;
  const int grid = static_cast<int>(std::min<long long>(n_items, sm_count()));
  attention_plain_sm90<W><<<grid, kThreads, PlainSmem<W>::kBytes, stream>>>(
      m, batch, heads, q.rows, k.rows, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpudf

// q, o: (B, H, Sq, D) or (B, Sq, H, D); k, v: (B, H, Skv, D) or (B, Skv,
// H, D), bf16, as the strides say (elements of image, head and row; unit
// stride along D, every row start 16-byte aligned); head_dim 64, 72 or
// 128; Sq, Skv >= 1.
TPUDF_API int tpudf_attention_plain_sm90(const void* q, const void* k,
                                         const void* v, void* o, int batch,
                                         int heads, int sq, int skv,
                                         int head_dim, int q_sb, int q_sh,
                                         int q_ss, int kv_sb, int kv_sh,
                                         int kv_ss, float scale,
                                         void* stream) {
  using namespace tpudf;
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (skv <= 0) return cudaErrorInvalidValue;
  const Side qs{q, sq, q_sb, q_sh, q_ss}, os{o, sq, q_sb, q_sh, q_ss};
  const Side ks{k, skv, kv_sb, kv_sh, kv_ss}, vs{v, skv, kv_sb, kv_sh, kv_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(qs, ks, vs, os, batch, heads, 64, scale, s);
  if (head_dim == 72)
    return launch<80>(qs, ks, vs, os, batch, heads, 72, scale, s);
  if (head_dim == 128)
    return launch<128>(qs, ks, vs, os, batch, heads, 128, scale, s);
  return cudaErrorInvalidValue;
}

// dynamic shared bytes of a launch at head_dim hd (-1 outside the domain)
TPUDF_API int tpudf_plain_sm90_smem(int hd) {
  using namespace tpudf;
  if (hd == 64) return static_cast<int>(PlainSmem<64>::kBytes);
  if (hd == 72) return static_cast<int>(PlainSmem<80>::kBytes);
  if (hd == 128) return static_cast<int>(PlainSmem<128>::kBytes);
  return -1;
}
