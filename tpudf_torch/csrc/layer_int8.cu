// K7: one static-W8A8 SigLIP layer in ONE launch, on wgmma and TMA.
//
// Replaces tpudf/ops/int8_block.py `_layer_kernel` (wrapper
// `siglip_layer_int8`), which ran one image's whole layer per program with
// the qkv, the attention output and the (S, 4W) hidden in VMEM. Its math:
//   x1  = x + (quant(attn(bf16(dequant(quant(LN1(x)) . Wqkv) + bqkv)))
//             . Wout dequantised) + bout            in f32, never rounded
//   out = bf16(x1 + (quant(gelu(dequant(quant(LN2(x1)) . W1) + b1)) . W2
//                    dequantised + b2))
// No SM holds a whole layer's activations of even one image (the (256,
// 3072) hidden alone is 768 KB), so here one persistent grid of clusters
// (cudaLaunchKernelEx, cooperative and clustered, at most the co-resident
// clusters, sized by the occupancy query) walks four phases with a
// grid-wide barrier between them, each phase on the sm90 device function
// that does its work elsewhere:
//   1. K5's LN panel (i8_sm90.cuh `ln_panel`) on the int8 wgmma product:
//      LN1 + quant + QKV -> the bf16 qkv workspace (units of a row tile and
//      a run of its column tiles, `ln_runs`; the epilogue K5's
//      `store_direct`)
//   2. K6's cluster tile (attn_out_sm90.cuh) on the head's tile (64: heads
//      of 64 and fewer, zero-padded to it as K6 pads them; or 128):
//      attention + quant into the
//      clusters' o panels + out-proj + bias + the bf16 residual x -> the
//      f32 x1 workspace (kEpiResF32Out: the order of the TPU kernel's
//      adds); its softmax K9's exact sequence (expf and the division), as
//      the TPU kernel's and the twin's, not K1's ex2 (which moved 5.6e-2
//      of the layer's outputs off the twin's bits, past K7's card rule)
//   3. the LN panel built from the f32 rows of x1 (LN2 + quant) + fc1 +
//      GELU + quant (kEpiGeluI8) -> the int8 hidden workspace
//   4. fc2, both operands by TMA (the hidden's and the weight's boxes in
//      one 32 KB stage of a second ring over all of the shared memory,
//      which phases 1-3 have left) + dequant + bias + the f32 residual x1
//      (kEpiF32Residual) -> bf16 out
// Every phase runs on the same block (two consumer warpgroups and a
// producer warpgroup); phases 1-3 share one mbarrier ring whose stages
// hold a 16 KB weight box or a K and a V tile of the head (16 or 32 KB)
// and whose item count runs on across them, so its barriers' phases stay
// in step; the LN phases' products retire each stage while they wait for
// the next, so the ring needs two stages.
// The domain: any S (the attention streams its keys), W % 128 == 0 up to
// the LN panel's kLnMaxWidth (1280: a lane's five chunks of a row), head
// tiles of 64 and 128 with the heads' o panel (heads x live columns)
// beside the Q buffer and two ring stages in the block's shared memory
// (`layer_layout`; the wrapper's K6_MAX_WA). Heads of 256 (a 64 KB Q
// buffer and 64 KB stages leave no room for two stages beside a panel
// wider than 256, and that instance spilled), wider heads, wider panels and
// wider rows run K7's split form (int8_block.py), its arithmetic in
// separate launches.
// Data that a phase writes with plain stores and the next reads by TMA
// (qkv, the hidden) is fenced to the async proxy before the grid barrier.
// The workspaces are device tensors the wrapper allocates; at the detect
// core's (8, 256, 768) they take 22 MB, within the 50 MB L2. Bound: the
// tensor-core operations of the four products and the attention.
#include <cooperative_groups.h>

#include <algorithm>

#include "attn_out_sm90.cuh"

namespace cg = cooperative_groups;

namespace tpudf {
namespace {

using namespace sm90;

struct LayerArgs {
  const __nv_bfloat16* x;     // (M, W)
  const float* ln1_g;
  const float* ln1_b;
  const float* ln2_g;
  const float* ln2_b;
  const float* acts;          // a_qkv, a_out, a_fc1, a_fc2
  const float* s_qkv;         // the weights' column scales and biases
  const float* b_qkv;
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  __nv_bfloat16* qkv;         // (M, 3W) workspace
  float* x1;                  // (M, W) workspace
  int8_t* hid;                // (M, inter) workspace
  __nv_bfloat16* out;         // (M, W)
  AoArgs attn;                // phase 2 (residual x, out x1)
  int batch, seq, width, inter;
  int qkv_n;                  // qkv's columns: 3 heads x the head's tile
  int runs1, runs3;           // ln_runs of phases 1 and 3
  float eps;
};

// the tensor maps: the QKV, out-projection, fc1 and fc2 weights (N, K)
// int8, the qkv workspace (B, S, 3W) bf16, the hidden (M, inter) int8
struct LayerMaps {
  CUtensorMap wqkv, wout, w1, w2, qkv, hid;
};

// K7's shared memory: the panel (LN1 and LN2: ceil(W / 128) slices of 16
// KB; o: ceil(Wa / 128), Wa = heads x live) at 0, the Q buffer (128 rows x
// the tile of bf16) at `q`, `stages` ring stages of `stage` bytes (a
// weight box or a K and a V tile, whichever is larger) at `ring`, then the
// barriers; fc2's ring (phase 4: `stages4` stages of 32 KB, an A box and a
// weight box) over all of it from 0
struct LayerLayout {
  int q, ring, stage, stages, stages4, bars;
  size_t bytes;
};

__host__ __device__ inline LayerLayout layer_layout(int w, int wa,
                                                    int tile) {
  LayerLayout L{};
  L.q = ln_panel_bytes(w > wa ? w : wa);
  L.ring = L.q + kBlockRows * tile * 2;
  L.stage = 2 * kTileRows * tile * 2 > kQSlice ? 2 * kTileRows * tile * 2
                                               : kQSlice;
  const int room = static_cast<int>(kMaxBlockSmem) - 1024 - 512 - L.ring;
  L.stages = room < 0 ? 0 : (room / L.stage < 8 ? room / L.stage : 8);
  L.bars = L.ring + L.stages * L.stage;
  L.stages4 = L.bars / (2 * kQSlice) < 8 ? L.bars / (2 * kQSlice) : 8;
  L.bytes = static_cast<size_t>(L.bars) +
            8 * (2 + 2 * L.stages + 2 * L.stages4) + 1024;
  return L;
}

// the units of an LN phase: (row tile, run of its column tiles); block
// blk's units are blk, blk + gridDim.x, ...
struct LnUnit {
  int m0, t0, t1;
};

__device__ __forceinline__ LnUnit ln_unit(int u, int runs, int tiles) {
  const int j = u % runs;
  return {u / runs * kQM, j * tiles / runs, (j + 1) * tiles / runs};
}

// the producer's weight boxes of an LN phase: nk K slices of each of the
// unit's column tiles
__device__ __forceinline__ void load_ln_phase(const RingN& ring, int& r,
                                              unsigned char* base, int stride,
                                              const CUtensorMap* w_map,
                                              int M, int N, int K, int runs) {
  const int units = (M + kQM - 1) / kQM * runs, tiles = N / kQBoxRows;
  const int nk = (K + kQK - 1) / kQK;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const LnUnit w = ln_unit(u, runs, tiles);
    for (int tn = w.t0; tn < w.t1; ++tn)
      for (int kt = 0; kt < nk; ++kt, ++r) {
        uint64_t* full = ring.producer_acquire(r, kQSlice);
        tma_load_3d(base + ring.stage(r) * stride, w_map, full, kt * kQK,
                    tn * kQBoxRows, 0);
      }
  }
}

template <int HT>
__global__ void __launch_bounds__(kThreads, 1)
    layer_i8_sm90(const __grid_constant__ LayerMaps maps, const LayerArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const LayerLayout L =
      layer_layout(p.width, p.attn.heads * p.attn.live, HT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const RingN ring{bars + 2, bars + 2 + L.stages, L.stages};
  uint64_t* bars4 = bars + 2 + 2 * L.stages;
  const RingN ring4{bars4, bars4 + L.stages4, L.stages4};
  unsigned char* rbase = smem + L.ring;
  const AoSmem m{smem,  smem + L.q, bars,  bars + 1, ring,
                 rbase, L.stage,    ring,  rbase,    L.stage};
  if (threadIdx.x == 0) {
    mbar_init(m.q_full, 1);
    mbar_init(m.q_empty, kWarpgroups * 128);
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], kWarpgroups * 128);
    }
    for (int i = 0; i < L.stages4; ++i) {
      mbar_init(&ring4.full[i], 1);
      mbar_init(&ring4.empty[i], kWarpgroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  cluster_sync();
  const int M = p.batch * p.seq, width = p.width;
  const int row_tiles = (M + kQM - 1) / kQM;
  const int n_qt = (p.seq + kBlockRows - 1) / kBlockRows;
  const int units2 = p.batch * n_qt;
  const int rank = cluster_rank(), csize = cluster_size();
  AoCounts n{0, 0, 0};               // one ring: n.ra counts its items

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- the producer warpgroup: its first thread issues every load, the
    // others keep the barriers' counts
    reg_dealloc<kAoProducerRegs>();
    const bool loader = threadIdx.x == kWarpgroups * 128;
    if (loader)
      load_ln_phase(ring, n.ra, rbase, L.stage, &maps.wqkv, M, p.qkv_n,
                    width, p.runs1);
    grid.sync();
    for (int u = cluster_index(); u < units2; u += cluster_count()) {
      if (loader)
        ao_load<HT, true>(p.attn, m, n, &maps.qkv, &maps.wout,
                                u / n_qt, (u % n_qt) * kBlockRows, rank,
                                csize);
      else
        ao_idle();
      cluster_sync();                 // the panels' reads done
    }
    grid.sync();
    if (loader)
      load_ln_phase(ring, n.ra, rbase, L.stage, &maps.w1, M, p.inter,
                    width, p.runs3);
    grid.sync();
    if (loader) {
      const int nt = width / kQBoxRows, nk = p.inter / kQK;
      int r4 = 0;
      for (int u = blockIdx.x; u < row_tiles * nt; u += gridDim.x)
        for (int kt = 0; kt < nk; ++kt, ++r4) {
          uint64_t* full = ring4.producer_acquire(r4, 2 * kQSlice);
          unsigned char* st = smem + ring4.stage(r4) * 2 * kQSlice;
          tma_load_3d(st, &maps.hid, full, kt * kQK, u / nt * kQM, 0);
          tma_load_3d(st + kQSlice, &maps.w2, full, kt * kQK,
                      u % nt * kQBoxRows, 0);
        }
    }
    return;
  }

  // ---- the consumers: 64 rows of each tile
  reg_alloc<kAoConsumerRegs>();
  const Consumer c = consumer();
  auto stage = [&](int i) {
    return static_cast<const unsigned char*>(rbase + ring.stage(i) * L.stage);
  };
  // 1. LN1 + quant + QKV -> qkv (bf16)
  {
    const int tiles = p.qkv_n / kQBoxRows, nk = (width + kQK - 1) / kQK;
    const float inv = inv_of(p.acts + 0);
    for (int u = blockIdx.x; u < row_tiles * p.runs1; u += gridDim.x) {
      const LnUnit w = ln_unit(u, p.runs1, tiles);
      const int row0 = w.m0 + 64 * c.wg;
      ln_panel(smem, p.x, p.ln1_g, p.ln1_b, p.eps, inv, M, width, row0, c.wg);
      for (int tn = w.t0; tn < w.t1; ++tn) {
        int acc[64];
        zero_acc(acc);
        ring_product(acc, ring, n.ra, nk, smem, stage, 0, c);
        if (row0 >= M) continue;
        EpiArgs e{p.s_qkv, p.b_qkv, nullptr, nullptr, nullptr,
                  act_div(p.acts + 0), 0.0f, M, p.qkv_n};
        store_direct<128>(acc, p.qkv, e, tn * kQBoxRows, row0, c);
      }
    }
  }
  fence_proxy_async_all();              // qkv is read by TMA in phase 2
  grid.sync();

  // 2. attention + out-projection + x -> x1 (f32)
  for (int u = cluster_index(); u < units2; u += cluster_count()) {
    const int b = u / n_qt, q0 = (u % n_qt) * kBlockRows;
    ao_compute<HT, kEpiResF32Out, true, false>(
        p.attn, m, n, q0, static_cast<long long>(b) * p.seq + q0, rank,
        csize, c);
    cluster_sync();                     // the panels' reads done
  }
  grid.sync();

  // 3. LN2 over x1 + quant + fc1 + GELU + quant -> hidden (int8)
  {
    const int tiles = p.inter / kQBoxRows, nk = (width + kQK - 1) / kQK;
    const float inv = inv_of(p.acts + 2);
    for (int u = blockIdx.x; u < row_tiles * p.runs3; u += gridDim.x) {
      const LnUnit w = ln_unit(u, p.runs3, tiles);
      const int row0 = w.m0 + 64 * c.wg;
      ln_panel(smem, static_cast<const float*>(p.x1), p.ln2_g, p.ln2_b,
               p.eps, inv, M, width, row0, c.wg);
      for (int tn = w.t0; tn < w.t1; ++tn) {
        int acc[64];
        zero_acc(acc);
        ring_product(acc, ring, n.ra, nk, smem, stage, 0, c);
        if (row0 < M)
          epi_rows<kEpiGeluI8>(acc, p.hid, nullptr, p.s1, p.b1,
                                act_div(p.acts + 2), inv_of(p.acts + 3),
                                p.inter, tn * kQBoxRows, row0,
                                min(64, M - row0), c);
      }
    }
  }
  fence_proxy_async_all();              // the hidden is read by TMA next
  grid.sync();

  // 4. fc2 + dequant + bias + x1 -> out (bf16), on its own ring over all
  // of the shared memory
  {
    const int nt = width / kQBoxRows, nk = p.inter / kQK;
    int r4 = 0;
    auto stage4 = [&](int i) {
      return static_cast<const unsigned char*>(smem + ring4.stage(i) * 2 *
                                               kQSlice);
    };
    for (int u = blockIdx.x; u < row_tiles * nt; u += gridDim.x) {
      const int row0 = u / nt * kQM + 64 * c.wg;
      int acc[64];
      zero_acc(acc);
      ring_product(acc, ring4, r4, nk, nullptr, stage4, kQSlice, c);
      if (row0 < M)
        epi_rows<kEpiF32Residual>(acc, p.out, p.x1, p.s2, p.b2,
                                   act_div(p.acts + 3), 0.0f, width,
                                   u % nt * kQBoxRows, row0,
                                   min(64, M - row0), c);
    }
  }
}

// The clusters of 1 .. 8 CTAs of K7's kernel (head tile HT) the card
// holds at a time (the occupancy query: a cooperative grid larger than
// that would never finish its first grid barrier), kept for the last
// shared memory asked
template <int HT>
cudaError_t layer_waves(size_t bytes, int (&waves)[kAoMaxCluster]) {
  static size_t cached = 0;
  static int counts[kAoMaxCluster];
  if (bytes != cached) {
    static const cudaError_t attr =
        registers_suffice(layer_i8_sm90<HT>)
            ? cudaFuncSetAttribute(layer_i8_sm90<HT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(kMaxBlockSmem))
            : cudaErrorInvalidDeviceFunction;
    if (attr != cudaSuccess) return attr;
    for (int c = 1; c <= kAoMaxCluster; ++c) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c * 16);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = bytes;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = c;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(
          &counts[c - 1], layer_i8_sm90<HT>, &cfg);
      if (err != cudaSuccess) return err;
    }
    cached = bytes;
  }
  for (int i = 0; i < kAoMaxCluster; ++i) waves[i] = counts[i];
  return cudaSuccess;
}

// the bytes of a launch's shared memory; 0 where the ring has fewer than
// two stages (or the tile is not 64 or 128)
inline size_t layer_bytes(int width, int wa, int tile) {
  const LayerLayout L = layer_layout(width, wa, tile);
  return (tile != 64 && tile != 128) || L.stages < 2 ||
                 L.bytes > kMaxBlockSmem
             ? 0
             : L.bytes;
}

inline cudaError_t layer_waves_of(int tile, size_t bytes,
                                  int (&waves)[kAoMaxCluster]) {
  switch (tile) {
    case 64: return layer_waves<64>(bytes, waves);
    case 128: return layer_waves<128>(bytes, waves);
  }
  return cudaErrorInvalidValue;
}

// K7's launch: the cluster size of its attention phase by K6's rule
// (`ao_cluster`, over the clusters the card holds), as many clusters as
// the card holds at a time, one cooperative and clustered launch
template <int HT>
int launch_layer(const LayerMaps& maps, LayerArgs& p, cudaStream_t stream) {
  const int wa = p.attn.heads * p.attn.live;
  const size_t bytes = layer_bytes(p.width, wa, HT);
  if (bytes == 0) return cudaErrorInvalidValue;
  int waves[kAoMaxCluster];
  cudaError_t err = layer_waves<HT>(bytes, waves);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units2 = p.batch * ((p.seq + kBlockRows - 1) / kBlockRows);
  const int csize = ao_cluster(units2, p.attn.heads, p.width / kQBoxRows,
                               p.seq, HT, wa, waves);
  const int clusters = waves[csize - 1];
  if (clusters < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = clusters * csize;
  const int M = p.batch * p.seq;
  p.runs1 = ln_runs(M, p.qkv_n, blocks);
  p.runs3 = ln_runs(M, p.inter, blocks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, layer_i8_sm90<HT>, maps, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpudf

// x (B*S, W) bf16 -> out (B*S, W) bf16; weights transposed (N, K) int8:
// the QKV weight (3 heads tile, W) with each head's rows zero-padded to the
// tile, the out-projection (W, heads live) with each head's columns
// zero-padded to `live` (K6's panel: at least 16), fc1 (inter, W), fc2 (W,
// inter); their per-column scales and biases f32 (the QKV's padded like
// its rows), acts = (a_qkv, a_out, a_fc1, a_fc2) f32; workspaces qkv
// (B*S, 3 heads tile) bf16, x1 (B*S, W) f32, hidden (B*S, inter) int8;
// tile 64 or 128, W % 128 == 0 up to kLnMaxWidth, the o panel and two
// ring stages within a block (`layer_layout`)
TPUDF_API int tpudf_layer_i8(
    const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wout, const void* sout,
    const void* bout, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, const void* acts, void* qkv_ws, void* x1_ws,
    void* hid_ws, void* out, int batch, int seq, int heads, int width,
    int inter, int tile, int live, float eps, float scale, void* stream) {
  using namespace tpudf;
  using namespace tpudf::sm90;
  if (batch <= 0 || seq <= 0) return 0;
  const int qkv_n = 3 * heads * tile, wa = heads * live;
  if (!attention_seq_ok(batch, seq) || heads <= 0 || live <= 0 ||
      live > tile || live % 16 != 0 || wa % 64 != 0 ||
      qkv_n % kQBoxRows != 0 || width <= 0 || width % kQBoxRows != 0 ||
      width > kLnMaxWidth || inter % kQBoxRows != 0 || inter <= 0 ||
      layer_bytes(width, wa, tile) == 0)
    return cudaErrorInvalidValue;
  const int m = batch * seq;
  const float* a = static_cast<const float*>(acts);
  LayerMaps maps;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!map_2d(&maps.wqkv, wqkv, u8, 1, width, qkv_n, kQK, kQBoxRows) ||
      !map_2d(&maps.wout, wout, u8, 1, wa, width, kQK, kQBoxRows) ||
      !map_2d(&maps.w1, w1, u8, 1, width, inter, kQK, kQBoxRows) ||
      !map_2d(&maps.w2, w2, u8, 1, inter, width, kQK, kQBoxRows) ||
      !map_2d(&maps.hid, hid_ws, u8, 1, inter, m, kQK, kQM) ||
      !map_bf16_3d(&maps.qkv, qkv_ws, qkv_n, seq, batch, kTileRows) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x1_ws) % 16 != 0)
    return cudaErrorInvalidValue;
  LayerArgs p{static_cast<const __nv_bfloat16*>(x),
              static_cast<const float*>(ln1_g),
              static_cast<const float*>(ln1_b),
              static_cast<const float*>(ln2_g),
              static_cast<const float*>(ln2_b),
              a,
              static_cast<const float*>(sqkv),
              static_cast<const float*>(bqkv),
              static_cast<const float*>(s1),
              static_cast<const float*>(b1),
              static_cast<const float*>(s2),
              static_cast<const float*>(b2),
              static_cast<__nv_bfloat16*>(qkv_ws),
              static_cast<float*>(x1_ws),
              static_cast<int8_t*>(hid_ws),
              static_cast<__nv_bfloat16*>(out),
              AoArgs{a + 1, static_cast<const float*>(sout),
                     static_cast<const float*>(bout), x, x1_ws, seq, heads,
                     live, width, scale},
              batch, seq, width, inter, qkv_n, 1, 1, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 64: return launch_layer<64>(maps, p, s);
    case 128: return launch_layer<128>(maps, p, s);
  }
  return cudaErrorInvalidValue;
}

// K7's cluster size at (B, S) with `heads` heads on a tile of `tile`
// columns, `live` of them in the o panel, and width W on this card (-1 on
// an error or outside the domain)
TPUDF_API int tpudf_layer_cluster(int batch, int seq, int heads, int width,
                                  int tile, int live) {
  using namespace tpudf;
  using namespace tpudf::sm90;
  int waves[kAoMaxCluster];
  const size_t bytes = layer_bytes(width, heads * live, tile);
  if (bytes == 0 || layer_waves_of(tile, bytes, waves) != cudaSuccess)
    return -1;
  return ao_cluster(batch * ((seq + kBlockRows - 1) / kBlockRows), heads,
                    width / kQBoxRows, seq, tile, heads * live, waves);
}

// K7's dynamic shared memory a block (0 outside the domain)
TPUDF_API int tpudf_layer_smem(int width, int wa, int tile) {
  return static_cast<int>(tpudf::layer_bytes(width, wa, tile));
}
