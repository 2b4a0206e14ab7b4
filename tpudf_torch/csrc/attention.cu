// K6, replacing tpudf/ops/int8_block.py `_attn_out_kernel` (wrapper
// `attn_out_int8`): qkv (B, S, 3Wa) bf16 and the residual x (B S, W) ->
// per-head attention -> int8 quant of the f32 o -> int8 out-projection ->
// dequant + bias + residual -> bf16, in ONE launch on wgmma and TMA: the
// cluster tile of attn_out_sm90.cuh. The TPU kernel kept the attention
// output in VMEM; here it stays in each CTA's shared-memory o panel.
//
// A cluster of C CTAs takes one 128-query row tile of one image, its C
// CTAs a share of the heads each and then a share of the out-projection's
// 128-column tiles, so that the B = 8 detect cores' 16 / 40 row tiles
// keep 96 / 120 of the 132 SMs at work (C = 6 / 8: `ao_cluster`, from the
// clusters the card holds at a time), where one block a row tile walking
// every head left 116 / 92 idle. Bound: the tensor-core
// operations of the attention's two sweeps and of the out-projection (and
// the softmax's instructions, as in K1's attention launch, whose
// instructions the tile runs). Heads of 384 and more do not fit a block
// beside their panel: the wrapper runs them as two launches, K1's
// attention kernel (attention_sm90.cu) then the int8 GEMM.
#include <algorithm>

#include "attn_out_sm90.cuh"

namespace tpudf {
namespace {

using namespace sm90;

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    attn_out_sm90(const __grid_constant__ CUtensorMap qkv_map,
                  const __grid_constant__ CUtensorMap w_map, const AoArgs p,
                  int n_qt) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const AoLayout L = ao_layout(W, p.heads * p.live);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* abars = bars + 2;
  uint64_t* wbars = abars + 2 * L.a_stages;
  const AoSmem m{smem, smem + L.q, bars, bars + 1,
                 RingN{abars, abars + L.a_stages, L.a_stages}, smem + L.a,
                 L.a_stride,
                 RingN{wbars, wbars + L.w_stages, L.w_stages}, smem + L.q,
                 kQSlice};
  if (threadIdx.x == 0) {
    mbar_init(m.q_full, 1);
    mbar_init(m.q_empty, kWarpgroups * 128);
    for (int i = 0; i < L.a_stages; ++i) {
      mbar_init(&m.aring.full[i], 1);
      mbar_init(&m.aring.empty[i], kWarpgroups * 128);
    }
    for (int i = 0; i < L.w_stages; ++i) {
      mbar_init(&m.wring.full[i], 1);
      mbar_init(&m.wring.empty[i], kWarpgroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  cluster_sync();               // every CTA of the cluster runs: its panel
                                // may be written
  const int u = cluster_index(), rank = cluster_rank(), csize = cluster_size();
  const int b = u / n_qt, q0 = (u % n_qt) * kBlockRows;
  AoCounts n{0, 0, 0};
  if (threadIdx.x >= kWarpgroups * 128) {
    reg_dealloc<kAoProducerRegs>();
    if (threadIdx.x == kWarpgroups * 128)
      ao_load<W, false>(p, m, n, &qkv_map, &w_map, b, q0, rank, csize);
    else
      ao_idle();
    return;
  }
  reg_alloc<kAoConsumerRegs>();
  ao_compute<W, kEpiResidual, false, true>(
      p, m, n, q0, static_cast<long long>(b) * p.seq + q0, rank, csize,
      consumer());
}

// the clusters of 1 .. 8 CTAs of K6's kernel at tile W that the card
// holds at a time with `bytes` of shared memory a CTA (the occupancy
// query; the last count asked is kept, a launch asking again only at a new
// size)
template <int W>
cudaError_t ao_waves(size_t bytes, int (&waves)[kAoMaxCluster]) {
  static size_t cached = 0;
  static int counts[kAoMaxCluster];
  if (bytes != cached) {
    static const cudaError_t attr =
        registers_suffice(attn_out_sm90<W>)
            ? cudaFuncSetAttribute(attn_out_sm90<W>,
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
          &counts[c - 1], attn_out_sm90<W>, &cfg);
      if (err != cudaSuccess) return err;
    }
    cached = bytes;
  }
  for (int i = 0; i < kAoMaxCluster; ++i) waves[i] = counts[i];
  return cudaSuccess;
}

template <int W>
int launch_attn_out(const void* qkv, const void* wt, const AoArgs& p,
                    int batch, cudaStream_t stream) {
  const int wa = p.heads * p.live;
  const AoLayout L = ao_layout(W, wa);
  if (L.a_stages < 1 || L.bytes > kMaxBlockSmem) return cudaErrorInvalidValue;
  CUtensorMap qkv_map, w_map;
  if (!map_bf16_3d(&qkv_map, qkv, 3 * p.heads * W, p.seq, batch, kTileRows) ||
      !map_2d(&w_map, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wa, p.n_out, kQK,
              kQBoxRows))
    return cudaErrorInvalidValue;
  int waves[kAoMaxCluster];
  cudaError_t err = ao_waves<W>(L.bytes, waves);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.seq + kBlockRows - 1) / kBlockRows;
  const long long units = static_cast<long long>(batch) * n_qt;
  const int csize =
      ao_cluster(units, p.heads, p.n_out / kQBoxRows, p.seq, W, wa, waves);
  if (units * csize > 2147483647ll) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_out_sm90<W>, qkv_map, w_map, p, n_qt);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the clusters of 1 .. 8 CTAs the card holds at a time at tile W and Wa =
// wa (a launch's `waves`), into waves; the CUDA error
inline int attn_out_waves(int tile, int wa, int (&waves)[kAoMaxCluster]) {
  const AoLayout L = ao_layout(tile, wa);
  if (L.a_stages < 1) return cudaErrorInvalidValue;
  switch (tile) {
    case 64: return ao_waves<64>(L.bytes, waves);
    case 128: return ao_waves<128>(L.bytes, waves);
    case 256: return ao_waves<256>(L.bytes, waves);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tpudf

// K6: out (B*S, W) bf16 = bf16(x + (quant(attention(qkv)) . wt^T dequantised
// + bias)); qkv (B, S, 3 heads tile) bf16 with each head in `tile` columns
// (64, 128 or 256; heads of 16 and 32 zero-padded to 64), of which the
// first `live` (16, 32, 64, 128 or 256) hold the head; wt (W, heads live)
// int8; W % 128 == 0, S <= kMaxSeq, and the block's shared memory (the (128
// x heads live) int8 panel beside the Q buffer and one stage of K and V
// tiles) within the 227 KB a block may have: heads live <= 1536 at tile
// 64, <= 1280 at 128, <= 768 at 256
TPUDF_API int tpudf_attn_out_i8(const void* qkv, const void* x,
                                const void* wt, const void* col_scale,
                                const void* bias, const void* act, void* out,
                                int batch, int seq, int heads, int tile,
                                int live, int width, float scale,
                                void* stream) {
  using namespace tpudf;
  using namespace tpudf::sm90;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || width <= 0 || width % kQBoxRows != 0 ||
      heads <= 0 || live <= 0 || live > tile || live % 16 != 0 ||
      (heads * live) % 64 != 0)
    return cudaErrorInvalidValue;
  const AoArgs p{static_cast<const float*>(act),
                 static_cast<const float*>(col_scale),
                 static_cast<const float*>(bias), x, out, seq, heads, live,
                 width, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 64: return launch_attn_out<64>(qkv, wt, p, batch, s);
    case 128: return launch_attn_out<128>(qkv, wt, p, batch, s);
    case 256: return launch_attn_out<256>(qkv, wt, p, batch, s);
  }
  return cudaErrorInvalidValue;
}

// K6's cluster size at (B, S) with `heads` heads on a `tile`-wide tile of
// which `live` columns a head, into `width` columns, on this card (-1 on
// an error)
TPUDF_API int tpudf_attn_out_cluster(int batch, int seq, int heads, int tile,
                                     int live, int width) {
  using namespace tpudf::sm90;
  int waves[kAoMaxCluster];
  if (tpudf::attn_out_waves(tile, heads * live, waves) != cudaSuccess)
    return -1;
  const long long units =
      static_cast<long long>(batch) * ((seq + kBlockRows - 1) / kBlockRows);
  return ao_cluster(units, heads, width / kQBoxRows, seq, tile, heads * live,
                    waves);
}

// the clusters of `csize` (1 .. 8) CTAs this card holds at a time at a
// `tile`-wide tile and Wa = wa (-1 on an error)
TPUDF_API int tpudf_attn_out_waves(int tile, int wa, int csize) {
  using tpudf::sm90::kAoMaxCluster;
  int waves[kAoMaxCluster];
  if (csize < 1 || csize > kAoMaxCluster ||
      tpudf::attn_out_waves(tile, wa, waves) != cudaSuccess)
    return -1;
  return waves[csize - 1];
}

// K6's dynamic shared memory a block at a `tile`-wide tile and Wa = wa
// live columns (more than 232448: the launch is refused)
TPUDF_API int tpudf_attn_out_smem(int tile, int wa) {
  const tpudf::sm90::AoLayout L = tpudf::sm90::ao_layout(tile, wa);
  return L.a_stages < 1 ? -1 : static_cast<int>(L.bytes);
}
