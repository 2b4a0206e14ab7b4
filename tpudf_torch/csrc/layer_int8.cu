// K7: one static-W8A8 SigLIP layer in ONE launch.
//
// Replaces tpudf/ops/int8_block.py `_layer_kernel` (wrapper
// `siglip_layer_int8`), which ran one image's whole layer per program with
// the qkv, the attention output and the (S, 4W) hidden in VMEM. Its math:
//   x1  = x + (quant(attn(bf16(dequant(quant(LN1(x)) . Wqkv) + bqkv)))
//             . Wout dequantised) + bout            in f32, never rounded
//   out = bf16(x1 + (quant(gelu(dequant(quant(LN2(x1)) . W1) + b1)) . W2
//                    dequantised + b2))
// No SM holds a whole layer's activations of even one image (the (256,
// 3072) hidden alone is 768 KB), so here one persistent cooperative grid
// (cudaLaunchCooperativeKernel, at most the co-resident blocks, sized by
// the occupancy query) walks four phases with a grid-wide barrier between
// them, each phase a grid-stride loop over its tiles:
//   1. gemm_i8.cuh's LN-prologue tile: LN1 + quant + QKV -> bf16 qkv
//   2. K6's tile: attention + quant + out-proj + bias + residual -> the
//      f32 x1 workspace (the order of the TPU kernel's adds)
//   3. LN2 over the f32 rows of x1 + quant in the prologue + fc1 + GELU +
//      quant -> int8 hidden workspace
//   4. fc2 + dequant + bias + the f32 residual x1 -> bf16 out
// The workspaces are device tensors the wrapper allocates; at the detect
// core's (8, 256, 768) they take 22 MB, within the 50 MB L2. The tiles are
// the device functions of gemm_i8.cuh and attn_tile.cuh, the same code as
// K5, K6 and the GEMM of K1/K2. Bound: the tensor-core operations of the
// four products and the attention.
#include <cooperative_groups.h>

#include <algorithm>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace tpudf {

struct LayerArgs {
  const __nv_bfloat16* x;     // (M, W)
  const float* ln1_g;
  const float* ln1_b;
  const float* ln2_g;
  const float* ln2_b;
  GemmArgs qkv;               // LN1(x) . Wqkv -> qkv workspace (M, 3W) bf16
  AttnOutArgs attn;           // -> x1 workspace (M, W) f32
  GemmArgs fc1;               // LN2(x1) . W1 -> hidden (M, inter) int8
  GemmArgs fc2;               // hidden . W2 + x1 -> out (M, W) bf16
  int batch;
  float eps;
};

// K7's limits: head_dim 64, S <= 256 and W <= 1024 (the whole-layer
// kernel is not widened; the block routes FPP beyond them, as JAX's does)
constexpr int kLayerHd = 64;
constexpr int kLayerSeq = 256;
constexpr int kLayerWidth = 1024;

__global__ void __launch_bounds__(kGemmThreads, 1)
    layer_int8_kernel(LayerArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int row_tiles = (p.qkv.M + kBM - 1) / kBM;

  int nt = p.qkv.N / kBN;
  for (int i = blockIdx.x; i < row_tiles * nt; i += gridDim.x)
    ln_gemm_tile<__nv_bfloat16, kEpiBf16>(p.qkv, p.x, p.ln1_g, p.ln1_b,
                                          p.eps, (i / nt) * kBM,
                                          (i % nt) * kBN, smem);
  grid.sync();

  const int qt = (p.attn.seq + kOutQTile - 1) / kOutQTile;
  for (int i = blockIdx.x; i < p.batch * qt; i += gridDim.x)
    attn_out_tile<kLayerHd, kEpiResF32Out>(p.attn, i / qt,
                                           (i % qt) * kOutQTile, smem);
  grid.sync();

  nt = p.fc1.N / kBN;
  const float* x1 = static_cast<const float*>(p.attn.proj.out);
  for (int i = blockIdx.x; i < row_tiles * nt; i += gridDim.x)
    ln_gemm_tile<float, kEpiGeluI8>(p.fc1, x1, p.ln2_g, p.ln2_b, p.eps,
                                    (i / nt) * kBM, (i % nt) * kBN, smem);
  grid.sync();

  nt = p.fc2.N / kBN;
  for (int i = blockIdx.x; i < row_tiles * nt; i += gridDim.x)
    gemm_tile<kEpiF32Residual>(p.fc2, (i / nt) * kBM, (i % nt) * kBN,
                               reinterpret_cast<int8_t*>(smem));
}

int launch_layer(LayerArgs& p, size_t smem, int max_tiles, void* stream) {
  auto* kernel = layer_int8_kernel;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kGemmThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return cudaErrorNotSupported;
  // a cooperative grid larger than the co-resident blocks would deadlock
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = std::min(per_sm * sms, max_tiles);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kGemmThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// x (B*S, W) bf16 -> out (B*S, W) bf16; weights transposed (N, K) int8,
// their per-column scales and biases f32, acts = (a_qkv, a_out, a_fc1,
// a_fc2) f32; workspaces qkv (B*S, 3W) bf16, x1 (B*S, W) f32, hidden
// (B*S, inter) int8
TPUDF_API int tpudf_layer_i8(
    const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wout, const void* sout,
    const void* bout, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, const void* acts, void* qkv_ws, void* x1_ws,
    void* hid_ws, void* out, int batch, int seq, int heads, int width,
    int inter, float eps, float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (heads * kLayerHd != width || width % kBN != 0 ||
      width > kLayerWidth || inter % kBN != 0 || seq > kLayerSeq)
    return cudaErrorInvalidValue;
  const int m = batch * seq;
  const float* a = static_cast<const float*>(acts);
  auto gemm = [&](const void* wt, const void* cs, const void* bias,
                  const float* act, const void* res, void* o, int n, int k,
                  const float* act_out, const void* a8) {
    return GemmArgs{static_cast<const int8_t*>(a8),
                    static_cast<const int8_t*>(wt),
                    static_cast<const float*>(cs),
                    static_cast<const float*>(bias),
                    act, res, o, nullptr, act_out, m, n, k};
  };
  LayerArgs p{static_cast<const __nv_bfloat16*>(x),
              static_cast<const float*>(ln1_g),
              static_cast<const float*>(ln1_b),
              static_cast<const float*>(ln2_g),
              static_cast<const float*>(ln2_b),
              gemm(wqkv, sqkv, bqkv, a + 0, nullptr, qkv_ws, 3 * width,
                   width, nullptr, nullptr),
              AttnOutArgs{static_cast<const __nv_bfloat16*>(qkv_ws),
                          gemm(wout, sout, bout, a + 1, x, x1_ws, width,
                               width, nullptr, nullptr),
                          seq, heads, scale},
              gemm(w1, s1, b1, a + 2, nullptr, hid_ws, inter, width, a + 3,
                   nullptr),
              gemm(w2, s2, b2, a + 3, x1_ws, out, width, inter, nullptr,
                   hid_ws),
              batch, eps};
  const size_t smem =
      std::max(ln_gemm_smem(width), attn_out_smem<kLayerHd>(width));
  const int row_tiles = (m + kBM - 1) / kBM;
  const int max_tiles = std::max(row_tiles * (inter / kBN),
                                 row_tiles * (3 * width / kBN));
  return launch_layer(p, smem, max_tiles, stream);
}
