// K6, replacing tpudf/ops/int8_block.py `_attn_out_kernel` (wrapper
// `attn_out_int8`): qkv (B, S, 3Wa) bf16 and the residual x (B, S, W) ->
// per-head attention -> int8 quant of the f32 o -> int8 out-projection ->
// dequant + bias + residual -> bf16, in ONE launch over (128-query tile,
// image) blocks of 8 warps (attn_out_tile in attn_tile.cuh). The TPU kernel
// kept the attention output in VMEM; here it stays in a (128 x Wa) int8
// tile in shared memory. Per block the heads run one after another, K and
// V streamed from L2 through a two-stage cp.async ring of 64-key tiles
// (attn_stream), both products on mma.sync; the out-projection's weight
// streams from L2 for each block. 128 query rows (not the TPU kernel's
// 256) give the out-projection the GEMM's own 128 x 128 tile; with the K/V
// ring the block's shared memory no longer depends on S (188 KB at
// large-384's S = 576, Wa = 1024; 198 KB at three heads of 256, where Q
// and the ring share their space). At the detect core's shapes the bound
// is the tensor-core operations. Heads of 384 and more do not fit a block
// beside their o tile: the wrapper runs them as two launches, K1's
// attention kernel (attention_sm90.cu) then the int8 GEMM.
// (K1's attention, the same function with int8 codes of o out, runs on
// wgmma and TMA: attention_sm90.cu.)
#include "attn_tile.cuh"

namespace tpudf {

template <int HD>
__global__ void __launch_bounds__(kGemmThreads)
    attn_out_i8_kernel(AttnOutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_out_tile<HD, kEpiResidual>(p, blockIdx.y, blockIdx.x * kOutQTile,
                                  smem);
}

template <int HD>
int launch_attn_out(const AttnOutArgs& p, int batch, void* stream) {
  const size_t smem = attn_out_smem<HD>(p.proj.K);
  if (smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_out_i8_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kOutQTile - 1) / kOutQTile, batch);
  attn_out_i8_kernel<HD><<<grid, kGemmThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// K6: out (B*S, W) bf16 = bf16(x + (quant(attention(qkv)) . wt^T dequantised
// + bias)); qkv (B, S, 3 * heads * head_dim), wt (W, heads * head_dim);
// head_dim 16, 32, 64, 128 or 256, S <= kMaxSeq, and the block's shared
// memory (the (128 x Wa) int8 tile beside Q and the K/V ring) within the
// 227 KB a block may have: Wa <= 1024 at head_dim 16, 32 and 64, Wa <= 768
// at 128 and 256
TPUDF_API int tpudf_attn_out_i8(const void* qkv, const void* x,
                                const void* wt, const void* col_scale,
                                const void* bias, const void* act, void* out,
                                int batch, int seq, int heads, int head_dim,
                                int width, float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  const int wa = heads * head_dim;
  if (!attention_seq_ok(batch, seq) || width % kBN != 0 || wa % kBK != 0)
    return cudaErrorInvalidValue;
  AttnOutArgs p{static_cast<const __nv_bfloat16*>(qkv),
                GemmArgs{nullptr, static_cast<const int8_t*>(wt),
                         static_cast<const float*>(col_scale),
                         static_cast<const float*>(bias),
                         static_cast<const float*>(act), x, out, nullptr,
                         nullptr, batch * seq, width, wa},
                seq, heads, scale};
  switch (head_dim) {
    case 16: return launch_attn_out<16>(p, batch, stream);
    case 32: return launch_attn_out<32>(p, batch, stream);
    case 64: return launch_attn_out<64>(p, batch, stream);
    case 128: return launch_attn_out<128>(p, batch, stream);
    case 256: return launch_attn_out<256>(p, batch, stream);
  }
  return cudaErrorInvalidValue;
}
