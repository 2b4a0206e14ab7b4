// K1's attention: per-image, per-head full-softmax attention over the
// fused bf16 qkv activation (B, S, 3Wa) laid out [q | k | v], with an
// optional per-key logit bias (ToMe proportional attention, log token
// size), and the static int8 quant of o that feeds the out-projection
// GEMM; replaces the attention loop of tpudf/ops/int8_block.py
// `_attn_sublayer_kernel`, whose TPU kernel kept qkv in VMEM between the
// QKV projection and this step. Scores = (q . k) * scale in f32, + bias,
// p = e / sum(e) with e = exp(s - max) in f32, p rounded to bf16, o = p . v
// accumulated in f32, then o quantised. (K9, the same attention with a
// bf16 output, is attention_sm90.cu.)
//
// One block per (query tile of 64, head, image), four warps of 16 query
// rows, head_dim 16, 32, 64, 128 or 256 (a template parameter), S <=
// kMaxSeq; at 256 one block per 128-column slice of the head's o, each
// computing the full 256-deep scores (attn_tile.cuh `out_hv`: 160
// registers of Q fragments, o and scores a thread, not 224).
// The Q tile sits in shared memory until each warp has its fragments; the
// head's K and V stream through a two-stage cp.async ring of 64-key tiles
// (attn_stream in attn_tile.cuh): a pass over K for each row's max and
// sum, then a pass over K and V for p and p . v, both products on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulate). Shared memory:
// 46 KB at head_dim 64, 87 KB at 128, 133 KB at 256, whatever S. K and V are re-read
// from L2 by each of the S/64 query-tile blocks of a head, K twice.
//
// K6, replacing tpudf/ops/int8_block.py `_attn_out_kernel` (wrapper
// `attn_out_int8`): qkv (B, S, 3Wa) bf16 and the residual x (B, S, W) ->
// per-head attention -> int8 quant of the f32 o -> int8 out-projection ->
// dequant + bias + residual -> bf16, in ONE launch over (128-query tile,
// image) blocks of 8 warps (attn_out_tile in attn_tile.cuh). The TPU kernel
// kept the attention output in VMEM; here it stays in a (128 x Wa) int8
// tile in shared memory. Per block the heads run one after another, K and
// V streamed from L2 as above; the out-projection's weight streams from L2
// for each block. 128 query rows (not the TPU kernel's 256, nor the K1
// attention's 64) give the out-projection the GEMM's own 128 x 128 tile;
// with the K/V ring the block's shared memory no longer depends on S (188
// KB at large-384's S = 576, Wa = 1024; 198 KB at three heads of 256,
// where Q and the ring share their space). At the detect core's shapes the
// bound is the tensor-core operations.
#include "attn_tile.cuh"

namespace tpudf {

constexpr int kQTile = 64;               // query rows per block
constexpr int kAttnWarps = 4;            // 16 query rows each

template <int HD>
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ key_bias,
                     const float* __restrict__ act_scale,
                     int8_t* __restrict__ out, int seq, int heads,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HV = out_hv<HD>(), kSlices = HD / HV;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + kQTile * row_ld<HD>();
  const int wa = heads * HD;                    // attention width
  const int b = blockIdx.z, h = blockIdx.y / kSlices;
  const int c0 = (blockIdx.y % kSlices) * HV;   // this block's o columns
  const int q0 = blockIdx.x * kQTile;
  const size_t row3 = static_cast<size_t>(3) * wa;         // qkv row stride
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;
  load_rows<HD>(qs, base, row3, q0, kQTile, seq);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;                 // this warp's first tile row
  // every warp joins the ring's barriers; rows past seq hold zero queries
  // (finite) and are never stored
  AttnWarp<HD, HV> w;
  load_q<HD>(w, qs + r0 * row_ld<HD>(), lane);
  attn_stream<HD, HD, HV>(w, base + wa, base + 2 * wa + c0, row3, seq,
                  key_bias == nullptr
                      ? nullptr
                      : key_bias + static_cast<size_t>(b) * seq,
                  scale, ring, lane);

  // ---- epilogue: rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3)
  const int g = lane >> 2, t = lane & 3;
  const float inv_out = 127.0f / act_scale[0];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    const size_t row =
        (static_cast<size_t>(b) * seq + qi) * wa + h * HD + c0;
#pragma unroll
    for (int dt = 0; dt < HV / 8; ++dt) {
      char2 q8;
      q8.x = quant_i8(w.o[dt][2 * r], inv_out);
      q8.y = quant_i8(w.o[dt][2 * r + 1], inv_out);
      *reinterpret_cast<char2*>(out + row + dt * 8 + 2 * t) = q8;
    }
  }
}

template <int HD>
int launch_attention_hd(const void* qkv, const void* key_bias,
                        const void* act_scale, void* out, int batch, int seq,
                        int heads, float scale, void* stream) {
  constexpr int HV = out_hv<HD>();
  const size_t smem =
      static_cast<size_t>(kQTile * row_ld<HD>() + ring_elems<HD, HV>()) *
      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(heads) * (HD / HV) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kQTile - 1) / kQTile, heads * (HD / HV), batch);
  attention_kernel<HD><<<grid, kAttnWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(key_bias),
      static_cast<const float*>(act_scale), static_cast<int8_t*>(out), seq,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

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

TPUDF_API int tpudf_attention_i8(const void* qkv, const void* key_bias,
                                 const void* act_scale, void* o8, int batch,
                                 int seq, int heads, int head_dim,
                                 float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || act_scale == nullptr)
    return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch_attention_hd<16>(qkv, key_bias, act_scale, o8, batch,
                                     seq, heads, scale, stream);
    case 32:
      return launch_attention_hd<32>(qkv, key_bias, act_scale, o8, batch,
                                     seq, heads, scale, stream);
    case 64:
      return launch_attention_hd<64>(qkv, key_bias, act_scale, o8, batch,
                                     seq, heads, scale, stream);
    case 128:
      return launch_attention_hd<128>(qkv, key_bias, act_scale, o8, batch,
                                      seq, heads, scale, stream);
    case 256:
      return launch_attention_hd<256>(qkv, key_bias, act_scale, o8, batch,
                                      seq, heads, scale, stream);
  }
  return cudaErrorInvalidValue;
}

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
