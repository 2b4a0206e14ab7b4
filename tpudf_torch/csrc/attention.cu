// K1 (b): per-image, per-head full-softmax attention over the fused bf16
// qkv activation, with an optional per-key logit bias (ToMe proportional
// attention, log token size), ending in the static int8 quant of the
// output that feeds the out-projection GEMM.
//
// Replaces the attention loop of tpudf/ops/int8_block.py
// `_attn_sublayer_kernel`. The TPU kernel kept qkv in VMEM between the QKV
// projection and this step; here qkv comes from device memory (later work:
// keep it on-chip). Same arithmetic: scores = (q . k) * scale in f32, + bias,
// p = e / sum(e) with e = exp(s - max) in f32, p rounded to bf16, o = p . v
// accumulated in f32, then int8 codes of o.
//
// One block per (query tile of 64, head, image); K and V of that head live
// in shared memory (S <= 256: up to 66 KB, padded K rows so that lanes
// reading different keys hit different banks), one warp per query row,
// lanes over keys for the scores and over the 64 dims for p . v. Bound by
// the f32 CUDA-core arithmetic of the two S x S x 64 products (the TPU ran
// them on the MXU); tensor cores are later work.
#include "common.cuh"

namespace tpudf {

constexpr int kHd = 64;           // head_dim the kernel is built for
constexpr int kQTile = 64;        // query rows per block
constexpr int kAttnWarps = 4;
constexpr int kKWords = kHd / 2 + 1;   // padded K row in bf16x2 words

__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_i8_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ key_bias,
                        const float* __restrict__ act_scale,
                        int8_t* __restrict__ o8, int seq, int heads,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wa = heads * kHd;                   // attention width
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  __nv_bfloat162* ks = reinterpret_cast<__nv_bfloat162*>(smem);
  __nv_bfloat162* vs = ks + seq * kKWords;                 // seq x 32 words
  float* qs = reinterpret_cast<float*>(vs + seq * (kHd / 2));
  float* ps = qs + kAttnWarps * kHd;                        // per-warp row

  const size_t row3 = static_cast<size_t>(3) * wa;         // qkv row stride
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * seq * row3;
  for (int i = threadIdx.x; i < seq * (kHd / 2); i += blockDim.x) {
    const int s = i / (kHd / 2), w = i % (kHd / 2);
    const __nv_bfloat16* r = base + s * row3 + h * kHd + 2 * w;
    ks[s * kKWords + w] = *reinterpret_cast<const __nv_bfloat162*>(r + wa);
    vs[s * (kHd / 2) + w] =
        *reinterpret_cast<const __nv_bfloat162*>(r + 2 * wa);
  }
  __syncthreads();

  const float inv_out = 127.0f / act_scale[0];
  float* q = qs + warp * kHd;
  float* p = ps + warp * seq;
  const int q_end = min(q0 + kQTile, seq);
  for (int qi = q0 + warp; qi < q_end; qi += kAttnWarps) {
    const __nv_bfloat162 qv = *reinterpret_cast<const __nv_bfloat162*>(
        base + qi * row3 + h * kHd + 2 * lane);
    q[2 * lane] = __low2float(qv);
    q[2 * lane + 1] = __high2float(qv);
    __syncwarp();

    float mx = __int_as_float(0xff800000);   // -inf
    for (int k = lane; k < seq; k += 32) {
      const __nv_bfloat162* kr = ks + k * kKWords;
      float s = 0.0f;
#pragma unroll 8
      for (int w = 0; w < kHd / 2; ++w) {
        const float2 kf = __bfloat1622float2(kr[w]);
        s = fmaf(q[2 * w], kf.x, s);
        s = fmaf(q[2 * w + 1], kf.y, s);
      }
      s *= scale;
      if (key_bias != nullptr) s += key_bias[b * seq + k];
      p[k] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int k = lane; k < seq; k += 32) {
      const float e = expf(p[k] - mx);
      p[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < seq; k += 32)
      p[k] = __bfloat162float(__float2bfloat16_rn(p[k] / sum));
    __syncwarp();

    float o0 = 0.0f, o1 = 0.0f;
    for (int k = 0; k < seq; ++k) {
      const float pk = p[k];
      const float2 vf = __bfloat1622float2(vs[k * (kHd / 2) + lane]);
      o0 = fmaf(pk, vf.x, o0);
      o1 = fmaf(pk, vf.y, o1);
    }
    char2 out;
    out.x = quant_i8(o0, inv_out);
    out.y = quant_i8(o1, inv_out);
    *reinterpret_cast<char2*>(
        o8 + (static_cast<size_t>(b) * seq + qi) * wa + h * kHd + 2 * lane) =
        out;
    __syncwarp();
  }
}

}  // namespace tpudf

TPUDF_API int tpudf_attention_i8(const void* qkv, const void* key_bias,
                                 const void* act_scale, void* o8, int batch,
                                 int seq, int heads, int head_dim,
                                 float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (head_dim != kHd || seq > 256) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(seq) * kKWords * 4 +
                      static_cast<size_t>(seq) * (kHd / 2) * 4 +
                      kAttnWarps * kHd * 4 + kAttnWarps * seq * 4;
  cudaError_t err = cudaFuncSetAttribute(
      attention_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  attention_i8_kernel<<<grid, kAttnWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(key_bias),
      static_cast<const float*>(act_scale), static_cast<int8_t*>(o8), seq,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}
