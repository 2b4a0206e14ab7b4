// The int8 probe GEMMs of kernels 15 and 16: the int8 x int8 -> int32
// tile of gemm_i8.cuh with bf16 x quantised inside the kernel, and the
// epilogues the probes peel one step at a time.
//
// Kernel 15 (int8) replaces scripts/micro_pallas_int8.py `int8_kernel`
// (:27): q = clip(round(f32(x) * 127 / 4), +-127) on bf16 x, acc = int32(q .
// w), out = bf16((acc * f32(4 / 127)) * s[n]), no bias; (M, K, N) =
// (16384, 768, 3072) in the probe. Kernel 16 replaces
// scripts/micro_epilogue.py :28-67, launched through `make` at (65536, 768,
// 3072) with bias and scale of shape (N,):
//   k_full      the same quant and product, f = acc * ((4 / 127) * s[n]) +
//               b[n] in f32, out = bf16(gelu_tanh(f))
//   k_nogelu    out = bf16(f): gemm_i8.cuh's kEpiBf16 epilogue
//   k_bf16_epi  out = bf16(bf16(bf16(acc) * bf16(s[n])) + bf16(b[n])): the
//               dequant chain in bf16, with no 4 / 127 factor, as the TPU
//               kernel writes it (|acc| <= 768 * 127^2 < 2^24, so f32(acc)
//               is exact and bf16(acc) one rounding)
//   k_noquant   int8 x: tpudf_i8_gemm's kEpiBf16 with act = 4
//               (int8_gemm_sm90.cu)
//   k_pure      int8 x, int32 out: tpudf_i8_gemm's kEpiI32
// The last two need no new code; the first four are this file's entry
// point. Per output element the f32 arithmetic is rounded op by op in the
// TPU kernels' order (the probe's (acc * c) * s, but c * s first in 16's).
//
// Design: gemm_i8.cuh's panel tile (`mma_panel`). Each 128 x 128
// output tile first loads its 128 rows of bf16 x, quantises them into an
// int8 panel in shared memory
// (K + 16 bytes a row: 120 KB with the weight stages at K = 768, one block
// an SM), with the first weight stage already in flight, then streams the
// weight (N, K) through two cp.async stages (mma_panel): the int8 x never
// reaches device memory, as it never left VMEM on the TPU. Each of the N /
// 128 column blocks of a row tile quantises its rows again (x is re-read
// from L2). At the probes' shapes the bound is the tensor-core operations
// (the bytes of the bf16 output come within 4 %); wgmma + TMA are later
// work.
#include "gemm_i8.cuh"

namespace tpudf {

enum : int {
  kProbeStaticQ = 0,   // 15: bf16((acc * c) * s[n])
  kProbeFull = 1,      // 16 k_full: bf16(gelu_tanh(acc * (c * s[n]) + b[n]))
  kProbeNoGelu = 2,    // 16 k_nogelu: bf16(acc * (c * s[n]) + b[n])
  kProbeBf16Epi = 3,   // 16 k_bf16_epi: bf16(bf16(acc) * bf16(s) + bf16(b))
};

// largest K whose int8 panel and two weight stages fit a block's 227 KB
constexpr int kProbeMaxK = 1600;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// clip(round(x * inv), +-127) of the tile's 128 rows of bf16 x (width K)
// into the int8 panel (rows ldp bytes apart); rows past M are zero
__device__ __forceinline__ void quant_panel(int8_t* panel, int ldp,
                                            const __nv_bfloat16* x, int M,
                                            int K, int m0, float inv) {
  const int chunks = K / 8;
  for (int i = threadIdx.x; i < kBM * chunks; i += kGemmThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    __align__(8) int8_t v[8];
    if (m0 + r < M) {
      float f[8];
      load8(x + static_cast<size_t>(m0 + r) * K + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0;
    }
    *reinterpret_cast<uint2*>(panel + r * ldp + c) =
        *reinterpret_cast<uint2*>(v);
  }
}

// the epilogues of kProbeStaticQ, kProbeFull and kProbeBf16Epi, in
// gemm_epilogue_bf16's fragment layout: rows (g, g+8) x cols (2t, 2t+1) of
// each 16 x 8 tile; c = act / 127 as gemm_epilogue_bf16 computes it
template <int MODE>
__device__ __forceinline__ void probe_epilogue(const int (&acc)[4][4][4],
                                               const GemmArgs& p, int m0,
                                               int n0, const TileThread& q) {
  const float c = p.act[0] / 127.0f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + q.wn * 32 + ni * 8 + q.t * 2;
      const float s[2] = {p.col_scale[col], p.col_scale[col + 1]};
      float b[2] = {0.0f, 0.0f};
      if constexpr (MODE != kProbeStaticQ) {
        b[0] = p.bias[col];
        b[1] = p.bias[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + q.wm * 64 + mi * 16 + q.g + h * 8;
        if (row >= p.M) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = static_cast<float>(acc[mi][ni][2 * h + e]);
          if constexpr (MODE == kProbeStaticQ) {
            o[e] = __fmul_rn(__fmul_rn(a, c), s[e]);
          } else if constexpr (MODE == kProbeFull) {
            o[e] = gelu_tanh(__fadd_rn(__fmul_rn(a, __fmul_rn(c, s[e])),
                                       b[e]));
          } else {  // kProbeBf16Epi
            o[e] = __fadd_rn(
                round_bf16(__fmul_rn(round_bf16(a), round_bf16(s[e]))),
                round_bf16(b[e]));
          }
        }
        const size_t off = static_cast<size_t>(row) * p.N + col;
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(p.out) + off) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

// One 128 x 128 output tile of quant(x) . B^T with the MODE epilogue;
// p.act is x's activation scale (4.0 in the probes)
template <int MODE>
__global__ void __launch_bounds__(kGemmThreads)
    probe_q_gemm_kernel(GemmArgs p, const __nv_bfloat16* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileThread q = tile_thread();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ldp = p.K + 16;
  int8_t* panel = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = panel + static_cast<size_t>(kBM) * ldp;
  first_b_stage(bs, p, n0, q);
  quant_panel(panel, ldp, x, p.M, p.K, m0, 127.0f / p.act[0]);
  int acc[4][4][4];
  zero_acc(acc);
  mma_panel(acc, panel, ldp, bs, p, n0, q);
  if constexpr (MODE == kProbeNoGelu)
    gemm_epilogue_bf16(acc, p, m0, p.M, n0, q);
  else
    probe_epilogue<MODE>(acc, p, m0, n0, q);
}

template <int MODE>
int launch_probe_gemm(const GemmArgs& p, const void* x, cudaStream_t s) {
  const size_t smem = panel_gemm_smem(p.K);
  cudaError_t err = cudaFuncSetAttribute(
      probe_q_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / kBN, (p.M + kBM - 1) / kBM);
  probe_q_gemm_kernel<MODE><<<grid, kGemmThreads, smem, s>>>(
      p, static_cast<const __nv_bfloat16*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// out (M, N) bf16 = epilogue(quant(x) . bt^T), x (M, K) bf16, bt (N, K)
// int8 (the probe's (K, N) weight transposed once), col_scale and bias (N,)
// f32 (bias null for kProbeStaticQ), act the 0-d f32 activation scale of x;
// mode: kProbeStaticQ, kProbeFull, kProbeNoGelu or kProbeBf16Epi
TPUDF_API int tpudf_i8_gemm_quant(const void* x, const void* bt,
                                  const void* col_scale, const void* bias,
                                  const void* act, void* out, int M, int N,
                                  int K, int mode, void* stream) {
  using namespace tpudf;
  if (M <= 0) return 0;
  if (N % kBN != 0 || K % kBK != 0 || K > kProbeMaxK || mode < 0 ||
      mode > kProbeBf16Epi || act == nullptr || col_scale == nullptr ||
      (mode != kProbeStaticQ && bias == nullptr) ||
      (M + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  const GemmArgs p{nullptr,
                   static_cast<const int8_t*>(bt),
                   static_cast<const float*>(col_scale),
                   static_cast<const float*>(bias),
                   static_cast<const float*>(act),
                   nullptr,
                   out,
                   nullptr,
                   nullptr,
                   M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kProbeStaticQ) return launch_probe_gemm<kProbeStaticQ>(p, x, s);
  if (mode == kProbeFull) return launch_probe_gemm<kProbeFull>(p, x, s);
  if (mode == kProbeNoGelu) return launch_probe_gemm<kProbeNoGelu>(p, x, s);
  return launch_probe_gemm<kProbeBf16Epi>(p, x, s);
}
