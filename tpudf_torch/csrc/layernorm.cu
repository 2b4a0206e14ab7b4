// K4: row layer norm, bf16 in and out, f32 E[x^2]-E[x]^2 statistics.
//
// Replaces tpudf/ops/layernorm.py `_ln_kernel` (wrappers `_ln_pallas`,
// `layer_norm_fused`). Also here: the LN + static int8 quant row pass that
// opens kernels K1 and K2 (the quantize of int8_block.py
// `_attn_sublayer_kernel` and mlp.py `_kernel_int8`) and is K8.
//
// Bound by device-memory bytes: 2 bytes read and 2 (or 1) written per
// element against ~10 flops. The design:
// - one warp a row at a time, the row held in registers (as its raw bf16,
//   16-byte loads, chunk c of 8 values at lane c % 32) between the
//   statistics and the normalisation, so each row is read once;
// - each warp walks rows (grid-stride over as many blocks as an SM holds)
//   and keeps the loads of its next two rows in flight while it reduces
//   and writes this one, so a warp's reductions never leave the memory
//   system idle;
// - gamma and beta are read in the dtype they are stored in (bf16 or f32)
//   with 16-byte loads, so the wrapper casts nothing per call;
// - the statistics are load_row_ln's (common.cuh), op for op: f32 sums of
//   x and x^2 in the same order, E[x^2] - E[x]^2 clamped at 0, 1 /
//   sqrt(var + eps); the outputs equal the one-row-a-warp kernel's bit for
//   bit, and the quant's rounding is ln_apply's and quant_i8's.
#include "common.cuh"

namespace tpudf {

constexpr int kLnWarps = 8;

// a row's raw bf16 chunks: chunk lane + 32 c in v[c], zeros past the width
struct RowRaw {
  uint4 v[kLnChunks];
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* row,
                                         int nchunks, int lane, RowRaw& r) {
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int chunk = lane + c * 32;
    r.v[c] = chunk < nchunks
                 ? *reinterpret_cast<const uint4*>(row + chunk * 8)
                 : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

// load_row_ln's statistics from the raw row
__device__ __forceinline__ void raw_stats(const RowRaw& raw, int width,
                                          float eps, float& mu,
                                          float& rstd) {
  const int nchunks = width / 8;
  const int lane = threadIdx.x & 31;
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    if (lane + c * 32 < nchunks) {
      float f[8];
      unpack8(raw.v[c], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += f[j];
        ss += f[j] * f[j];
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mu = s / static_cast<float>(width);
  const float m2 = ss / static_cast<float>(width);
  const float var = fmaxf(m2 - mu * mu, 0.0f);
  rstd = 1.0f / sqrtf(var + eps);
}

// rows of x normalised into out: bf16 (kQuant false) or int8 codes with
// inv = 127 / act (kQuant true); gamma and beta of type P
template <typename P, bool kQuant>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                   const P* __restrict__ g, const P* __restrict__ b,
                   const float* __restrict__ act_scale,
                   void* __restrict__ out, int rows, int width, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kLnWarps;
  const int nchunks = width / 8;
  float inv = 0.0f;
  if constexpr (kQuant) inv = 127.0f / act_scale[0];
  int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  RowRaw cur, n1, n2;
  if (row < rows) load_raw(x + static_cast<size_t>(row) * width, nchunks,
                           lane, cur);
  if (row + stride < rows)
    load_raw(x + static_cast<size_t>(row + stride) * width, nchunks, lane,
             n1);
  for (; row < rows; row += stride) {
    if (row + 2 * stride < rows)      // in flight while this row reduces
      load_raw(x + static_cast<size_t>(row + 2 * stride) * width, nchunks,
               lane, n2);
    RowLN r;
    raw_stats(cur, width, eps, r.mu, r.rstd);
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int chunk = lane + c * 32;
      if (chunk < nchunks) {
        float f[8], gf[8], bf[8];
        unpack8(cur.v[c], f);
        load8(g + chunk * 8, gf);
        load8(b + chunk * 8, bf);
        const size_t o = static_cast<size_t>(row) * width + chunk * 8;
        if constexpr (kQuant) {
          __align__(8) int8_t q[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            q[j] = quant_i8(ln_apply(f[j], r, gf[j], bf[j]), inv);
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + o) =
              *reinterpret_cast<uint2*>(q);
        } else {
          __align__(16) __nv_bfloat16 y[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            y[j] = __float2bfloat16_rn(ln_apply(f[j], r, gf[j], bf[j]));
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) =
              *reinterpret_cast<uint4*>(y);
        }
      }
    }
    cur = n1;
    n1 = n2;
  }
}

// the grid: as many blocks as the SMs hold at once (so every warp walks
// its rows from the start), fewer where the rows need fewer
template <typename P, bool kQuant>
int ln_grid(int rows) {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_rows_kernel<P, kQuant>, kLnWarps * 32, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  const int need = (rows + kLnWarps - 1) / kLnWarps;
  return need < resident ? need : resident;
}

template <bool kQuant>
int launch_ln(const void* x, const void* g, const void* b, const void* act,
              void* out, int rows, int width, int params_bf16, float eps,
              void* stream) {
  if (rows <= 0) return 0;
  if (width % 8 != 0 || width > kLnMaxWidth) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* a = static_cast<const float*>(act);
  if (params_bf16)
    ln_rows_kernel<__nv_bfloat16, kQuant>
        <<<ln_grid<__nv_bfloat16, kQuant>(rows), kLnWarps * 32, 0, s>>>(
            xb, static_cast<const __nv_bfloat16*>(g),
            static_cast<const __nv_bfloat16*>(b), a, out, rows, width, eps);
  else
    ln_rows_kernel<float, kQuant>
        <<<ln_grid<float, kQuant>(rows), kLnWarps * 32, 0, s>>>(
        xb, static_cast<const float*>(g), static_cast<const float*>(b), a,
        out, rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// out (rows, width) bf16; g, b (width,) bf16 (params_bf16) or f32
TPUDF_API int tpudf_layer_norm_bf16(const void* x, const void* g,
                                    const void* b, void* out, int rows,
                                    int width, int params_bf16, float eps,
                                    void* stream) {
  return tpudf::launch_ln<false>(x, g, b, nullptr, out, rows, width,
                                 params_bf16, eps, stream);
}

// out (rows, width) int8 codes with the 0-d f32 act_scale
TPUDF_API int tpudf_ln_quant_i8(const void* x, const void* g, const void* b,
                                const void* act_scale, void* out, int rows,
                                int width, int params_bf16, float eps,
                                void* stream) {
  return tpudf::launch_ln<true>(x, g, b, act_scale, out, rows, width,
                                params_bf16, eps, stream);
}
