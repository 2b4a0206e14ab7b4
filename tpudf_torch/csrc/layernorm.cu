// K4: row layer norm, bf16 in and out, f32 E[x^2]-E[x]^2 statistics.
//
// Replaces tpudf/ops/layernorm.py `_ln_kernel` (wrappers `_ln_pallas`,
// `layer_norm_fused`). Also here: the LN + static int8 quant row pass that
// opens kernels K1 and K2 (the quantize of int8_block.py
// `_attn_sublayer_kernel` and mlp.py `_kernel_int8`) and is K8, and that
// pass over f32 rows (the LN2 of K7's split form, whose mid-layer residual
// stays f32).
//
// Bound by device-memory bytes: 2 bytes read and 2 (or 1) written per
// element against ~10 flops. The design:
// - rows of up to kLnMaxWidth (1280) bf16 values: one warp a row at a
//   time, the row held in registers (as its raw bf16, 16-byte loads, chunk
//   c of 8 values at lane c % 32) between the statistics and the
//   normalisation, so each row is read once;
// - each warp walks rows (grid-stride over as many blocks as an SM holds)
//   and keeps the loads of its next two rows in flight while it reduces
//   and writes this one, so a warp's reductions never leave the memory
//   system idle;
// - wider rows (any width % 8 == 0 whose row fits a warp's share of the
//   block's shared memory, `kLnWideWarps` rows a block: 29,056 bf16 or
//   14,528 f32 values, the limit the hardware sets) and f32 rows: one warp
//   a row, the row staged in that warp's shared memory as it is read (the
//   same chunks in the same lanes: the statistics sum in the register
//   path's order), then normalised from there, so each row is still read
//   once from device memory;
// - gamma and beta are read in the dtype they are stored in (bf16 or f32)
//   with 16-byte loads, so the wrapper casts nothing per call;
// - the statistics are load_row_ln's (common.cuh), op for op: f32 sums of
//   x and x^2 in the same order, E[x^2] - E[x]^2 clamped at 0, 1 /
//   sqrt(var + eps); the outputs equal the one-row-a-warp kernel's bit for
//   bit, and the quant's rounding is ln_apply's and quant_i8's.
#include <type_traits>

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

constexpr int kLnWideWarps = 4;

// chunk i (8 values) of a row of T as f32
__device__ __forceinline__ void chunk8(const uint4* p, float (&f)[8]) {
  unpack8(*p, f);
}

__device__ __forceinline__ void chunk8(const float4* p, float (&f)[8]) {
  const float4 lo = p[0], hi = p[1];
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// rows of x (T: bf16 or f32) of any width % 8 == 0 normalised into out as
// ln_rows_kernel does: one warp a row, the row's chunks (lane + 32 c)
// staged in the warp's `width` values of shared memory while the lane sums
// them in the register path's order, then normalised from there
template <typename T, typename P, bool kQuant>
__global__ void __launch_bounds__(kLnWideWarps * 32)
    ln_rows_wide_kernel(const T* __restrict__ x, const P* __restrict__ g,
                        const P* __restrict__ b,
                        const float* __restrict__ act_scale,
                        void* __restrict__ out, int rows, int width,
                        float eps) {
  using Chunk = typename std::conditional<sizeof(T) == 2, uint4,
                                          float4>::type;
  constexpr int kPer = sizeof(T) == 2 ? 1 : 2;   // Chunks of 8 values
  extern __shared__ __align__(16) unsigned char ln_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = width / 8;
  Chunk* buf = reinterpret_cast<Chunk*>(ln_smem) +
               static_cast<size_t>(warp) * nchunks * kPer;
  float inv = 0.0f;
  if constexpr (kQuant) inv = 127.0f / act_scale[0];
  for (int row = blockIdx.x * kLnWideWarps + warp; row < rows;
       row += gridDim.x * kLnWideWarps) {
    const Chunk* src = reinterpret_cast<const Chunk*>(
        x + static_cast<size_t>(row) * width);
    float s = 0.0f, ss = 0.0f;
#pragma unroll 4
    for (int chunk = lane; chunk < nchunks; chunk += 32) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        buf[chunk * kPer + k] = src[chunk * kPer + k];
      float f[8];
      chunk8(buf + chunk * kPer, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += f[j];
        ss += f[j] * f[j];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    RowLN r;
    r.mu = s / static_cast<float>(width);
    const float m2 = ss / static_cast<float>(width);
    const float var = fmaxf(m2 - r.mu * r.mu, 0.0f);
    r.rstd = 1.0f / sqrtf(var + eps);
#pragma unroll 2
    for (int chunk = lane; chunk < nchunks; chunk += 32) {
      float f[8], gf[8], bf[8];
      chunk8(buf + chunk * kPer, f);
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
}

// the wide kernel's shared memory: a row of `width` T a warp
template <typename T>
__host__ __device__ constexpr size_t ln_wide_smem(int width) {
  return static_cast<size_t>(kLnWideWarps) * width * sizeof(T);
}

template <typename T, typename P, bool kQuant>
int launch_ln_wide(const T* x, const P* g, const P* b, const float* act,
                   void* out, int rows, int width, float eps,
                   cudaStream_t s) {
  constexpr auto kernel = ln_rows_wide_kernel<T, P, kQuant>;
  const size_t bytes = ln_wide_smem<T>(width);
  if (bytes > kMaxBlockSmem) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxBlockSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kLnWideWarps * 32, bytes);
  const int resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int need = (rows + kLnWideWarps - 1) / kLnWideWarps;
  kernel<<<need < resident ? need : resident, kLnWideWarps * 32, bytes, s>>>(
      x, g, b, act, out, rows, width, eps);
  return static_cast<int>(cudaGetLastError());
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
  if (width <= 0 || width % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* a = static_cast<const float*>(act);
  if (width > kLnMaxWidth) {
    if (params_bf16)
      return launch_ln_wide<__nv_bfloat16, __nv_bfloat16, kQuant>(
          xb, static_cast<const __nv_bfloat16*>(g),
          static_cast<const __nv_bfloat16*>(b), a, out, rows, width, eps, s);
    return launch_ln_wide<__nv_bfloat16, float, kQuant>(
        xb, static_cast<const float*>(g), static_cast<const float*>(b), a,
        out, rows, width, eps, s);
  }
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

// out (rows, width) int8 codes of f32 rows x with f32 g, b and the 0-d f32
// act_scale; any width % 8 == 0 within the wide kernel's shared memory
TPUDF_API int tpudf_ln_quant_f32(const void* x, const void* g, const void* b,
                                 const void* act_scale, void* out, int rows,
                                 int width, float eps, void* stream) {
  using namespace tpudf;
  if (rows <= 0) return 0;
  if (width <= 0 || width % 8 != 0) return cudaErrorInvalidValue;
  return launch_ln_wide<float, float, true>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const float*>(act_scale), out,
      rows, width, eps, static_cast<cudaStream_t>(stream));
}

// the widest row the wide kernel takes: bf16 (elem 2) or f32 (elem 4)
TPUDF_API int tpudf_ln_max_width(int elem) {
  using namespace tpudf;
  return elem == 2 ? static_cast<int>(kMaxBlockSmem / (kLnWideWarps * 2)) / 8 * 8
                   : static_cast<int>(kMaxBlockSmem / (kLnWideWarps * 4)) / 8 * 8;
}
