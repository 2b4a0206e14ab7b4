// Shared device helpers of the tpudf_torch Hopper kernels.
//
// Every entry point is a plain C function: pointers and the stream come in
// as void*, the kernel launches on that stream, and the function returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Arithmetic that the JAX package rounds op by op (layer norm, dequant,
// GELU) is written with __fmul_rn/__fadd_rn so that nvcc does not contract
// it into FMAs; int8 codes are rintf (round half to even, as jnp.round and
// torch.round), then clamped to [-127, 127].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TPUDF_API extern "C" __attribute__((visibility("default")))

namespace tpudf {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// clip(round(y * inv), -127, 127) with inv = 127 / act_scale
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  float q = rintf(__fmul_rn(y, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// One warp holds one row of up to 1024 bf16 values (4 chunks of 8 per
// lane) and computes its f32 mean and 1/sqrt(E[x^2] - E[x]^2 + eps).
struct RowLN {
  float v[32];
  float mu, rstd;
};

__device__ __forceinline__ void load_row_ln(const __nv_bfloat16* row,
                                            int width, float eps, int lane,
                                            RowLN& r) {
  const int nchunks = width / 8;
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int chunk = lane + c * 32;
    if (chunk < nchunks) {
      uint4 raw = *reinterpret_cast<const uint4*>(row + chunk * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        r.v[c * 8 + j] = f;
        s += f;
        ss += f * f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r.v[c * 8 + j] = 0.0f;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  r.mu = s / static_cast<float>(width);
  const float m2 = ss / static_cast<float>(width);
  const float var = fmaxf(m2 - r.mu * r.mu, 0.0f);
  r.rstd = 1.0f / sqrtf(var + eps);
}

// (x - mu) * rstd * g + b, rounded op by op
__device__ __forceinline__ float ln_apply(float x, const RowLN& r, float g,
                                          float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, r.mu), r.rstd), g), b);
}

// jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(c (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

}  // namespace tpudf
