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

// the most dynamic shared memory a block may have on sm_90
constexpr size_t kMaxBlockSmem = 232448;

// The attention kernels' longest sequence (K1, K6, K9, 9b, 17;
// tpudf_torch/ops/attention.py MAX_SEQ): 9b's int32 sums of p8 . v8 reach
// 127^2 S, under 2^31 up to S = 133,144. Nothing else in them grows with
// S: K and V stream through rings of 64-key tiles, the row statistics sit
// in registers, K9's bias tile is one per stage. A call's rows B * S are
// indexed as ints (b * S + r): at most kMaxRows (MAX_ROWS).
constexpr int kMaxSeq = 1 << 17;
constexpr long long kMaxRows = 2147483647ll;

// whether the attention kernels take `batch` images of `seq` tokens
inline bool attention_seq_ok(int batch, int seq) {
  return seq <= kMaxSeq &&
         static_cast<long long>(batch) * seq <= kMaxRows;
}

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

// max and sum over the four lanes of a quad (the lanes that hold one row of
// an mma.sync or wgmma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// clip(round(y * inv), -127, 127) with inv = 127 / act_scale
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  float q = rintf(__fmul_rn(y, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// eight consecutive row values as f32 (one 16-byte load of bf16, two of f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// One warp holds one row of up to kLnMaxWidth values (bf16 or f32; chunk
// c of 8 values goes to lane c % 32, at most kLnChunks chunks a lane) and
// computes its f32 mean and 1/sqrt(E[x^2] - E[x]^2 + eps). so400m's 1152
// is 144 chunks: 4.5 a lane, so the fifth slot is used by half the lanes.
constexpr int kLnChunks = 5;
constexpr int kLnMaxWidth = kLnChunks * 32 * 8;     // 1280

struct RowLN {
  float v[kLnChunks * 8];
  float mu, rstd;
};

template <typename T>
__device__ __forceinline__ void load_row_ln(const T* row, int width,
                                            float eps, int lane, RowLN& r) {
  const int nchunks = width / 8;
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int chunk = lane + c * 32;
    if (chunk < nchunks) {
      float f[8];
      load8(row + chunk * 8, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r.v[c * 8 + j] = f[j];
        s += f[j];
        ss += f[j] * f[j];
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

// 16-byte global -> shared copy that bypasses the registers (cp.async)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix: four 8x8 b16 matrices; lanes 0-7, 8-15, 16-23, 24-31 give the
// row addresses of matrices 0-3, and register i of each lane holds row
// lane/4, columns 2(lane%4), +1 of matrix i (of its transpose with .trans)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pack two f32 as bf16x2 (lo in the low half: the lower k index of mma)
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
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
