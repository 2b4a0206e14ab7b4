// The softmax steps of the forward attention kernels on wgmma
// (attention_sm90.cu: K9 and K1's attention; attention.cu: K6; layer_int8.cu:
// K7's attention phase), on the scores of one 64-key tile held as a
// wgmma accumulator of 64 rows x 64 keys (thread t of a quad: keys 8 j + 2
// t + (e & 1) of rows r and r + 8, at s[4 j + e]).
#pragma once

#include "sm90.cuh"

namespace tpudf {
namespace sm90 {

// s = (q . k) * scale (+ bias * bias_mul) in f32, -inf for keys k0 + ..
// past seq; the mask only on a ragged tile, as selects (bias_mul: log2 e
// where the scores carry it, kernels 11 and 12's softmax)
__device__ __forceinline__ void mask_scores(float (&s)[32], int k0, int seq,
                                            const float* bias, float scale,
                                            int t, float bias_mul = 1.0f) {
  const float neg_inf = __int_as_float(0xff800000);
  if (bias != nullptr) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float bv = bias[8 * (k >> 2) + 2 * t + (k & 1)];
      s[k] = __fadd_rn(__fmul_rn(s[k], scale),
                       bias_mul == 1.0f ? bv : __fmul_rn(bv, bias_mul));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = __fmul_rn(s[k], scale);
  }
  if (k0 + kTileRows > seq) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      s[k] = k0 + 8 * (k >> 2) + 2 * t + (k & 1) < seq ? s[k] : neg_inf;
  }
}

// e = exp(s - m): expf (K9), or ex2 on scores that carry log2 e (K1's
// attention: kernels 11 and 12's sequence, sm90.cuh)
template <bool kEx2>
__device__ __forceinline__ float exp_of(float x) {
  return kEx2 ? ex2(x) : expf(x);
}

// one tile's scores into the online row max and sum of pass 1 (l rescaled
// when m grows; each thread sums its 16 keys in key order)
template <bool kEx2>
__device__ __forceinline__ void online_stats(const float (&s)[32],
                                             float (&mx)[2],
                                             float (&sum)[2]) {
  float tm[2] = {mx[0], mx[1]};
#pragma unroll
  for (int k = 0; k < 32; ++k)
    tm[(k >> 1) & 1] = fmaxf(tm[(k >> 1) & 1], s[k]);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    tm[q] = quad_max(tm[q]);
    if (tm[q] != mx[q]) sum[q] *= exp_of<kEx2>(mx[q] - tm[q]);
    mx[q] = tm[q];
  }
#pragma unroll
  for (int k = 0; k < 32; ++k)
    sum[(k >> 1) & 1] += exp_of<kEx2>(s[k] - mx[(k >> 1) & 1]);
}

// pass 2's p from a score: exp(s - m) / l, by expf and `div_rn` (K9) or as
// ex2(s - m) r with r = 1 / l refined (K1's attention)
template <bool kEx2>
__device__ __forceinline__ float prob_of(float s, float mx, float sum,
                                         float rsum) {
  return kEx2 ? __fmul_rn(ex2(s - mx), rsum)
              : div_rn(expf(s - mx), sum, rsum);
}

}  // namespace sm90
}  // namespace tpudf
