// The key tile and the online row statistics of 9b's attention on
// mma.sync at heads of 256 and 384-1280 (attention_i8.cu): a warp's 16
// query rows against tiles of kKeyTile keys, the scores of a tile held as
// mma.sync m16n8 accumulators s[j][e] (rows g (e = 0, 1) and g + 8 (e = 2,
// 3), keys 8j + 2t + (e & 1)). (K1's attention, K6, K7, K9, K10, 9b at
// heads of 64 and 128 and kernel 17 run on wgmma and TMA:
// attention_sm90.cu, attn_out_sm90.cuh, attention_i8.cu.)
#pragma once

#include "gemm_i8.cuh"

namespace tpudf {

constexpr int kKeyTile = 64;           // keys a tile

// pass 1 on one tile: the row max over the quad's lanes, the thread's part
// of the row sum rescaled to it (the quad shares each row's max, so the
// four parts add up at the end)
__device__ __forceinline__ void online_stats(
    const float (&s)[kKeyTile / 8][4], float (&mx)[2], float (&sum)[2]) {
  float tm[2] = {mx[0], mx[1]};
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tm[e >> 1] = fmaxf(tm[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = quad_max(tm[r]);
    if (tm[r] != mx[r]) sum[r] *= expf(mx[r] - tm[r]);
    mx[r] = tm[r];
  }
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[j][e] - mx[e >> 1]);
}

}  // namespace tpudf
