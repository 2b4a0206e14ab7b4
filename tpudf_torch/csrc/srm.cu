// K3: SRM residual raw moments. For each image, both distinct SRM
// residuals (the normalised K2 stencil and the K3 Laplacian, 3x3, 'same'
// size, zero border) and E[r], E[r^2], E[r^3], E[r^4] of each -> (B, 8).
//
// Replaces tpudf/ops/srm.py `_srm_moments_kernel` (wrapper
// `srm_raw_moments`). The TPU kernel used the separable form of the two
// stencils over VMEM-resident images. Bound by device-memory bytes: one f32
// read a pixel, 32 bytes written an image. The design:
// - an image is cut in tiles of `rows` rows (a strip) by `cols` columns
//   (the whole width up to kSrmMaxCols), one block a tile, so that the B = 8
//   forwards fill the card (8 images of 256 x 256: 32 strips of 8 rows, 256
//   blocks) and large batches run few halo rows (strips of up to 43 rows at
//   width 256; `srm_plan`);
// - a block copies its tile and a one-pixel halo (the rows above and below
//   the strip, the columns beside the tile) into shared memory, a warp a
//   row, by coalesced asynchronous copies all in flight together (cp.async:
//   a load at a time left the copy latency-bound), zeros where the halo
//   lies outside the image
//   (the stencils' zero border), then forms both residuals there: the
//   non-zero taps (all 9 of K2's, the Laplacian's 5: its corners are 0) in
//   row-major order with the twin's f32 coefficients, the first product
//   then each sum rounded op by op, so the residual is the twin's to the
//   bit;
// - thread t takes the tile's columns t, t + 256, ..., each from its top
//   row down, with the 3 x 3 neighbourhood sliding in registers (three
//   shared-memory reads a pixel); it converts each residual to f64 once
//   and accumulates r, r^2, r^3, r^4 there (the square exact, the higher
//   powers rounded in f64; these conversions and f64 operations, not the
//   bytes, bound the kernel at large B); a warp reduces its sums by
//   shuffles (xor 16, 8, 4, 2, 1), the block sums its warps in warp order
//   into the tile's partial (8 f64) in device memory;
// - the last tile of an image to finish (an atomic count per image, after a
//   fence) adds the image's partials in tile order and writes its moments,
//   then sets the count back to 0 for the next launch; so the sums take the
//   same order whichever block finishes last, and repeated launches give
//   the same bits. The counts are a scratch the wrapper keeps zeroed
//   between launches on one stream.
#include "common.cuh"

namespace tpudf {

constexpr int kSrmThreads = 256;
constexpr int kSrmWarps = kSrmThreads / 32;
constexpr int kSrmMaxCols = 1024;       // a tile's widest run of columns
constexpr int kSrmMinRows = 4;          // a strip's fewest rows (but at H)
constexpr int kSrmTileBytes = 46 * 1024;  // the tile and its halo, at most
                                          // (beside the static 0.6 KB: 48 KB)
constexpr int kSrmTargetBlocks = 264;   // two blocks an SM of the H100
// the taps (bit t: row t / 3, column t % 3) each stencil multiplies: every
// tap of K2's, the edge-adjacent four and the centre of the Laplacian's
constexpr unsigned kK2Taps = 0x1ffu, kK3Taps = 0xbau;

// a 4-byte copy from device memory into shared memory that bypasses the
// registers (cp.async); `bytes` 0 stores zeros
__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* gmem,
                                                int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// the twin's `_stencil3` on the neighbourhood nb: its taps in row-major
// order, the first product, then each sum rounded
template <unsigned kTaps>
__device__ __forceinline__ float stencil(const float (&nb)[9],
                                         const float* k) {
  float v = 0.0f;
  bool first = true;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if ((kTaps >> tap) & 1u) {
      const float m = __fmul_rn(nb[tap], k[tap]);
      v = first ? m : __fadd_rn(v, m);
      first = false;
    }
  }
  return v;
}

// rows of a strip and columns of a tile for (B, H, W): enough tiles for
// kSrmTargetBlocks, strips of at least kSrmMinRows rows, the tile and its
// halo within kSrmTileBytes (tpudf_torch/ops/srm.py `srm_plan`)
struct SrmPlan {
  int rows, cols, strips, ctiles;
};

inline SrmPlan srm_plan(int batch, int h, int w) {
  SrmPlan p{};
  p.cols = w < kSrmMaxCols ? w : kSrmMaxCols;
  p.ctiles = (w + p.cols - 1) / p.cols;
  const long long per_image = batch * static_cast<long long>(p.ctiles);
  const int want = static_cast<int>(
      (kSrmTargetBlocks + per_image - 1) / per_image);
  int rows = (h + want - 1) / want;
  rows = rows > kSrmMinRows ? rows : kSrmMinRows;
  const int rmax = kSrmTileBytes / (4 * (p.cols + 2)) - 2;
  rows = rows < rmax ? rows : rmax;
  p.rows = rows < h ? rows : h;
  p.strips = (h + p.rows - 1) / p.rows;
  return p;
}

__global__ void __launch_bounds__(kSrmThreads)
    srm_moments_kernel(const float* __restrict__ gray,
                       const float* __restrict__ coeffs,   // 2 x 3 x 3
                       double* __restrict__ partial,       // (B, tiles, 8)
                       unsigned* __restrict__ count,       // (B,)
                       float* __restrict__ out, int h, int w, int rows,
                       int cols, int ctiles) {
  extern __shared__ __align__(16) float tile[];   // (rows + 2) x (cols + 2)
  __shared__ double red[kSrmWarps][8];
  __shared__ float c[18];
  __shared__ bool last;
  const int ntiles = (h + rows - 1) / rows * ctiles;
  const int tid = threadIdx.x, b = blockIdx.x / ntiles,
            t = blockIdx.x % ntiles;
  const int r0 = t / ctiles * rows, c0 = t % ctiles * cols;
  const int nr = min(rows, h - r0), nc = min(cols, w - c0);
  const int ld = cols + 2;
  if (tid < 18) c[tid] = coeffs[tid];
  const float* img = gray + static_cast<size_t>(b) * h * w;
  // the tile and its halo: row i, column j at image (r0 - 1 + i, c0 - 1 +
  // j), zero outside the image (a copy of 0 bytes fills its 4 with
  // zeros); warp k copies rows k, k + 8, ..., every copy in flight at once
  for (int i = tid >> 5; i < nr + 2; i += kSrmWarps) {
    const int y = r0 - 1 + i;
    const bool in_y = y >= 0 && y < h;
    const float* src = img + static_cast<size_t>(in_y ? y : 0) * w;
    for (int j = tid & 31; j < nc + 2; j += 32) {
      const int x = c0 - 1 + j;
      const bool in = in_y && x >= 0 && x < w;
      cp_async4_zfill(tile + i * ld + j, in ? src + x : img, in ? 4 : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float k[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) k[i] = c[i];
  double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int j = tid; j < nc; j += kSrmThreads) {
    // the neighbourhood of (row 0, column j): tile rows 0 .. 2, columns j
    // .. j + 2; each row down drops the top row and reads one more
    float nb[9];
#pragma unroll
    for (int q = 0; q < 6; ++q) nb[q] = tile[(q / 3) * ld + j + q % 3];
    for (int i = 0; i < nr; ++i) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) nb[6 + dj] = tile[(i + 2) * ld + j + dj];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v =
            r == 0 ? stencil<kK2Taps>(nb, k) : stencil<kK3Taps>(nb, k + 9);
        const double d = v, d2 = d * d;
        acc[r * 4 + 0] += d;
        acc[r * 4 + 1] += d2;
        acc[r * 4 + 2] += d2 * d;
        acc[r * 4 + 3] += d2 * d2;
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) nb[q] = nb[q + 3];
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int m = 0; m < 8; ++m) red[tid >> 5][m] = acc[m];
  }
  __syncthreads();
  double* mine = partial + (static_cast<size_t>(b) * ntiles + t) * 8;
  if (tid < 8) {
    double s = red[0][tid];
#pragma unroll
    for (int wp = 1; wp < kSrmWarps; ++wp) s += red[wp][tid];
    mine[tid] = s;
    __threadfence();                    // the partial, before the count
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + b, 1u) == ntiles - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();                      // every tile's partial is seen
  if (tid < 8) {
    const double* all = partial + static_cast<size_t>(b) * ntiles * 8;
    double s = 0.0;
    for (int u = 0; u < ntiles; ++u) s += __ldcg(all + u * 8 + tid);
    out[b * 8 + tid] =
        static_cast<float>(s * (1.0 / (static_cast<double>(h) * w)));
  }
  if (tid == 0) count[b] = 0u;          // zeroed for the next launch
}

}  // namespace tpudf

// out (B, 8) f32 from gray (B, H, W) f32; partial: (B, tiles, 8) f64
// scratch (tiles = strips x column tiles, `tpudf_srm_plan`), count: (B,)
// u32 scratch, zero at the launch and left zero
TPUDF_API int tpudf_srm_moments(const void* gray, const void* coeffs,
                                void* partial, void* count, void* out,
                                int batch, int h, int w, void* stream) {
  using namespace tpudf;
  if (batch <= 0) return 0;
  if (h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const SrmPlan p = srm_plan(batch, h, w);
  const size_t bytes = static_cast<size_t>(p.rows + 2) * (p.cols + 2) * 4;
  const long long blocks =
      static_cast<long long>(batch) * p.strips * p.ctiles;
  if (blocks > 2147483647ll) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  srm_moments_kernel<<<grid, kSrmThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(coeffs),
      static_cast<double*>(partial), static_cast<unsigned*>(count),
      static_cast<float*>(out), h, w, p.rows, p.cols, p.ctiles);
  return static_cast<int>(cudaGetLastError());
}

// K3's plan at (B, H, W): item 0 the rows of a strip, 1 the columns of a
// tile, 2 the strips, 3 the column tiles of an image
TPUDF_API int tpudf_srm_plan(int batch, int h, int w, int item) {
  const tpudf::SrmPlan p = tpudf::srm_plan(batch, h, w);
  const int v[4] = {p.rows, p.cols, p.strips, p.ctiles};
  return item >= 0 && item < 4 ? v[item] : -1;
}
