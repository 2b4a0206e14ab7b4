// Plain multi-head attention over separate q, k and v (kernels 11 and 12).
//
//   o = softmax(scale * q k^T) v      per (image, head), Sq != Skv allowed
//
// Replaces tpudf/ops/attention.py `_attn_kernel` (launched by
// `_attention_pallas`, the (B, H, S, D) layout; kernel 11) and the inner
// `kernel` of `_attention_pallas_bshd` (the (B, S, H, D) layout; kernel 12).
// One source serves both: the layout is given by element strides (image,
// head, row) for q and o and for k and v, so the (B, S, H, D) layout is
// read where it lies and never transposed, which is kernel 12's purpose.
// The TPU kernels padded the keys to a multiple of 128 and masked them to
// -inf; here a key tile past Skv is masked the same way (Skv = 100 or 577
// is a softmax over Skv keys, not over zeros).
//
// Same arithmetic as the TPU kernel: s = (q . k) * scale in f32, an exact
// softmax (row max, e = exp(s - max), p = e / sum e in f32), p cast to v's
// dtype, o = p . v with f32 sums, one rounding to q's dtype.
//
// bf16: one block per (64-query tile, head, image), four warps of 16 query
// rows, K and V streamed through the two-stage cp.async ring of 64-key
// tiles of attn_tile.cuh (`attn_stream`: a pass over K for each row's max
// and sum, then a pass over K and V for p and p . v, both products on the
// tensor cores, mma.sync m16n8k16 bf16 with f32 accumulators). head_dim 64
// and 128 run the tile as it is; so400m's raw heads of 72 run an 80-wide
// tile whose last 8 columns are zero in shared memory (q, k and v are read
// at 72 columns; the zero columns add exact zeros to the scores), which
// costs 80/72 of the products, against 128/72 for a copy padded to 128.
// The softmax scale is an argument, never derived from the tile width.
// At the shapes of the main path the card's bound is the bytes of q, k, v
// and o; K and V are re-read from L2 by each query tile of a head, K twice.
//
// f32: exact f32 products (no TF32, no bf16 cast: JAX's kernel is
// dtype-generic, and its test holds f32 to atol 5e-4, rtol 1e-3), a SIMT
// kernel: one block per (32-query tile, head, image), eight warps of four
// query rows; 32-key tiles of K and V in shared memory (rows padded by one
// float, so a lane's key row and a lane's dims both fall in distinct
// banks); a pass for each row's max and sum, then a pass for p (per warp
// through shared memory) and p . v, a lane owning dims lane, lane + 32, ...
// head_dim <= 128.
#include "attn_tile.cuh"

namespace tpudf {

constexpr int kPlainQTile = 64;          // bf16: query rows per block
constexpr int kPlainWarps = 4;           // bf16: 16 query rows each
constexpr int kF32QTile = 32;            // f32: query rows per block
constexpr int kF32Warps = 8;             // f32: 4 query rows each
constexpr int kF32Rows = kF32QTile / kF32Warps;
constexpr int kF32KeyTile = 32;
constexpr int kF32MaxHd = 128;

struct PlainArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, sq, skv;
  int q_sb, q_sh, q_ss;      // q and o: element strides of image, head, row
  int kv_sb, kv_sh, kv_ss;   // k and v
  float scale;
};

// the first element of (image b, head h) in a tensor of these strides
template <typename T>
__device__ __forceinline__ const T* head_base(const void* p, int sb, int sh,
                                              int b, int h) {
  return static_cast<const T*>(p) + static_cast<size_t>(b) * sb +
         static_cast<size_t>(h) * sh;
}

template <int HD, int LIVE>
__global__ void __launch_bounds__(kPlainWarps * 32)
    attention_plain_bf16_kernel(PlainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + kPlainQTile * row_ld<HD>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kPlainQTile;
  const __nv_bfloat16* qg = head_base<__nv_bfloat16>(a.q, a.q_sb, a.q_sh, b, h);
  const __nv_bfloat16* kg =
      head_base<__nv_bfloat16>(a.k, a.kv_sb, a.kv_sh, b, h);
  const __nv_bfloat16* vg =
      head_base<__nv_bfloat16>(a.v, a.kv_sb, a.kv_sh, b, h);

  // the Q tile, zero past Sq and past LIVE columns; the ring's columns
  // past LIVE zeroed once (stage_rows never writes them)
  constexpr int kChunks = HD / 8, kLive = LIVE / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kPlainQTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = zero;
    if (q0 + r < a.sq && c < kLive)
      val = *reinterpret_cast<const uint4*>(
          qg + static_cast<size_t>(q0 + r) * a.q_ss + c * 8);
    *reinterpret_cast<uint4*>(qs + r * row_ld<HD>() + c * 8) = val;
  }
  if constexpr (kLive < kChunks) {
    for (int i = threadIdx.x; i < 4 * kKeyTile * (kChunks - kLive);
         i += blockDim.x) {
      const int r = i / (kChunks - kLive), c = kLive + i % (kChunks - kLive);
      *reinterpret_cast<uint4*>(ring + r * row_ld<HD>() + c * 8) = zero;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  AttnWarp<HD> w;
  load_q<HD>(w, qs + r0 * row_ld<HD>(), lane);
  attn_stream<HD, LIVE>(w, kg, vg, static_cast<size_t>(a.kv_ss), a.skv,
                        nullptr, a.scale, ring, lane);

  // rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3), the LIVE columns
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) +
                      static_cast<size_t>(b) * a.q_sb +
                      static_cast<size_t>(h) * a.q_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= a.sq) continue;
    __nv_bfloat16* row = og + static_cast<size_t>(qi) * a.q_ss;
#pragma unroll
    for (int dt = 0; dt < LIVE / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(w.o[dt][2 * r], w.o[dt][2 * r + 1]);
  }
}

template <int HD, int LIVE>
int launch_plain_bf16(const PlainArgs& a, int batch, void* stream) {
  const size_t smem =
      static_cast<size_t>(kPlainQTile * row_ld<HD>() + ring_elems<HD>()) *
      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_plain_bf16_kernel<HD, LIVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kPlainQTile - 1) / kPlainQTile, a.heads, batch);
  attention_plain_bf16_kernel<HD, LIVE>
      <<<grid, kPlainWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          a);
  return static_cast<int>(cudaGetLastError());
}

// row stride of the f32 tiles in shared memory: one float past head_dim
__host__ __device__ constexpr int f32_ld(int hd) { return hd + 1; }

__global__ void __launch_bounds__(kF32Warps * 32)
    attention_plain_f32_kernel(PlainArgs a, int hd) {
  extern __shared__ float fsm[];
  const int ld = f32_ld(hd);
  float* qs = fsm;                                  // kF32QTile x ld
  float* ks = qs + kF32QTile * ld;                  // kF32KeyTile x ld
  float* vs = ks + kF32KeyTile * ld;                // kF32KeyTile x ld
  float* ps = vs + kF32KeyTile * ld;                // kF32QTile x 32
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kF32QTile;
  const float* qg = head_base<float>(a.q, a.q_sb, a.q_sh, b, h);
  const float* kg = head_base<float>(a.k, a.kv_sb, a.kv_sh, b, h);
  const float* vg = head_base<float>(a.v, a.kv_sb, a.kv_sh, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float neg_inf = __int_as_float(0xff800000);

  for (int i = threadIdx.x; i < kF32QTile * hd; i += blockDim.x) {
    const int r = i / hd, c = i % hd;
    qs[r * ld + c] =
        q0 + r < a.sq ? qg[static_cast<size_t>(q0 + r) * a.q_ss + c] : 0.0f;
  }

  auto load_tile = [&](float* dst, const float* src, int k0) {
    for (int i = threadIdx.x; i < kF32KeyTile * hd; i += blockDim.x) {
      const int r = i / hd, c = i % hd;
      dst[r * ld + c] = k0 + r < a.skv
                            ? src[static_cast<size_t>(k0 + r) * a.kv_ss + c]
                            : 0.0f;
    }
  };
  // (q_row . k_lane) * scale for key k0 + lane, -inf past Skv
  auto score = [&](int row, int k0) {
    if (k0 + lane >= a.skv) return neg_inf;
    const float* qr = qs + row * ld;
    const float* kr = ks + lane * ld;
    float s = 0.0f;
    for (int c = 0; c < hd; ++c) s = fmaf(qr[c], kr[c], s);
    return s * a.scale;
  };

  float mx[kF32Rows], sum[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    mx[r] = neg_inf;
    sum[r] = 0.0f;
  }
  // ---- pass 1: each row's max and sum of exp(s - max)
  for (int k0 = 0; k0 < a.skv; k0 += kF32KeyTile) {
    __syncthreads();
    load_tile(ks, kg, k0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const float s = score(warp * kF32Rows + r, k0);
      const float m = fmaxf(mx[r], warp_max(s));
      sum[r] = sum[r] * expf(mx[r] - m) + warp_sum(expf(s - m));
      mx[r] = m;
    }
  }
  // ---- pass 2: p = exp(s - max) / sum, o += p . v
  constexpr int kDims = kF32MaxHd / 32;
  float o[kF32Rows][kDims];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int j = 0; j < kDims; ++j) o[r][j] = 0.0f;
  for (int k0 = 0; k0 < a.skv; k0 += kF32KeyTile) {
    __syncthreads();
    load_tile(ks, kg, k0);
    load_tile(vs, vg, k0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int row = warp * kF32Rows + r;
      const float s = score(row, k0);
      ps[row * 32 + lane] = expf(s - mx[r]) / sum[r];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int c = lane + 32 * j;
        if (c < hd) {
          float acc = o[r][j];
          for (int key = 0; key < kF32KeyTile; ++key)
            acc = fmaf(ps[row * 32 + key], vs[key * ld + c], acc);
          o[r][j] = acc;
        }
      }
      __syncwarp();
    }
  }
  float* og = static_cast<float*>(a.o) + static_cast<size_t>(b) * a.q_sb +
              static_cast<size_t>(h) * a.q_sh;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int qi = q0 + warp * kF32Rows + r;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) og[static_cast<size_t>(qi) * a.q_ss + c] = o[r][j];
    }
  }
}

int launch_plain_f32(const PlainArgs& a, int batch, int hd, void* stream) {
  const int ld = f32_ld(hd);
  const size_t smem = static_cast<size_t>(kF32QTile * ld +
                                          2 * kF32KeyTile * ld +
                                          kF32QTile * 32) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_plain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kF32QTile - 1) / kF32QTile, a.heads, batch);
  attention_plain_f32_kernel<<<grid, kF32Warps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(a, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudf

// q, o: (B, H, Sq, D) or (B, Sq, H, D); k, v: (B, H, Skv, D) or (B, Skv,
// H, D), as the strides say (elements of image, head and row; unit stride
// along D). bf16: head_dim 64, 72 or 128, every row start 16-byte aligned.
// f32: head_dim <= 128. Sq, Skv >= 1.
TPUDF_API int tpudf_attention_plain(const void* q, const void* k,
                                    const void* v, void* o, int is_f32,
                                    int batch, int heads, int sq, int skv,
                                    int head_dim, int q_sb, int q_sh,
                                    int q_ss, int kv_sb, int kv_sh,
                                    int kv_ss, float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (skv <= 0) return cudaErrorInvalidValue;
  const PlainArgs a{q,     k,     v,     o,     heads, sq,    skv, q_sb,
                    q_sh,  q_ss,  kv_sb, kv_sh, kv_ss, scale};
  if (is_f32) {
    if (head_dim > kF32MaxHd) return cudaErrorInvalidValue;
    return launch_plain_f32(a, batch, head_dim, stream);
  }
  if (head_dim == 64) return launch_plain_bf16<64, 64>(a, batch, stream);
  if (head_dim == 72) return launch_plain_bf16<80, 72>(a, batch, stream);
  if (head_dim == 128) return launch_plain_bf16<128, 128>(a, batch, stream);
  return cudaErrorInvalidValue;
}
