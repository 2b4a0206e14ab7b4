// Kernel 9b: the fused-QKV attention with dynamically quantised int8
// products, replacing tpudf/ops/attention.py `_attention_qkv_pallas` with
// int8_attn=True (`_one_head`, lines 209-246), which the static-W8A8
// block's reference route runs under TPUDF_INT8_ATTN=1 (int8_block.py
// `_attn_out_reference`). Per image and head, the TPU kernel's function:
//   aq = amax|q| + 1e-6 over the head's rows of one query block of
//        qb = min(256, S) rows (the Pallas grid's q block; the q axis is
//        zero-padded to a multiple of qb), ak, av = amax|k|, amax|v| + 1e-6
//        over all S rows;
//   q8 = clip(round(q * (127 / aq)), +-127), k8 and v8 likewise;
//   s = int32(q8 . k8) * ((aq * ak) / (127 * 127) * scale) in f32;
//   p = e / sum(e), e = exp(s - max) in f32 (an exact softmax);
//   ap = max p + 1e-20 per row (= 1 / l, as the row's largest e is 1);
//   p8 = round(p * (127 / ap)), not clipped (p <= ap);
//   o = int32(p8 . v8) * (ap * (av / (127 * 127))), rounded to bf16.
//
// Two launches. The pre-pass (`attention_i8_prepass`): one block per
// (head, image) reduces |k| and |v| over the sequence and |q| over each
// query block into a (B, H, nqb + 2) f32 table (exact: a max does not
// depend on its order) and, at heads of 64 and 128, writes each code once:
// q8 and k8 as (B, H, S_pad, hd) int8 and v8 transposed, (B, H, hd, S_pad),
// with each 16 keys in the order in which a thread holds its scores
// (`vt_pos`), zeros past S (S_pad: S rounded up to 128); each tensor's
// codes are written right after its amax, while its rows are still in L2.
// The main pass at heads of 64 and 128 (`attention_i8dyn_sm90`, on
// sm90.cuh's machinery) is persistent over items of (128 query rows, head,
// image): two consumer warpgroups of 64 rows and a producer warpgroup
// (setmaxnreg); q8 arrives by TMA once an item (two buffers, so the next
// item's lands during this one), k8 and v8t tiles of 64 keys by TMA
// through an mbarrier ring, in two sweeps over the keys: the first for
// each row's max and sum, the second for p8 and p8 . v8. qb is 256 or S,
// so an item never straddles two query blocks. Both products run on the
// tensor cores as int8 wgmma with exact int32 sums (p8 . v8 at most 127 *
// 127 * S, under 2^31 for S <= kMaxSeq), each rounded once to f32, as JAX
// converts its int32 dot (past S = 1040 that rounding can lose bits): q8 .
// k8 as m64n64k32 with both operands K-major in shared memory (the
// 128-byte swizzle at hd 128, the 64-byte one at 64), p8 . v8 as
// m64n{hd}k32 with p8 as register A, built from the score accumulators
// (a k32 step's fragment is mma.sync m16n8k32's per warp: lane t holds the
// scores of keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16, bytes 4t .. 4t + 3
// of its row, which is why v8t's keys lie in `vt_pos` order), against v8t
// K-major along the keys (64-byte rows: the 64-byte swizzle). The softmax
// runs kernels 11 and 12's instructions (scores that carry log2 e, ex2, p
// = e r with r = 1 / l by the IEEE division's fast path; sm90.cuh), and
// ap = r + 1e-20. Keys past S are masked in the first sweep only: in the
// second their p8 multiplies v8t's zero codes. o leaves as bf16 by TMA
// stores, rows past S clipped. Bound at the reference route's (8, 1024,
// 6144): the bytes of qkv and the output. Heads of 16 and 32 arrive
// zero-padded to 64 (the padded columns quantise to 0 and add nothing).
//
// At heads of 256 and of 384 to 1280 the pre-pass fills the amax table
// only, and the mma.sync kernels below quantise q, k and v themselves: one
// block per (64-query tile, head, image), four warps of 16 rows, the
// tile's q quantised into shared memory once and the head's K and V tile
// by tile (64 keys) as they stream in, both products as int8 mma.sync
// m16n8k32; at 256 one block per 128-column slice of the head's o (its
// int32 o would be 128 registers a thread beside 32 of q8 fragments and 64
// of scores and codes), each computing the full 256-deep scores, its V
// codes 10 KB of the 44 KB of static shared memory.
//
// Kernel 17: the same attention with static scales, replacing
// scripts/micro_attn_static.py's `kernel` (`static_variant` -> `build` ->
// `fn`, `_one_head` at lines 40-59), a probe of whether fixed per-tensor
// scales aq = ak = av (3.0 there) beat the amax pass. The five constants
// 127 / aq, 127 / ak, 127 / av, fac = (aq * ak) / 127^2 * scale and cv =
// av / 127^2 come in as arguments, computed by the caller in double and
// rounded once to f32, as JAX rounds the probe's Python-float constants.
// The probe runs only at head_dim 128 (its pl.multiple_of(h * d, 128)
// slice), so only that width is built. Two launches on 9b's machinery:
//   the pre-pass in its static mode (`attention_i8_prepass<true>`): the
//     codes of k and v only, no amax table, each block 128 rows of one of
//     them (v's transpose through shared memory in a swizzle that spreads
//     a key's bytes over the banks), so each is read once;
//   the main pass `attention_i8dyn_sm90<128, true>`: 9b's items,
//     warpgroups, ring and products, q in bf16 by TMA straight from qkv,
//     each consumer warpgroup quantising its 64 rows into a q8 tile in
//     shared memory once an item (no q8 in device memory), and the
//     softmax reordered by what static scales allow. JAX's p8 = round(p
//     127 / ap) with ap = max p + 1e-20 = 1 / l in f32 (the row's largest
//     e is 1, and 1e-20 lies far below 1 / l's ulp), so p8 = round(127 e)
//     but within a few f32 ulps of a tie; and as fac > 0, JAX's row max of
//     f32(s) fac is f32(M) fac exactly for M the row's integer max of s
//     (both the convert and the rounded product are monotone). So the
//     first sweep keeps only M (one integer max a score: no convert, no
//     ex2, no sum), and the second forms e = 2^((s - M) fac log2 e) once a
//     score, adds it to l and writes p8 = rint(127 e), with tile kt + 1's
//     scores in flight while tile kt's codes are formed (two score
//     buffers; 9b waits for each tile's scores); o = int32(p8 . v8) ((1 /
//     l + 1e-20) cv). Keys past S are masked in both sweeps: in the first
//     their zero scores could exceed a row whose real scores are all
//     negative, in the second they would add to l (v8t's zero codes
//     cancel them only in o).
// Its codes (k8 (B, H, S_pad, 128), v8t (B, H, 128, S_pad): 2 B H S_pad
// 128 bytes of scratch) are read by tensor maps that keep one head a depth
// index, so no TMA coordinate exceeds S_pad or B H. Bound at its (8, 1024,
// 6144): the bytes of qkv and the output.
#include <climits>

#include "attn_tile.cuh"
#include "sm90.cuh"

namespace tpudf {

constexpr int kI8QTile = 64;            // query rows per block: 4 warps
constexpr int kI8Warps = 4;
constexpr int kVtLd = kKeyTile + 16;    // bytes of a transposed V row

// bytes of a q8 / k8 row in shared memory (16 bytes of padding keep the
// lds32 of 8 rows x 4 lanes on distinct banks)
template <int HD>
__host__ __device__ constexpr int i8_ld() {
  return HD + 16;
}

// the position of key x (0..63 of a tile) in a transposed V row: keys
// 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16 go to 4t .. 4t + 3, the bytes lane
// t's A fragment holds for them
__device__ __forceinline__ int vt_pos(int x) {
  const int y = x & 15;
  return (x & ~15) + 4 * ((y & 7) >> 1) + 2 * (y >> 3) + (y & 1);
}

__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<unsigned>(a) & 0xffu) |
         ((static_cast<unsigned>(b) & 0xffu) << 8) |
         ((static_cast<unsigned>(c) & 0xffu) << 16) |
         ((static_cast<unsigned>(d) & 0xffu) << 24);
}

// ------------------------------------------------------------- pre-pass

constexpr int kPreThreads = 512;
constexpr int kI8Rows = 128;            // the main pass's query rows an item

// S rounded up to whole items: the rows of q8 and k8 and the keys of v8t
__host__ __device__ constexpr int i8_pad(int seq) {
  return (seq + kI8Rows - 1) / kI8Rows * kI8Rows;
}

// max |x| over rows r0 .. r1 - 1 of one head's hd = 8 chunks columns at
// `src` (rows `ld` apart); all threads of the block, each gets it
__device__ __forceinline__ float block_amax(const __nv_bfloat16* src,
                                            size_t ld, int r0, int r1,
                                            int chunks, float* red) {
  float m = 0.0f;
#pragma unroll 4
  for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x) {
    float f[8];
    load8(src + static_cast<size_t>(r0 + i / chunks) * ld + (i % chunks) * 8,
          f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  }
  m = warp_max(m);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max(lane < kPreThreads / 32 ? red[lane] : 0.0f);
  __syncthreads();                      // red may be written again
  return m;
}

// rows r0 .. r1 - 1 of one head at `src` (rows `ld` apart) as codes
// clip(round(x * inv), +-127) into rows of `dst` (hd bytes each), and
// rows r1 .. r2 - 1 of `dst` as zeros; all threads
__device__ __forceinline__ void code_rows(int8_t* dst,
                                          const __nv_bfloat16* src,
                                          size_t ld, int r0, int r1, int r2,
                                          int chunks, float inv) {
#pragma unroll 4
  for (int i = threadIdx.x; i < (r2 - r0) * chunks; i += blockDim.x) {
    const int r = r0 + i / chunks, c = (i % chunks) * 8;
    __align__(8) int8_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < r1) {
      float f[8];
      load8(src + static_cast<size_t>(r) * ld + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
    }
    *reinterpret_cast<uint2*>(dst + static_cast<size_t>(r) * (chunks * 8) +
                              c) = *reinterpret_cast<const uint2*>(v);
  }
}

// keys k_begin .. k_end - 1 (multiples of kVtKeys) of one head's v at
// `src` as codes into v8t (hd rows of sp bytes: the keys), kVtKeys keys at
// a time through `vt` (hd rows of kVtKeys bytes), key x at (x & ~63) +
// vt_pos(x & 63); zeros past seq; all threads. kSwizzle (kernel 17): row
// d of `vt` holds its 16-byte chunk j at j ^ ((d / 8) % 8), so the 16
// threads that write one key's byte of dims c .. c + 7, c = 0, 8, ..., 120,
// meet in pairs on a bank where without it all 16 meet on one (9b keeps
// the unswizzled rows)
constexpr int kVtKeys = 128;            // sp is a multiple of it

template <bool kSwizzle>
__device__ __forceinline__ void code_vt(int8_t* v8t, const __nv_bfloat16* src,
                                        size_t ld, int seq, int k_begin,
                                        int k_end, int sp, int chunks,
                                        float inv, int8_t* vt) {
  auto swz = [](int d) { return kSwizzle ? ((d >> 3) & 7) << 4 : 0; };
  for (int k0 = k_begin; k0 < k_end; k0 += kVtKeys) {
#pragma unroll 4
    for (int i = threadIdx.x; i < kVtKeys * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i % chunks) * 8;
      float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (k0 + r < seq) load8(src + static_cast<size_t>(k0 + r) * ld + c, f);
      const int pos =
          ((r & ~(kKeyTile - 1)) + vt_pos(r & (kKeyTile - 1))) ^ swz(c);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kVtKeys + pos] =
          quant_i8(f[j], inv);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < chunks * 8 * (kVtKeys / 16);
         i += blockDim.x) {
      const int d = i / (kVtKeys / 16), q = (i % (kVtKeys / 16)) * 16;
      *reinterpret_cast<uint4*>(v8t + static_cast<size_t>(d) * sp + k0 + q) =
          *reinterpret_cast<const uint4*>(vt + d * kVtKeys + (q ^ swz(d)));
    }
    __syncthreads();
  }
}

// One block per (segment, head, image). 9b (kStatic false), segment z:
// |k| (z = 0) or |v| (1) over the sequence or |q| over query block z - 2,
// + 1e-6, into the amax table (the rows of `_one_head`'s scales), and
// where q8 is not null that segment's codes right after its amax (its rows
// still in L2). Kernel 17 (kStatic): no amax, no q (its main pass
// quantises q itself); segment z codes rows kVtKeys (z / 2) .. + kVtKeys -
// 1 of k (z % 2 = 0) or v (1) at inv.y or .z, so every block moves the
// same bytes. Codes: k8 and q8 as (B, H, sp, hd), v8t as (B, H, hd, sp)
// in vt_pos order, zeros past seq.
template <bool kStatic>
__global__ void __launch_bounds__(kPreThreads)
    attention_i8_prepass(const __nv_bfloat16* __restrict__ qkv,
                         float* __restrict__ amax, int8_t* __restrict__ q8,
                         int8_t* __restrict__ k8, int8_t* __restrict__ v8t,
                         int seq, int heads, int hd, int qb, float3 inv) {
  __shared__ __align__(16) int8_t vt[128 * kVtKeys];
  const int h = blockIdx.x, b = blockIdx.y;
  const int wa = heads * hd, chunks = hd / 8, sp = i8_pad(seq);
  const size_t row3 = static_cast<size_t>(3) * wa;
  const size_t bh = static_cast<size_t>(b) * heads + h;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * hd;
  if constexpr (kStatic) {
    const int r0 = blockIdx.z / 2 * kVtKeys;
    if (blockIdx.z % 2)
      code_vt<true>(v8t + bh * hd * sp, base + 2 * wa, row3, seq, r0,
                    r0 + kVtKeys, sp, chunks, inv.z, vt);
    else
      code_rows(k8 + bh * sp * hd, base + wa, row3, r0,
                min(seq, r0 + kVtKeys), r0 + kVtKeys, chunks, inv.y);
  } else {
    __shared__ float red[kPreThreads / 32];
    const int nqb = (seq + qb - 1) / qb;
    float* am = amax + bh * (nqb + 2);
    const int seg = blockIdx.z;
    const int col = seg == 0 ? wa : (seg == 1 ? 2 * wa : 0);
    const int r0 = seg < 2 ? 0 : (seg - 2) * qb;
    const int r1 = seg < 2 ? seq : min(seq, r0 + qb);
    const float a =
        __fadd_rn(block_amax(base + col, row3, r0, r1, chunks, red), 1e-6f);
    if (threadIdx.x == 0) am[seg < 2 ? nqb + seg : seg - 2] = a;
    if (q8 == nullptr) return;
    const float inv_a = __fdiv_rn(127.0f, a);
    if (seg == 1)
      code_vt<false>(v8t + bh * hd * sp, base + col, row3, seq, 0, sp, sp,
                     chunks, inv_a, vt);
    else
      code_rows((seg == 0 ? k8 : q8) + bh * sp * hd, base + col, row3, r0, r1,
                r1 == seq ? sp : r1, chunks, inv_a);
  }
}

// ---------------------------------------------- main pass (heads 64, 128)

namespace i8dyn {
using namespace sm90;

constexpr int kStages = 6;

// the main pass's shared memory at head width HK: two q buffers of 128
// rows (9b: q8; kernel 17: q in bf16 as TMA brings it, four boxes of 64
// rows x 64 columns, and then one q8 tile that each warpgroup fills with
// its 64 rows' codes), o's staging (HK / 64 sub-tiles of 128 rows x 128
// bytes), the ring (a stage: a 64-key tile of k8, then one of v8t: HK
// rows of 64 keys), the barriers (the ring's, and a full and an empty one
// a q buffer)
template <int HK, bool kStatic = false>
struct Smem {
  static constexpr int kQ = kBlockRows * HK * (kStatic ? 2 : 1);
  static constexpr int kKv = kTileRows * HK;
  static constexpr int kQ8 = 2 * kQ;                  // kernel 17's q8
  static constexpr int kO = 2 * kQ + (kStatic ? kBlockRows * HK : 0);
  static constexpr int kRing = kO + HK / 64 * kBlockSub;
  static constexpr int kStage = 2 * kKv;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr size_t kBytes = kBars + 8 * (2 * kStages + 4) + 1024;
};
static_assert(Smem<128>::kBytes <= kMaxBlockSmem, "9b main pass");
static_assert(Smem<128, true>::kBytes <= kMaxBlockSmem, "kernel 17");

// the descriptor of a K-major int8 operand of 64-byte rows in the 64-byte
// swizzle (layout type 2: 8-row atoms 512 bytes apart), its rows starting
// at `rows` (a multiple of 8 rows into a 512-byte-aligned tile)
__device__ __forceinline__ uint64_t desc_k64(const void* rows) {
  return static_cast<uint64_t>((smem_u32(rows) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}

// the K-major descriptor of rows of HK bytes: the 128-byte swizzle at 128,
// the 64-byte one at 64; k32 step ks starts 32 ks bytes on (+2 ks)
template <int HK>
__device__ __forceinline__ uint64_t desc_rows(const void* rows) {
  if constexpr (HK == 128)
    return desc_k(rows);
  else
    return desc_k64(rows);
}

// s (64 x 64) int32 = A . B^T (+ s if scale_d): q8 and k8 K-major in
// shared memory; s's layout as wgmma_ss's (sm90.cuh)
__device__ __forceinline__ void wgmma_qk(int (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// o (64 x N) int32 += A . B: A (64 x 32) int8 in registers (the k32
// fragment of mma.sync m16n8k32 per warp), B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_pv(int (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = q8 . k8^T over HK for the warpgroup's q8 rows (descriptor `da`) and
// the 64 keys of the tile at `k`: fenced and issued, not committed
template <int HK>
__device__ __forceinline__ void issue_qk(int (&s)[32], uint64_t da,
                                         const void* k) {
  const uint64_t a0 = opaque(da), b0 = opaque(desc_rows<HK>(k));
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < HK / 32; ++ks)
    wgmma_qk(s, a0 + 2 * ks, b0 + 2 * ks, ks > 0);
  fence_regs(s);
}

// the first sweep on one tile's f32 scores f[4 j + e] (rows e >> 1, in
// log2 units): each row's max m and sum l = sum 2^(f - m), kept online (l
// rescaled when m grows), per thread over its keys
__device__ __forceinline__ void online(const float (&f)[32], float (&m)[2],
                                       float (&l)[2]) {
  float tm[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) tm[(i >> 1) & 1] = fmaxf(tm[(i >> 1) & 1], f[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = quad_max(tm[r]);
    l[r] = __fmul_rn(l[r], ex2(__fsub_rn(m[r], tm[r])));
    m[r] = tm[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    l[(i >> 1) & 1] =
        __fadd_rn(l[(i >> 1) & 1], ex2(__fsub_rn(f[i], m[(i >> 1) & 1])));
}

// int32 -> f32 exactly for |v| < 2^22 (the scores: |q8 . k8| <= 127^2
// 128), by the add of 1.5 * 2^23 to the bits and its subtraction as a
// float: two full-rate instructions in place of a quarter-rate convert
constexpr float kMagic = 12582912.0f;        // 1.5 * 2^23: 0x4B400000

__device__ __forceinline__ float i2f(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), kMagic);
}

// four codes, the first in the low byte (the lowest k): the low byte of
// each argument
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the second sweep's p8 = round(2^(f - m) r * (127 / ap)) of a tile's
// scores, in place: the round is the add of 1.5 * 2^23 (round to nearest
// even, as rint), whose low byte is the code for p8 in [0, 127] (keys past
// seq, unmasked here, may give any byte: v8t's codes there are zero)
__device__ __forceinline__ void p8_codes(int (&s)[32], float fac2,
                                         const float (&m)[2],
                                         const float (&rl)[2],
                                         const float (&inv_ap)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float e = ex2(__fsub_rn(__fmul_rn(i2f(s[i]), fac2), m[r]));
    s[i] = __float_as_int(
        __fadd_rn(__fmul_rn(__fmul_rn(e, rl[r]), inv_ap[r]), kMagic));
  }
}

// kernel 17's second sweep on the scores s of the tile of keys k0 .. k0
// + 63: e = 2^((s - M) fac2) once a score, with M the row's integer max
// (0 for keys past seq), added to the thread's row sums l, and into p the
// code p8 = rint(127 e) as the low byte of one FFMA with 1.5 * 2^23 (e <=
// 1: the code in [0, 127]). (s - M) fac2 is rounded once, from the float
// 2^23 + (s - M) (exact: 0 >= s - M >= -2 127^2 128 > -2^22, so its bits
// are 2 s + kb with kb = 0x4B000000 - 2 M, one IMAD) by one FFMA with
// -2^23 fac2 (exact). p is not s: while s's registers are written, the
// next tile's product into the other score buffer is in flight, and ptxas
// would serialise every wgmma (C7515)
__device__ __forceinline__ void p8_codes_static(const int (&s)[32],
                                                int (&p)[32], float fac2,
                                                const int (&kb)[2],
                                                float (&l)[2], int k0,
                                                int seq, int t) {
  const bool edge = k0 + kTileRows > seq;
  const float c23 = -8388608.0f * fac2;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float e = ex2(__fmaf_rn(__int_as_float(2 * s[i] + kb[r]), fac2, c23));
    if (edge && k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= seq) e = 0.0f;
    l[r] = __fadd_rn(l[r], e);
    p[i] = __float_as_int(__fmaf_rn(e, 127.0f, kMagic));
  }
}

// kernel 17: a warpgroup's 64 rows of q, two boxes of 64 columns of bf16
// as TMA brought them (128-byte swizzle: a row's 16-byte chunk g at g ^
// (row % 8); rows past S zero), quantised at inv into its 64 rows of the
// q8 tile (128-byte rows in the same swizzle, which wgmma's K-major
// descriptor reads). Thread t: 8-column group t % 8 of rows t / 8 + 16 j;
// a warp reads 4 rows of 128 bytes and writes 8 bytes a thread.
__device__ __forceinline__ void quant_q(unsigned char* q8,
                                        const unsigned char* boxes,
                                        float inv) {
  const int t = threadIdx.x & 127, g = t & 7;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = t / 8 + 16 * j, col = 64 * h + 8 * g;
      const uint4 v = *reinterpret_cast<const uint4*>(
          boxes + h * kTileRows * 128 + row * 128 + ((g ^ (row & 7)) << 4));
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&v);
      float f[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 y = __bfloat1622float2(x[k]);
        f[2 * k] = y.x;
        f[2 * k + 1] = y.y;
      }
      *reinterpret_cast<uint2*>(q8 + row * 128 +
                                (((col >> 4) ^ (row & 7)) << 4) +
                                (col & 15)) = make_uint2(
          pack_s8x4(quant_i8(f[0], inv), quant_i8(f[1], inv),
                    quant_i8(f[2], inv), quant_i8(f[3], inv)),
          pack_s8x4(quant_i8(f[4], inv), quant_i8(f[5], inv),
                    quant_i8(f[6], inv), quant_i8(f[7], inv)));
    }
}

__device__ __forceinline__ int quad_max_i(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the codes of a tile as the register A fragments of its two k32 steps
// (keys 0-31, 32-63): lane t's bytes 4t .. 4t + 3 of a row are its codes
// of keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16
__device__ __forceinline__ void p8_frags(uint32_t (&a)[2][4],
                                         const int (&p8)[32]) {
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    const int j = 16 * kc;
    a[kc][0] = pack4(p8[j], p8[j + 1], p8[j + 4], p8[j + 5]);
    a[kc][1] = pack4(p8[j + 2], p8[j + 3], p8[j + 6], p8[j + 7]);
    a[kc][2] = pack4(p8[j + 8], p8[j + 9], p8[j + 12], p8[j + 13]);
    a[kc][3] = pack4(p8[j + 10], p8[j + 11], p8[j + 14], p8[j + 15]);
  }
}

// 9b (kStatic false): the scales from the amax table (query blocks of qb
// rows), `scale` the softmax scale, inv_q and cv unused; q8, k8 and v8t
// read by maps that stack the heads' rows. Kernel 17 (kStatic): amax and
// qb unused, `scale` the static score factor fac, cv = av / 127^2, q_map
// the bf16 q of qkv (quantised at inv_q = 127 / aq in the block), k8 and
// v8t maps with one head a depth index.
template <int HK, bool kStatic>
__global__ void __launch_bounds__(kThreads, 1)
    attention_i8dyn_sm90(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const float* __restrict__ amax, int seq, int heads,
                         int batch, int qb, float scale, float inv_q,
                         float cv_static) {
  using L = Smem<HK, kStatic>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const Ring<kStages> ring{bars, bars + kStages};
  uint64_t* q_full = bars + 2 * kStages;       // one a q buffer
  uint64_t* q_empty = q_full + 2;
  auto stage = [&](int r) {
    return smem + L::kRing + ring.stage(r) * L::kStage;
  };
  const int sp = i8_pad(seq), n_qi = sp / kBlockRows;
  const int items = n_qi * heads * batch;
  const int ntiles = (seq + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], kWarpgroups * 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kWarpgroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroups * 128) {
    // ---- producer: one lane issues every load; item i's q8 (kernel 17:
    // its q in bf16) into buffer i % 2 once item i - 2 has released it,
    // then the k8 tiles of the first sweep and the k8 and v8t tiles of the
    // second
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x != kWarpgroups * 128) return;
    int r = 0, it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int bh = item / n_qi, q0 = item % n_qi * kBlockRows;
      // the head's first row and its depth index in the maps
      const int y0 = kStatic ? 0 : bh * sp, z = kStatic ? bh : 0;
      const int v0 = kStatic ? 0 : bh * HK;
      const int buf = it & 1;
      unsigned char* qs = smem + buf * L::kQ;
      if (it >= 2) mbar_wait(&q_empty[buf], ((it >> 1) - 1) & 1);
      mbar_expect_tx(&q_full[buf], L::kQ);
      if constexpr (kStatic) {
        // box j: rows q0 + 64 (j / 2), columns 64 (j % 2) of head bh
        for (int j = 0; j < 4; ++j)
          tma_load_4d(qs + j * kTileRows * 128, &q_map, &q_full[buf],
                      64 * (j & 1), q0 + kTileRows * (j >> 1), bh % heads,
                      bh / heads);
      } else {
        tma_load_3d(qs, &q_map, &q_full[buf], 0, y0 + q0, z);
        tma_load_3d(qs + L::kKv, &q_map, &q_full[buf], 0,
                    y0 + q0 + kTileRows, z);
      }
      for (int pass = 0; pass < 2; ++pass)
        for (int kt = 0; kt < ntiles; ++kt, ++r) {
          uint64_t* full =
              ring.producer_acquire(r, pass ? L::kStage : L::kKv);
          unsigned char* st = stage(r);
          tma_load_3d(st, &k_map, full, 0, y0 + kt * kTileRows, z);
          if (pass)
            tma_load_3d(st + L::kKv, &v_map, full, kt * kTileRows, v0, z);
        }
    }
    return;
  }

  // ---- consumers: 64 query rows of each item
  reg_alloc<kConsumerRegs>();
  const Consumer c = consumer();
  const int nqb = (seq + qb - 1) / qb;
  const float neg_inf = __int_as_float(0xff800000);
  const float r127sq = rcp_refined(16129.0f);
  int r = 0, it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int bh = item / n_qi, q0 = item % n_qi * kBlockRows;
    const int buf = it & 1;
    float fac2, cv;
    if constexpr (kStatic) {
      fac2 = __fmul_rn(scale, kLog2e);
      cv = cv_static;
    } else {
      // the scales of `_one_head`: aq of the item's query block, ak, av
      const float* am = amax + static_cast<size_t>(bh) * (nqb + 2);
      const float aq = am[q0 / qb], ak = am[nqb], av = am[nqb + 1];
      fac2 = __fmul_rn(
          __fmul_rn(div_rn(__fmul_rn(aq, ak), 16129.0f, r127sq), scale),
          kLog2e);
      cv = div_rn(av, 16129.0f, r127sq);
    }
    mbar_wait(&q_full[buf], (it >> 1) & 1);
    unsigned char* q8 =
        smem + (kStatic ? L::kQ8 : buf * L::kQ) + c.wg * L::kKv;
    if constexpr (kStatic) {
      // this warpgroup's 64 rows of q as codes, then the bf16 buffer is
      // free for item it + 2
      quant_q(q8, smem + buf * L::kQ + c.wg * 2 * L::kKv, inv_q);
      mbar_arrive(&q_empty[buf]);
      fence_proxy_async();
      warpgroup_sync(c.wg);
    }
    const uint64_t da = desc_rows<HK>(q8);
    float m[2] = {neg_inf, neg_inf}, l[2] = {0.0f, 0.0f};
    int mi[2] = {INT_MIN, INT_MIN};     // kernel 17: the integer row max
    int kb[2];
    int s[32];

    // ---- sweep 1: each row's max and sum (kernel 17: its integer max),
    // keys past seq masked; tile kt + 1's scores are issued before tile
    // kt's are reduced (two tiles a round, into s and s1 in turn)
    int s1[32];
    auto reduce = [&](int kt, const int (&sc)[32]) {
      const bool edge = (kt + 1) * kTileRows > seq;
      if constexpr (kStatic) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = kt * kTileRows + 8 * (i >> 2) + 2 * c.t + (i & 1);
          if (!edge || key < seq)
            mi[(i >> 1) & 1] = max(mi[(i >> 1) & 1], sc[i]);
        }
      } else {
        float f[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) f[i] = __fmul_rn(i2f(sc[i]), fac2);
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (kt * kTileRows + 8 * (i >> 2) + 2 * c.t + (i & 1) >= seq)
              f[i] = neg_inf;
        }
        online(f, m, l);
      }
    };
    ring.consumer_wait(r);
    issue_qk<HK>(s, da, stage(r));
    wg_commit();
    for (int kt = 0; kt < ntiles; kt += 2, r += 2) {
      if (kt + 1 < ntiles) {
        ring.consumer_wait(r + 1);
        issue_qk<HK>(s1, da, stage(r + 1));
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(s);
      ring.release(r);
      reduce(kt, s);
      if (kt + 1 >= ntiles) {
        ++r;                            // one tile this round
        break;
      }
      if (kt + 2 < ntiles) {
        ring.consumer_wait(r + 2);
        issue_qk<HK>(s, da, stage(r + 2));
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(s1);
      ring.release(r + 1);
      reduce(kt + 1, s1);
    }
    float rl[2], inv_ap[2], osc[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if constexpr (kStatic) {
        kb[rr] = 0x4B000000 - 2 * quad_max_i(mi[rr]);
      } else {
        const float sum = quad_sum(l[rr]);
        rl[rr] = div_rn(1.0f, sum, rcp_refined(sum));
        const float ap = __fadd_rn(rl[rr], 1e-20f);     // max p + 1e-20
        inv_ap[rr] = div_rn(127.0f, ap, rcp_refined(ap));
        osc[rr] = __fmul_rn(ap, cv);
      }
    }

    // ---- sweep 2: p8, o += p8 . v8 (int32); tile kt's p8 is formed
    // while tile kt - 1's product runs (9b: K9's order)
    int o[HK / 2];
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) o[i] = 0;
    fence_regs(o);                      // zeroed before any product issues
    uint32_t a[2][4];
    auto issue_pv = [&](int t, uint32_t (&af)[2][4]) {
      const uint64_t dv = desc_k64(stage(t) + L::kKv);
      fence_regs(o);
      fence_regs(af);
      wg_fence();
      wgmma_pv<HK>(o, af[0], dv);
      wgmma_pv<HK>(o, af[1], dv + 2);
      fence_regs(o);
      fence_regs(af);
    };
    if constexpr (!kStatic) {
      ring.consumer_wait(r);
      issue_qk<HK>(s, da, stage(r));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      p8_codes(s, fac2, m, rl, inv_ap);
      p8_frags(a, s);
      for (int kt = 1; kt < ntiles; ++kt) {
        ring.consumer_wait(r + kt);
        issue_qk<HK>(s, da, stage(r + kt));
        wg_commit();
        issue_pv(r + kt - 1, a);
        wg_commit();
        wg_wait<1>();                   // tile kt's scores; kt - 1's p . v
        fence_regs(s);
        p8_codes(s, fac2, m, rl, inv_ap);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(a);
        ring.release(r + kt - 1);
        p8_frags(a, s);
      }
      issue_pv(r + ntiles - 1, a);
    } else {
      // kernel 17: tile kt + 1's scores are issued before tile kt's codes
      // are formed, beside tile kt - 1's p . v (two score buffers, s and
      // s1, and two sets of A fragments, a and a1)
      uint32_t a1[2][4];
      int p[32];
      // tile kt (>= 1): its scores in `cur` (issued), kt - 1's codes in
      // `pa`; its codes into `ca`, the next tile's scores into `next`
      auto step = [&](int kt, int (&cur)[32], int (&next)[32],
                      uint32_t (&pa)[2][4], uint32_t (&ca)[2][4]) {
        issue_pv(r + kt - 1, pa);
        wg_commit();
        wg_wait<1>();                   // tile kt's scores
        fence_regs(cur);
        const bool more = kt + 1 < ntiles;
        if (more) {
          ring.consumer_wait(r + kt + 1);
          issue_qk<HK>(next, da, stage(r + kt + 1));
          wg_commit();
        }
        p8_codes_static(cur, p, fac2, kb, l, kt * kTileRows, seq, c.t);
        p8_frags(ca, p);
        if (more)
          wg_wait<1>();                 // tile kt - 1's p . v
        else
          wg_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        ring.release(r + kt - 1);
      };
      ring.consumer_wait(r);
      issue_qk<HK>(s, da, stage(r));
      wg_commit();
      if (ntiles > 1) {
        ring.consumer_wait(r + 1);
        issue_qk<HK>(s1, da, stage(r + 1));
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(s);
      p8_codes_static(s, p, fac2, kb, l, 0, seq, c.t);
      p8_frags(a, p);
      for (int kt = 1; kt < ntiles; kt += 2) {
        step(kt, s1, s, a, a1);
        if (kt + 1 < ntiles) step(kt + 1, s, s1, a1, a);
      }
      if ((ntiles - 1) & 1)
        issue_pv(r + ntiles - 1, a1);
      else
        issue_pv(r + ntiles - 1, a);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    ring.release(r + ntiles - 1);
    r += ntiles;
    if constexpr (!kStatic) {
      mbar_arrive(&q_empty[buf]);
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float sum = quad_sum(l[rr]);
        const float ap = __fadd_rn(div_rn(1.0f, sum, rcp_refined(sum)),
                                   1e-20f);             // max p + 1e-20
        osc[rr] = __fmul_rn(ap, cv);
      }
    }

    // ---- o = int32 sums * (ap * av / 127^2), bf16, by TMA (rows past
    // seq clipped)
    const int row0 = q0 + 64 * c.wg;
    if (row0 >= seq) continue;
    float of[HK / 2];
#pragma unroll
    for (int i = 0; i < HK / 2; ++i)
      of[i] = __fmul_rn(static_cast<float>(o[i]), osc[(i >> 1) & 1]);
    store_tile_4d<HK>(of, smem + L::kO + c.wg * 64 * 128, &o_map, row0,
                      bh % heads, bh / heads, c);
  }
  if ((threadIdx.x & 127) == 0) tma_store_wait();
}

// an int8 tensor of `depth` blocks of `rows` rows of `cols` bytes,
// row-major, cut in boxes of box_cols x box_rows (x 1) in the swizzle `sw`,
// zeros past the extents
inline bool map_i8(CUtensorMap* m, const void* base, uint64_t cols,
                   uint64_t rows, uint64_t depth, uint32_t box_cols,
                   uint32_t box_rows, CUtensorMapSwizzle sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      cols % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols, cols * rows};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 9b: the heads' rows stacked in one block of B H S_pad rows (its TMA row
// coordinates bound B H S_pad by an int, `i8dyn_sm90_ok`); kernel 17: one
// head a depth index (coordinates within S_pad and B H)
template <int HK, bool kStatic>
int launch(const void* q, const void* k8, const void* v8t,
           const void* amax, void* out, int batch, int seq, int heads,
           int qb, float scale, float inv_q, float cv, cudaStream_t s) {
  using L = Smem<HK, kStatic>;
  const uint64_t sp = i8_pad(seq);
  const uint64_t bh = static_cast<uint64_t>(batch) * heads;
  const uint64_t rows = kStatic ? sp : bh * sp, depth = kStatic ? bh : 1;
  const CUtensorMapSwizzle sw =
      HK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap q_map, k_map, v_map, o_map;
  const bool qm =
      kStatic ? map_bf16_4d(&q_map, q, HK, seq, heads, batch,
                            static_cast<uint64_t>(3) * heads * HK, HK,
                            static_cast<uint64_t>(seq) * 3 * heads * HK,
                            kTileRows)
              : map_i8(&q_map, q, HK, rows, depth, HK, kTileRows, sw);
  if (!qm || !map_i8(&k_map, k8, HK, rows, depth, HK, kTileRows, sw) ||
      !map_i8(&v_map, v8t, sp, kStatic ? HK : bh * HK, depth, kTileRows, HK,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !map_bf16_4d(&o_map, out, HK, seq, heads, batch,
                   static_cast<uint64_t>(heads) * HK, HK,
                   static_cast<uint64_t>(seq) * heads * HK, kTileRows))
    return cudaErrorInvalidValue;
  static const cudaError_t attr =
      registers_suffice(attention_i8dyn_sm90<HK, kStatic>)
          ? cudaFuncSetAttribute(attention_i8dyn_sm90<HK, kStatic>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(L::kBytes))
          : cudaErrorInvalidDeviceFunction;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long items = static_cast<long long>(sp / kBlockRows) * heads *
                          batch;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  attention_i8dyn_sm90<HK, kStatic><<<grid, kThreads, L::kBytes, s>>>(
      q_map, k_map, v_map, o_map, static_cast<const float*>(amax), seq,
      heads, batch, qb, scale, inv_q, cv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8dyn

// rows r0 .. r0 + n - 1 (zero past seq) of one head's HD columns at `src`
// (rows `ld` apart) as int8 codes clip(round(x * inv), +-127): row-major
// into `dst` (rows i8_ld<HD>() bytes apart) or, with kTransposed, into
// `dst` (dims kVtLd bytes apart) at the keys' vt_pos; all threads
template <int HD, bool kTransposed>
__device__ __forceinline__ void quant_rows_i8(int8_t* dst,
                                              const __nv_bfloat16* src,
                                              size_t ld, int r0, int n,
                                              int seq, float inv) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float f[8];
    if (r0 + r < seq) {
      load8(src + static_cast<size_t>(r0 + r) * ld + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    if constexpr (kTransposed) {
      const int pos = vt_pos(r);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[(c + j) * kVtLd + pos] = quant_i8(f[j], inv);
    } else {
      __align__(8) int8_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
      *reinterpret_cast<uint2*>(dst + r * i8_ld<HD>() + c) =
          *reinterpret_cast<uint2*>(v);
    }
  }
}

// s[j][e]: the warp's rows g (e = 0, 1) and g + 8 (e = 2, 3) against keys
// k0 + 8j + 2t + (e & 1) of the int8 tile `k8`: int32(q8 . k8) * fac in
// f32, -inf past seq
template <int HD>
__device__ __forceinline__ void scores_i8(float (&s)[kKeyTile / 8][4],
                                          const unsigned (&qa)[HD / 32][4],
                                          const int8_t* k8, int k0, int seq,
                                          float fac, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    int acc[4] = {0, 0, 0, 0};
    const int8_t* kr = k8 + (j * 8 + g) * i8_ld<HD>() + 4 * t;
#pragma unroll
    for (int kc = 0; kc < HD / 32; ++kc) {
      const unsigned b[2] = {lds32(kr + kc * 32), lds32(kr + kc * 32 + 16)};
      mma_s8(acc, qa[kc], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < seq ? __fmul_rn(static_cast<float>(acc[e]), fac)
                          : neg_inf;
    }
  }
}

// 9b at heads of 256, the scales from the amax table. Grid y: head x
// slice of HV columns of o.
template <int HD, int HV = HD>
__global__ void __launch_bounds__(kI8Warps * 32)
    attention_i8_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ amax,
                        __nv_bfloat16* __restrict__ out, int seq, int heads,
                        int qb, float scale) {
  __shared__ __align__(16) int8_t q8s[kI8QTile * i8_ld<HD>()];
  __shared__ __align__(16) int8_t k8s[kKeyTile * i8_ld<HD>()];
  __shared__ __align__(16) int8_t v8t[HV * kVtLd];
  const int wa = heads * HD;
  const int b = blockIdx.z, h = blockIdx.y / (HD / HV);
  const int c0 = (blockIdx.y % (HD / HV)) * HV;   // this block's o columns
  const int q0 = blockIdx.x * kI8QTile;
  const int nqb = (seq + qb - 1) / qb;
  const float* am = amax + (static_cast<size_t>(b) * heads + h) * (nqb + 2);
  const float aq = am[q0 / qb], ak = am[nqb], av = am[nqb + 1];
  const float fac = __fmul_rn(__fdiv_rn(__fmul_rn(aq, ak), 16129.0f), scale);
  const float inv_k = __fdiv_rn(127.0f, ak), inv_v = __fdiv_rn(127.0f, av);
  const float cv = __fdiv_rn(av, 16129.0f);
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * HD;

  quant_rows_i8<HD, false>(q8s, base, row3, q0, kI8QTile, seq,
                           __fdiv_rn(127.0f, aq));
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  // A fragments of the warp's rows: rows g, g + 8 x k 4t.. and 16 + 4t..
  unsigned qa[HD / 32][4];
#pragma unroll
  for (int kc = 0; kc < HD / 32; ++kc) {
    const int8_t* qr = q8s + (r0 + g) * i8_ld<HD>() + kc * 32 + 4 * t;
    qa[kc][0] = lds32(qr);
    qa[kc][1] = lds32(qr + 8 * i8_ld<HD>());
    qa[kc][2] = lds32(qr + 16);
    qa[kc][3] = lds32(qr + 8 * i8_ld<HD>() + 16);
  }
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float s[kKeyTile / 8][4];

  // ---- pass 1: row max and row sum
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();                    // the last tile's reads are done
    quant_rows_i8<HD, false>(k8s, base + wa, row3, kt * kKeyTile, kKeyTile,
                             seq, inv_k);
    __syncthreads();
    scores_i8<HD>(s, qa, k8s, kt * kKeyTile, seq, fac, lane);
    online_stats(s, mx, sum);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  float inv_ap[2], o_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ap = __fadd_rn(__fdiv_rn(1.0f, sum[r]), 1e-20f);
    inv_ap[r] = __fdiv_rn(127.0f, ap);
    o_scale[r] = __fmul_rn(ap, cv);
  }

  // ---- pass 2: p8 = round(p * 127 / ap), o += p8 . v8 (int32)
  int acc[HV / 8][4];
#pragma unroll
  for (int dt = 0; dt < HV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    quant_rows_i8<HD, false>(k8s, base + wa, row3, kt * kKeyTile, kKeyTile,
                             seq, inv_k);
    quant_rows_i8<HV, true>(v8t, base + 2 * wa + c0, row3, kt * kKeyTile,
                            kKeyTile, seq, inv_v);
    __syncthreads();
    scores_i8<HD>(s, qa, k8s, kt * kKeyTile, seq, fac, lane);
    int p8[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fdiv_rn(expf(s[j][e] - mx[r]), sum[r]);
        p8[j][e] = static_cast<int>(rintf(__fmul_rn(p, inv_ap[r])));
      }
    // 32 keys a product: score tiles 4kc .. 4kc + 3
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 32; ++kc) {
      const int j = 4 * kc;
      const unsigned a[4] = {
          pack_s8x4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]),
          pack_s8x4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]),
          pack_s8x4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]),
          pack_s8x4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3])};
#pragma unroll
      for (int dt = 0; dt < HV / 8; ++dt) {
        const int8_t* vr = v8t + (dt * 8 + g) * kVtLd + kc * 32 + 4 * t;
        const unsigned bv[2] = {lds32(vr), lds32(vr + 16)};
        mma_s8(acc[dt], a, bv);
      }
    }
  }

  // ---- rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3), bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(b) * seq + qi) * wa + h * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HV / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(
              __fmul_rn(static_cast<float>(acc[dt][2 * r]), o_scale[r]),
              __fmul_rn(static_cast<float>(acc[dt][2 * r + 1]), o_scale[r]));
  }
}

// 9b at heads of 384 to 1280 (the multiples of 128 past 256 that JAX's lane
// rule admits at W <= 1280): a tile's q codes would be 96 to 320 fragment
// registers a thread and, with a key tile's codes, more than static shared
// memory holds, so both sit in dynamic shared memory (64 rows of hd + 16
// bytes each: 162 KB at 1280 with the V codes) and the scores read their A
// and B fragments from it, 32 dims at a time; the int32 sums over those
// depth chunks are the full-depth sums. o in 128-column slices (grid y:
// head x slice), each block computing the full-depth scores.
constexpr int kI8WideSlice = 128;

// rows r0 .. r0 + n - 1 (zero past seq) of one head's hd columns at `src`
// (rows `sld` apart) as int8 codes clip(round(x * inv), +-127), row-major
// into `dst` (rows `ld` bytes apart); all threads
__device__ __forceinline__ void quant_rows_i8_wide(int8_t* dst, int ld,
                                                   const __nv_bfloat16* src,
                                                   size_t sld, int r0, int n,
                                                   int seq, float inv,
                                                   int hd) {
  const int chunks = hd / 8;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    float f[8];
    if (r0 + r < seq) {
      load8(src + static_cast<size_t>(r0 + r) * sld + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
    __align__(8) int8_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = quant_i8(f[j], inv);
    *reinterpret_cast<uint2*>(dst + r * ld + c) =
        *reinterpret_cast<uint2*>(v);
  }
}

// scores_i8 over hd dims with both operands' fragments read from shared
// memory: the warp's rows r0 + g (e = 0, 1) and + 8 (e = 2, 3) of `q8`
// against keys k0 + 8j + 2t + (e & 1) of `k8` (rows `ld` bytes apart)
__device__ __forceinline__ void scores_i8_wide(float (&s)[kKeyTile / 8][4],
                                               const int8_t* q8,
                                               const int8_t* k8, int ld,
                                               int hd, int r0, int k0,
                                               int seq, float fac,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  int acc[kKeyTile / 8][4];
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int kc = 0; kc < hd / 32; ++kc) {
    const int8_t* qr = q8 + (r0 + g) * ld + kc * 32 + 4 * t;
    const unsigned qa[4] = {lds32(qr), lds32(qr + 8 * ld), lds32(qr + 16),
                            lds32(qr + 8 * ld + 16)};
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const int8_t* kr = k8 + (j * 8 + g) * ld + kc * 32 + 4 * t;
      const unsigned b[2] = {lds32(kr), lds32(kr + 16)};
      mma_s8(acc[j], qa, b);
    }
  }
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < seq ? __fmul_rn(static_cast<float>(acc[j][e]), fac)
                          : neg_inf;
    }
}

// dynamic shared bytes of the wide kernel at head_dim hd: the q and k
// codes (64 rows of hd + 16 bytes each) and the transposed V codes
__host__ __device__ constexpr int i8_wide_smem(int hd) {
  return 2 * kI8QTile * (hd + 16) + kI8WideSlice * kVtLd;
}

__global__ void __launch_bounds__(kI8Warps * 32)
    attention_i8_wide_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const float* __restrict__ amax,
                             __nv_bfloat16* __restrict__ out, int seq,
                             int heads, int hd, int qb, float scale) {
  extern __shared__ __align__(16) int8_t smem_i8[];
  constexpr int HV = kI8WideSlice;
  const int ld = hd + 16, n_sl = hd / HV;
  int8_t* q8s = smem_i8;
  int8_t* k8s = q8s + kI8QTile * ld;
  int8_t* v8t = k8s + kKeyTile * ld;
  const int wa = heads * hd;
  const int b = blockIdx.z, h = blockIdx.y / n_sl;
  const int c0 = (blockIdx.y % n_sl) * HV;   // this block's o columns
  const int q0 = blockIdx.x * kI8QTile;
  const int nqb = (seq + qb - 1) / qb;
  const float* am = amax + (static_cast<size_t>(b) * heads + h) * (nqb + 2);
  const float aq = am[q0 / qb], ak = am[nqb], av = am[nqb + 1];
  const float fac = __fmul_rn(__fdiv_rn(__fmul_rn(aq, ak), 16129.0f), scale);
  const float inv_k = __fdiv_rn(127.0f, ak), inv_v = __fdiv_rn(127.0f, av);
  const float cv = __fdiv_rn(av, 16129.0f);
  const size_t row3 = static_cast<size_t>(3) * wa;
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(b) * seq * row3 + h * hd;

  quant_rows_i8_wide(q8s, ld, base, row3, q0, kI8QTile, seq,
                     __fdiv_rn(127.0f, aq), hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int ntiles = (seq + kKeyTile - 1) / kKeyTile;
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf}, sum[2] = {0.0f, 0.0f};
  float s[kKeyTile / 8][4];

  // ---- pass 1: row max and row sum
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();                    // the last tile's reads are done
    quant_rows_i8_wide(k8s, ld, base + wa, row3, kt * kKeyTile, kKeyTile,
                       seq, inv_k, hd);
    __syncthreads();
    scores_i8_wide(s, q8s, k8s, ld, hd, r0, kt * kKeyTile, seq, fac, lane);
    online_stats(s, mx, sum);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  float inv_ap[2], o_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ap = __fadd_rn(__fdiv_rn(1.0f, sum[r]), 1e-20f);
    inv_ap[r] = __fdiv_rn(127.0f, ap);
    o_scale[r] = __fmul_rn(ap, cv);
  }

  // ---- pass 2: p8 = round(p * 127 / ap), o += p8 . v8 (int32)
  int acc[HV / 8][4];
#pragma unroll
  for (int dt = 0; dt < HV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    quant_rows_i8_wide(k8s, ld, base + wa, row3, kt * kKeyTile, kKeyTile,
                       seq, inv_k, hd);
    quant_rows_i8<HV, true>(v8t, base + 2 * wa + c0, row3, kt * kKeyTile,
                            kKeyTile, seq, inv_v);
    __syncthreads();
    scores_i8_wide(s, q8s, k8s, ld, hd, r0, kt * kKeyTile, seq, fac, lane);
    int p8[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __fdiv_rn(expf(s[j][e] - mx[r]), sum[r]);
        p8[j][e] = static_cast<int>(rintf(__fmul_rn(p, inv_ap[r])));
      }
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 32; ++kc) {
      const int j = 4 * kc;
      const unsigned a[4] = {
          pack_s8x4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]),
          pack_s8x4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]),
          pack_s8x4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]),
          pack_s8x4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3])};
#pragma unroll
      for (int dt = 0; dt < HV / 8; ++dt) {
        const int8_t* vr = v8t + (dt * 8 + g) * kVtLd + kc * 32 + 4 * t;
        const unsigned bv[2] = {lds32(vr), lds32(vr + 16)};
        mma_s8(acc[dt], a, bv);
      }
    }
  }

  // ---- rows q0 + r0 + g (e = 0, 1) and + 8 (e = 2, 3), bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= seq) continue;
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(b) * seq + qi) * wa + h * hd + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HV / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(
              __fmul_rn(static_cast<float>(acc[dt][2 * r]), o_scale[r]),
              __fmul_rn(static_cast<float>(acc[dt][2 * r + 1]), o_scale[r]));
  }
}

// the pre-pass: the amax table, and where q8 is not null the codes
int launch_prepass(const void* qkv, void* amax, void* q8, void* k8,
                   void* v8t, int batch, int seq, int heads, int hd, int qb,
                   cudaStream_t s) {
  const int nqb = (seq + qb - 1) / qb;
  attention_i8_prepass<false>
      <<<dim3(heads, batch, nqb + 2), kPreThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(qkv), static_cast<float*>(amax),
          static_cast<int8_t*>(q8), static_cast<int8_t*>(k8),
          static_cast<int8_t*>(v8t), seq, heads, hd, qb, float3{});
  return static_cast<int>(cudaGetLastError());
}

int launch_attention_i8_wide(const void* qkv, void* amax, void* out,
                             int batch, int seq, int heads, int hd, int qb,
                             float scale, cudaStream_t s) {
  const int smem = i8_wide_smem(hd);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_i8_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      i8_wide_smem(1280));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (static_cast<long long>(heads) * (hd / kI8WideSlice) > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(launch_prepass(
      qkv, amax, nullptr, nullptr, nullptr, batch, seq, heads, hd, qb, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kI8QTile - 1) / kI8QTile,
                  heads * (hd / kI8WideSlice), batch);
  attention_i8_wide_kernel<<<grid, kI8Warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(amax), static_cast<__nv_bfloat16*>(out), seq,
      heads, hd, qb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_attention_i8(const void* qkv, void* amax, void* out, int batch,
                        int seq, int heads, int qb, float scale,
                        cudaStream_t s) {
  cudaError_t err = static_cast<cudaError_t>(launch_prepass(
      qkv, amax, nullptr, nullptr, nullptr, batch, seq, heads, HD, qb, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int HV = HD > 128 ? 128 : HD;
  if (static_cast<long long>(heads) * (HD / HV) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((seq + kI8QTile - 1) / kI8QTile, heads * (HD / HV), batch);
  attention_i8_kernel<HD, HV><<<grid, kI8Warps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(amax), static_cast<__nv_bfloat16*>(out), seq,
      heads, qb, scale);
  return static_cast<int>(cudaGetLastError());
}

// whether 9b's wgmma pass takes (batch, seq, heads) with query blocks of
// qb rows (= seq, or a multiple of its 128-row items) at head_dim 64 or
// 128: its TMA row coordinates (batch * heads * S_pad rows) are ints
inline bool i8dyn_sm90_ok(int batch, int seq, int heads, int head_dim,
                          int qb) {
  return attention_seq_ok(batch, seq) && qb > 0 &&
         (qb >= seq || qb % kI8Rows == 0) &&
         (head_dim == 64 || head_dim == 128) && heads > 0 &&
         static_cast<long long>(batch) * heads * i8_pad(seq) <=
             2147483647ll;
}

// whether kernel 17 takes (batch, seq, heads) at head_dim 128: S <=
// kMaxSeq and B S rows as ints, the pre-pass's grid (batch in y), and its
// main pass's items (S_pad / 128 a head) as ints. Its tensor maps keep
// one head a depth index, so no row coordinate passes S_pad or B H.
inline bool i8st_sm90_ok(int batch, int seq, int heads, int head_dim) {
  return attention_seq_ok(batch, seq) && batch <= 65535 && heads > 0 &&
         head_dim == 128 &&
         static_cast<long long>(batch) * heads * (i8_pad(seq) / kI8Rows) <=
             2147483647ll;
}

}  // namespace tpudf

// 9b's pre-pass: qkv (B, S, 3 * heads * head_dim) bf16 -> amax (B, heads,
// ceil(S / qb) + 2) f32, and where q8 is not null (head_dim 64 or 128)
// the codes: q8 and k8 (B, heads, S_pad, head_dim) int8, v8t (B, heads,
// head_dim, S_pad) int8, S_pad = S rounded up to 128, zeros past S
TPUDF_API int tpudf_attention_i8_prepass(const void* qkv, void* amax,
                                         void* q8, void* k8, void* v8t,
                                         int batch, int seq, int heads,
                                         int head_dim, int qb, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (heads <= 0 || head_dim <= 0 || head_dim % 8 != 0 || batch > 65535 ||
      (q8 != nullptr && !i8dyn_sm90_ok(batch, seq, heads, head_dim, qb)) ||
      (q8 == nullptr &&
       (!attention_seq_ok(batch, seq) || qb <= 0 ||
        (qb < seq && qb % kI8QTile != 0))))
    return cudaErrorInvalidValue;
  return launch_prepass(qkv, amax, q8, k8, v8t, batch, seq, heads, head_dim,
                        qb, static_cast<cudaStream_t>(stream));
}

// 9b's main pass at head_dim 64 and 128: the pre-pass's codes and amax
// table -> out (B, S, heads * head_dim) bf16
TPUDF_API int tpudf_attention_i8dyn_sm90(const void* q8, const void* k8,
                                         const void* v8t, const void* amax,
                                         void* out, int batch, int seq,
                                         int heads, int head_dim, int qb,
                                         float scale, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!i8dyn_sm90_ok(batch, seq, heads, head_dim, qb))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return i8dyn::launch<64, false>(q8, k8, v8t, amax, out, batch, seq, heads,
                                    qb, scale, 0.0f, 0.0f, s);
  return i8dyn::launch<128, false>(q8, k8, v8t, amax, out, batch, seq, heads,
                                   qb, scale, 0.0f, 0.0f, s);
}

// 9b at heads of 256 and the wide ones (384 .. 1280, the multiples of 128):
// qkv (B, S, 3 * heads * head_dim) bf16 -> out (B, S, heads * head_dim)
// bf16, the pre-pass (amax only) then the mma.sync kernel; amax: (B,
// heads, ceil(S / qb) + 2) f32 scratch; qb = min(256, S), so that the
// 64-row query tiles never straddle a block; S <= kMaxSeq
TPUDF_API int tpudf_attention_i8dyn(const void* qkv, void* amax, void* out,
                                    int batch, int seq, int heads,
                                    int head_dim, int qb, float scale,
                                    void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!attention_seq_ok(batch, seq) || qb <= 0 || batch > 65535 ||
      (qb < seq && qb % kI8QTile != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 256)
    return launch_attention_i8<256>(qkv, amax, out, batch, seq, heads, qb,
                                    scale, s);
  if (head_dim >= 384 && head_dim <= 1280 && head_dim % 128 == 0)
    return launch_attention_i8_wide(qkv, amax, out, batch, seq, heads,
                                    head_dim, qb, scale, s);
  return cudaErrorInvalidValue;
}

// 17's pre-pass: qkv (B, S, 3 * heads * 128) bf16 -> the codes of k and v
// at the static inv_k = 127 / ak and inv_v = 127 / av (each rounded once
// to f32 by the caller): k8 (B, heads, S_pad, 128) int8, v8t (B, heads,
// 128, S_pad) int8 in vt_pos order, S_pad = S rounded up to 128, zeros
// past S
TPUDF_API int tpudf_attention_i8_static_prepass(const void* qkv, void* k8,
                                                void* v8t, int batch,
                                                int seq, int heads,
                                                int head_dim, float inv_k,
                                                float inv_v, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!i8st_sm90_ok(batch, seq, heads, head_dim))
    return cudaErrorInvalidValue;
  attention_i8_prepass<true>
      <<<dim3(heads, batch, 2 * i8_pad(seq) / kVtKeys), kPreThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(qkv), nullptr, nullptr,
          static_cast<int8_t*>(k8), static_cast<int8_t*>(v8t), seq, heads,
          head_dim, seq, make_float3(0.0f, inv_k, inv_v));
  return static_cast<int>(cudaGetLastError());
}

// 17's main pass: qkv (its q, quantised at inv_q = 127 / aq in the block)
// and the pre-pass's codes -> out (B, S, heads * 128) bf16, with fac = (aq
// * ak) / 127^2 * scale and cv = av / 127^2 (each rounded once to f32 by
// the caller). The probe pads queries to its 256-row blocks; no row
// depends on another's block here, so nothing is padded.
TPUDF_API int tpudf_attention_i8_static(const void* qkv, const void* k8,
                                        const void* v8t, void* out,
                                        int batch, int seq, int heads,
                                        int head_dim, float inv_q, float fac,
                                        float cv, void* stream) {
  using namespace tpudf;
  if (batch <= 0 || seq <= 0) return 0;
  if (!i8st_sm90_ok(batch, seq, heads, head_dim))
    return cudaErrorInvalidValue;
  return i8dyn::launch<128, true>(qkv, k8, v8t, nullptr, out, batch, seq,
                                  heads, seq, fac, inv_q, cv,
                                  static_cast<cudaStream_t>(stream));
}
