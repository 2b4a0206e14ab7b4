// The int8 epilogue modes every int8 product shares, and the int8
// mma.sync wrapper of 9b's wide heads and probe 17 (attention_i8.cu,
// attn_tile.cuh). The W8A8 block's products, K5, K6, K7 and the quantising
// probe GEMMs run on int8 wgmma and TMA (int8_gemm_sm90.cu, i8_sm90.cuh).
//
// Epilogues, per output element, with f = acc * ((act / 127) * col_scale[n])
// + bias[n] rounded op by op as the JAX kernels do:
//   kEpiBf16         out = bf16(f)                     (QKV; probe 16's
//                    k_nogelu)
//   kEpiGeluI8       out = int8 quant(gelu_tanh(f), act_out)      (fc1)
//   kEpiResidual     out = bf16(residual + f), and, when sumsq is not
//                    null, sumsq[m] += out^2 (f32 atomics across column
//                    tiles; the order of the adds varies from run to run)
//   kEpiI32          out = acc (int32; the caller dequantises)
//   kEpiResF32Out    out = f32((residual + acc * cs) + bias[n]), residual
//                    bf16: K7's attention sublayer, whose residual stays
//                    f32 into LN2 (the order of _layer_kernel's adds)
//   kEpiF32Residual  out = bf16(residual + f), residual f32 (K7's fc2)
// and the probes' own, in their TPU kernels' op order (c = act / 127):
//   kEpiProbeStatic  out = bf16((acc * c) * col_scale[n]), no bias
//                    (probe 15's int8_kernel)
//   kEpiProbeGelu    out = bf16(gelu_tanh(acc * (c * col_scale[n]) +
//                    bias[n]))                  (probe 16's k_full)
//   kEpiProbeBf16    out = bf16(bf16(bf16(acc) * bf16(col_scale[n])) +
//                    bf16(bias[n])), no c      (probe 16's k_bf16_epi)
#pragma once

#include "common.cuh"

namespace tpudf {

constexpr int kBK = 64;            // K a multiple of it

enum : int {
  kEpiBf16 = 0,
  kEpiGeluI8 = 1,
  kEpiResidual = 2,
  kEpiI32 = 3,
  kEpiResF32Out = 4,
  kEpiF32Residual = 5,
  kEpiProbeStatic = 6,
  kEpiProbeGelu = 7,
  kEpiProbeBf16 = 8,
};

// D = A (16x32, row) * B (32x8, col) + D, s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

}  // namespace tpudf
