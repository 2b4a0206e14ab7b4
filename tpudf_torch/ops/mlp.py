"""The MLP sublayer: static W8A8 (kernel K2) and bf16 (kernel K14).

K2:

x → LN → static int8 quant → int8 fc1 → dequant + bias → GELU-tanh → int8
quant → int8 fc2 → dequant + bias → + residual, and optionally Σ out² per
row of the bf16 output (the row norms the following ToMe merge reads).

Replaces tpudf/ops/mlp.py `_kernel_int8` and `_kernel_int8_ss` (wrapper
`mlp_block_fused_int8`). The CUDA kernels are the LN + quant pass and the
int8 GEMM of `csrc/int8_gemm_sm90.cu`, three launches: LN + quant, fc1 with a
GELU + quant epilogue that writes the int8 hidden, fc2 with a residual
(+ Σ out², f32 atomics across the column tiles of a row) epilogue. The TPU
kernel kept the (rows, 4W) hidden in VMEM; here it passes through device
memory as int8 (M·4W bytes each way), and keeping it on-chip is later work.
On the card both GEMMs are bound by tensor-core operations (wgmma s8).

The plain twin is `_reference_int8`, the JAX package's reference form.

K14 (`mlp_block_fused`), x + fc2(gelu(fc1(LN(x)))) on bf16 weights:
replaces tpudf/ops/mlp.py `_kernel` (wrapper `mlp_block_fused`), the float
tower's MLP. Same arithmetic: LN with f32 statistics cast to bf16, fc1 with
an f32 accumulator + b1, tanh GELU, rounded to bf16; fc2 with an f32
accumulator + b2; x32 + h2 cast to bf16. Three launches: the K4 row pass,
the bf16 GEMM of `csrc/bf16_gemm_sm90.cu` (wgmma + TMA) with a bias +
GELU epilogue writing the (rows, 4W) bf16 hidden, and the same GEMM with a
bias + residual epilogue. The TPU kernel kept the LN output and the hidden
in VMEM; here they pass through device memory (M·4W·2 bytes each way for
the hidden), and keeping them on-chip is later work. Both GEMMs are bound by
tensor-core operations at the float tower's shapes. The plain twin
`mlp_block_reference` repeats the kernel's arithmetic (at f32 it is the
JAX package's `_reference`; in bf16 that reference rounds each product to
bf16, the Pallas kernel and this one do not). K14's backward recomputes the
twin and applies its VJP (`twin_vjp`), as the JAX VJP does with
`_reference`.
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops.int8_block import (GEMM_GELU_I8, GEMM_RESIDUAL,
                                        check_i8_gemm, i8_gemm_cuda)
from tpudf_torch.ops.layernorm import (layer_norm_reference, ln_bf16_cuda,
                                       ln_quant_cuda, ln_rows_f32)
from tpudf_torch.ops.linear import (GEMM_GELU, bf16_gemm_cuda,
                                    check_bf16_gemm,
                                    GEMM_RESIDUAL as BF16_RESIDUAL)
from tpudf_torch.ops.quant import int8_mm, quant_rows, transposed
from tpudf_torch.ops.twin_vjp import with_twin_vjp
from tpudf_torch.utils.nn import gelu_tanh

KERNEL = "mlp_block_fused_int8"
KERNEL_SUMSQ = "mlp_block_fused_int8_ss"
KERNEL_BF16 = "mlp_block_fused"


def _reference_int8(x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                    a1, a2, eps):
    a1, a2 = a1.float(), a2.float()
    x32 = x2d.float()
    q1 = quant_rows(ln_rows_f32(x2d, ln_scale, ln_bias, eps), a1)
    h = int8_mm(q1, w1q).float() * ((a1 / 127.0) * w1s.float()) + b1.float()
    q2 = quant_rows(gelu_tanh(h), a2)
    o = int8_mm(q2, w2q).float() * ((a2 / 127.0) * w2s.float()) + b2.float()
    return (x32 + o).to(x2d.dtype)


def mlp_block_int8_reference(x, ln_params, mlp_q, act_scales, eps=1e-6, *,
                             emit_sumsq=False):
    """Plain PyTorch twin of K2 on any device."""
    w = x.shape[-1]
    out = _reference_int8(
        x.reshape(-1, w), ln_params["scale"], ln_params["bias"],
        mlp_q["fc1_w"]["q"], mlp_q["fc1_w"]["scale"], mlp_q["fc1_b"],
        mlp_q["fc2_w"]["q"], mlp_q["fc2_w"]["scale"], mlp_q["fc2_b"],
        act_scales["fc1"], act_scales["fc2"], eps).reshape(x.shape)
    if emit_sumsq:
        o32 = out.float()
        return out, torch.sum(o32 * o32, dim=-1)
    return out


def check_mlp_block_fused_int8(x, mlp_q):
    """Raise unless K2 takes this MLP: bf16 x, and its fc1 and fc2 shapes
    for the int8 GEMM (`check_i8_gemm`)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K2 takes bf16 x, got {x.dtype}")
    w1 = transposed(mlp_q["fc1_w"])
    check_i8_gemm(x.shape[-1], w1)
    check_i8_gemm(w1.shape[0], transposed(mlp_q["fc2_w"]))


def _mlp_cuda(x, ln_params, mlp_q, act_scales, eps, emit_sumsq):
    w = x.shape[-1]
    check_mlp_block_fused_int8(x, mlp_q)
    x2d = x.reshape(-1, w).contiguous()
    a1, a2 = act_scales["fc1"], act_scales["fc2"]
    h8 = ln_quant_cuda(x2d, ln_params, a1, eps)
    hid = i8_gemm_cuda(h8, transposed(mlp_q["fc1_w"]),
                       mlp_q["fc1_w"]["scale"], mlp_q["fc1_b"], a1,
                       GEMM_GELU_I8, act_out=a2)
    ss = (torch.zeros(x2d.shape[0], dtype=torch.float32, device=x.device)
          if emit_sumsq else None)
    out = i8_gemm_cuda(hid, transposed(mlp_q["fc2_w"]),
                       mlp_q["fc2_w"]["scale"], mlp_q["fc2_b"], a2,
                       GEMM_RESIDUAL, residual=x2d, sumsq=ss)
    LAUNCHES.hit(KERNEL)
    if emit_sumsq:
        LAUNCHES.hit(KERNEL_SUMSQ)
        return out.reshape(x.shape), ss.reshape(x.shape[:-1])
    return out.reshape(x.shape)


def mlp_block_fused_int8(x, ln_params, mlp_q, act_scales, eps=1e-6, *,
                         emit_sumsq=False):
    """W8A8 MLP sublayer: (B, S, W) → (B, S, W) [, (B, S) Σ out²].

    mlp_q: per-layer {fc1_w: {q, scale[, qT]}, fc1_b, fc2_w, fc2_b};
    act_scales: {"fc1": 0-d, "fc2": 0-d} f32. CPU tensors take the plain
    twin; CUDA tensors launch K2 or raise."""
    if not x.is_cuda:
        return mlp_block_int8_reference(x, ln_params, mlp_q, act_scales, eps,
                                        emit_sumsq=emit_sumsq)
    return _mlp_cuda(x, ln_params, mlp_q, act_scales, eps, emit_sumsq)


def mlp_block_reference(x, ln_params, mlp_params, eps=1e-6):
    """Plain PyTorch twin of K14 on any device."""
    w = x.shape[-1]
    x2d = x.reshape(-1, w)
    h = layer_norm_reference(x2d, ln_params["scale"], ln_params["bias"], eps)
    h1 = gelu_tanh(torch.matmul(h.float(), mlp_params["fc1_w"].float())
                   + mlp_params["fc1_b"].float()).to(x.dtype)
    h2 = (torch.matmul(h1.float(), mlp_params["fc2_w"].float())
          + mlp_params["fc2_b"].float())
    return (x2d.float() + h2).to(x.dtype).reshape(x.shape)


def check_mlp_block_fused(x, mlp_params):
    """Raise unless K14 takes this MLP: both bf16 GEMMs' shapes
    (`check_bf16_gemm`: the hidden a 128 multiple, the width a 32 and a
    128 multiple)."""
    m, w = x.reshape(-1, x.shape[-1]).shape
    w1, w2 = mlp_params["fc1_w"], mlp_params["fc2_w"]
    check_bf16_gemm(x.dtype, m, w, w1)
    check_bf16_gemm(w1.dtype, m, w1.shape[-1], w2)


def _mlp_bf16_cuda(x, ln_params, mlp_params, eps):
    check_mlp_block_fused(x, mlp_params)
    w = x.shape[-1]
    x2d = x.reshape(-1, w).contiguous()
    h = ln_bf16_cuda(x2d, ln_params["scale"], ln_params["bias"], eps)
    h1 = bf16_gemm_cuda(h, mlp_params["fc1_w"], mlp_params["fc1_b"],
                        GEMM_GELU)
    out = bf16_gemm_cuda(h1, mlp_params["fc2_w"], mlp_params["fc2_b"],
                         BF16_RESIDUAL, x2d)
    LAUNCHES.hit(KERNEL_BF16)
    return out.reshape(x.shape)


def _unflat(ln_scale, ln_bias, w1, b1, w2, b2):
    return ({"scale": ln_scale, "bias": ln_bias},
            {"fc1_w": w1, "fc1_b": b1, "fc2_w": w2, "fc2_b": b2})


def _mlp_twin(x, *leaves, eps):
    return mlp_block_reference(x, *_unflat(*leaves), eps)


def _mlp_bf16(x, *leaves, eps):
    if not x.is_cuda:
        return _mlp_twin(x, *leaves, eps=eps)
    return _mlp_bf16_cuda(x, *_unflat(*leaves), eps)


def mlp_block_fused(x, ln_params, mlp_params, eps=1e-6):
    """bf16 MLP sublayer with fused LN: (B, S, W) → (B, S, W).

    mlp_params: per-layer {fc1_w (W, 4W), fc1_b, fc2_w (4W, W), fc2_b}, the
    weights in the compute dtype. CPU tensors take the plain twin; CUDA
    tensors launch K14 or raise. Differentiable through the twin's VJP."""
    return with_twin_vjp(_mlp_bf16, _mlp_twin, x, ln_params["scale"],
                         ln_params["bias"], mlp_params["fc1_w"],
                         mlp_params["fc1_b"], mlp_params["fc2_w"],
                         mlp_params["fc2_b"], eps=eps)
