"""Row layer norm with f32 E[x²]−E[x]² statistics — kernels K4 and K8.

K4 replaces tpudf/ops/layernorm.py `_ln_kernel` (via `_ln_pallas` /
`layer_norm_fused`). The CUDA kernel is `csrc/layernorm.cu`: one warp a
row at a time, the row held in registers (any multiple of 8 up to
REG_WIDTH = 1280: so400m's 1152 is 4.5 chunks of 8 a lane), one bf16 read
and one bf16 write; each warp walks rows and loads the next one while it
reduces this one. Wider rows (up to MAX_WIDTH, what a warp's share of a
block's shared memory holds) are staged in shared memory as they are
read, with the statistics summed in the same order. The scale and bias
are read in the dtype they are stored in (bf16 or f32), so no call casts
them. It is bound by
device-memory bytes (4 bytes moved per element, a handful of flops). The
backward recomputes the twin and applies its VJP (`twin_vjp`), as the JAX
VJP does.

K8 (`layer_norm_quant`) replaces tpudf/ops/layernorm.py `_ln_quant_kernel`:
the same LN emitting static int8 codes, round(y·127/a) half to even,
clipped to ±127 (one bf16 read, one int8 write). Its CUDA kernel is the LN
+ quant row pass of `csrc/layernorm.cu` that also opens K1 and K2; bound by
device-memory bytes. The twin is the JAX function's off-TPU branch.
`ln_quant_f32_cuda` runs that pass over f32 rows (any width up to
MAX_WIDTH_F32; the LN2 of K7's split form).
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.quant import f32_scalar, quant_rows
from tpudf_torch.ops.twin_vjp import with_twin_vjp

KERNEL = "layer_norm_fused"
KERNEL_QUANT = "layer_norm_quant"
REG_WIDTH = 1280        # csrc/common.cuh kLnMaxWidth: a row in registers
LN_WIDE_WARPS = 4       # csrc/layernorm.cu kLnWideWarps
_SMEM = 232448          # a block's shared memory (csrc/common.cuh)


def max_width(elem):
    """The widest row of `elem`-byte values the row pass takes: one row a
    warp in kLnWideWarps warps' share of a block's shared memory
    (csrc/layernorm.cu `tpudf_ln_max_width`)."""
    return _SMEM // (LN_WIDE_WARPS * elem) // 8 * 8


MAX_WIDTH = max_width(2)        # bf16 rows: 29,056
MAX_WIDTH_F32 = max_width(4)    # f32 rows: 14,528


def ln_rows_f32(x2d, g, b, eps):
    """f32 LN of rows, without the cast back (what the int8 quant reads)."""
    x32 = x2d.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.clamp(torch.mean(x32 * x32, -1, keepdim=True) - mu * mu,
                      min=0.0)
    return (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _params(t):
    """The kernels' scale or bias: as stored where that is bf16 or f32
    (read in that dtype), else cast to f32; and whether it is bf16."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        t = t.float()
    return t.contiguous(), int(t.dtype == torch.bfloat16)


def _pair(scale, bias):
    """scale and bias in one dtype for a launch (bf16 only if both are)."""
    (g, gb), (b, bb) = _params(scale), _params(bias)
    if gb != bb:
        g, b, gb = g.float(), b.float(), 0
    return g, b, gb


def _check_rows(x2d, name, dtype=torch.bfloat16):
    w = x2d.shape[-1]
    limit = MAX_WIDTH if dtype == torch.bfloat16 else MAX_WIDTH_F32
    if x2d.dtype != dtype or w % 8 or not 0 < w <= limit:
        raise ValueError(f"{name} takes {dtype} rows of width 8k <= "
                         f"{limit}, got {x2d.dtype} width {w}")


def layer_norm_reference(x, scale, bias, eps=1e-6):
    """Plain PyTorch twin of the kernel: f32 statistics, output in x's
    dtype."""
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.clamp(torch.mean(x32 * x32, -1, keepdim=True) - mu * mu,
                      min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def ln_bf16_cuda(x2d, scale, bias, eps):
    """One launch of the kernel on (rows, W) bf16, uncounted: the LN pass
    that opens kernels K13 and K14 counts as part of them."""
    _check_rows(x2d, "the layer_norm kernel")
    w = x2d.shape[-1]
    out = torch.empty_like(x2d)
    g, b, is_bf16 = _pair(scale, bias)
    _build.call("tpudf_layer_norm_bf16", x2d, g, b, out, x2d.shape[0], w,
                is_bf16, float(eps))
    return out


def _layer_norm_cuda(x, scale, bias, eps):
    w = x.shape[-1]
    out = ln_bf16_cuda(x.reshape(-1, w).contiguous(), scale, bias, eps)
    LAUNCHES.hit(KERNEL)
    return out.reshape(x.shape)


def _layer_norm(x, scale, bias, *, eps):
    if not x.is_cuda:
        return layer_norm_reference(x, scale, bias, eps)
    return _layer_norm_cuda(x, scale, bias, eps)


def layer_norm_fused(x, scale, bias, eps=1e-6):
    """(..., W) fused LN. CPU tensors take the plain twin; CUDA tensors
    launch the kernel (bf16 only) or raise. Differentiable through the
    twin's VJP."""
    return with_twin_vjp(_layer_norm, layer_norm_reference, x, scale, bias,
                         eps=eps)


def ln_quant_cuda(x2d, ln_params, a, eps):
    """LN + static int8 quant of bf16 rows → int8 rows (one launch,
    uncounted: the row pass that opens K1 and K2, and K8 itself)."""
    _check_rows(x2d, "the LN + quant row pass")
    m, w = x2d.shape
    out = torch.empty((m, w), dtype=torch.int8, device=x2d.device)
    g, b, is_bf16 = _pair(ln_params["scale"], ln_params["bias"])
    _build.call("tpudf_ln_quant_i8", x2d, g, b, f32_scalar(a, x2d.device),
                out, m, w, is_bf16, float(eps))
    return out


def ln_quant_f32_cuda(x2d, ln_params, a, eps):
    """LN + static int8 quant of f32 rows → int8 rows, one launch of the
    row pass on f32 (uncounted: the LN2 of K7's split form)."""
    _check_rows(x2d, "the f32 LN + quant row pass", torch.float32)
    m, w = x2d.shape
    out = torch.empty((m, w), dtype=torch.int8, device=x2d.device)
    _build.call("tpudf_ln_quant_f32", x2d, ln_params["scale"].float()
                .contiguous(), ln_params["bias"].float().contiguous(),
                f32_scalar(a, x2d.device), out, m, w, float(eps))
    return out


def layer_norm_quant_reference(x, scale, bias, act_scale, eps=1e-6):
    """Plain twin of K8: (..., W) → (..., W) int8 codes."""
    return quant_rows(ln_rows_f32(x, scale, bias, eps),
                      f32_scalar(act_scale, x.device))


def layer_norm_quant(x, scale, bias, act_scale, eps=1e-6):
    """(..., W) → (..., W) int8: LN emitting static int8 codes (feeds
    `quant.int8_matmul_pre` on the X routes of the W8A8 block). CPU tensors
    take the plain twin; CUDA tensors launch K8 (bf16 only) or raise."""
    if not x.is_cuda:
        return layer_norm_quant_reference(x, scale, bias, act_scale, eps)
    w = x.shape[-1]
    out = ln_quant_cuda(x.reshape(-1, w).contiguous(),
                        {"scale": scale, "bias": bias}, act_scale, eps)
    LAUNCHES.hit(KERNEL_QUANT)
    return out.reshape(x.shape)
