"""Row layer norm with f32 E[x²]−E[x]² statistics — kernel K4.

Replaces tpudf/ops/layernorm.py `_ln_kernel` (via `_ln_pallas` /
`layer_norm_fused`). The CUDA kernel is `csrc/layernorm.cu`: one warp per
row, the row held in registers, one bf16 read and one bf16 write. It is
bound by device-memory bytes (4 bytes moved per element, a handful of flops);
its design reads each row exactly once. The backward recomputes the twin
and applies its VJP (`twin_vjp`), as the JAX VJP does.
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.twin_vjp import with_twin_vjp

KERNEL = "layer_norm_fused"
MAX_WIDTH = 1024


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
    w = x2d.shape[-1]
    if x2d.dtype != torch.bfloat16 or w % 8 or w > MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes bf16 rows of width "
                         f"8k <= {MAX_WIDTH}, got {x2d.dtype} width {w}")
    out = torch.empty_like(x2d)
    _build.call("tpudf_layer_norm_bf16", x2d, scale.float().contiguous(),
                bias.float().contiguous(), out, x2d.shape[0], w, float(eps))
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
