"""Fused (LN →) bf16 GEMM → bias (→ GELU) (→ + residual) — kernel K13.

    y = (LN(x) if ln else x) @ W + b   [gelu]  [+ residual]

Replaces tpudf/ops/linear.py `_make_kernel` (wrapper `linear_fused`): the
float tower's LN1 + QKV and out-proj + residual. Same arithmetic: the LN
takes f32 E[x²]−E[x]² statistics and is cast to bf16 before the product;
the product is bf16 × bf16 with an f32 accumulator; bias, GELU and
residual are added in f32 and the result is cast once to bf16.

The CUDA kernel is the bf16 GEMM of `csrc/bf16_gemm_sm90.cu` (Hopper's
wgmma and TMA: a persistent block of two consumer warpgroups on 128 x 256
output tiles, a producer warpgroup streaming 64-deep K steps through a
4-stage mbarrier ring) with a bias | bias+GELU | bias+residual epilogue;
with `ln`, a launch of the K4 row pass (`csrc/layernorm.cu`) comes first
and its bf16 output goes through device memory, where the TPU kernel
kept LN(x) in VMEM (keeping it on-chip is later work). The weight
is read in the JAX package's (in, out) layout, in the compute dtype the
engine cast it to once. At the float tower's shapes the QKV product is
bound by tensor-core operations, the out-proj nearly by bytes.

The plain twin `linear_fused_reference` repeats this arithmetic on any
device; it is the JAX package's `_reference`. The backward recomputes the
twin and applies its VJP (`twin_vjp`), as the JAX VJP applies `jax.vjp`
to `_reference`.
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.layernorm import layer_norm_reference, ln_bf16_cuda
from tpudf_torch.ops.twin_vjp import with_twin_vjp
from tpudf_torch.utils.nn import gelu_tanh

KERNEL = "linear_fused"
GEMM_BIAS, GEMM_GELU, GEMM_RESIDUAL = 0, 1, 2
_MODES = {None: GEMM_BIAS, "gelu": GEMM_GELU}


def linear_fused_reference(x, w, bias, *, ln=None, residual=None,
                           activation=None, eps=1e-6):
    """Plain PyTorch twin of K13 on any device, output in x's dtype; also
    the twin of one GEMM launch (ln None; bias None: kernel 15's
    product)."""
    din, dout = w.shape
    h = x.reshape(-1, din)
    if ln is not None:
        h = layer_norm_reference(h, ln[0], ln[1], eps)
    y = torch.matmul(h.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    if activation == "gelu":
        y = gelu_tanh(y)
    if residual is not None:
        y = y + residual.reshape(-1, dout).float()
    return y.to(x.dtype).reshape(*x.shape[:-1], dout)


def check_bf16_gemm(a_dtype, m, k, w):
    """Raise unless the bf16 GEMM takes an (m, k) operand of a_dtype times
    w (K, N): both bf16, K == k, N a multiple of 128, K of 32."""
    n = w.shape[-1]
    if (a_dtype != torch.bfloat16 or w.dtype != torch.bfloat16
            or w.shape[0] != k or n % 128 or k % 32):
        raise ValueError(f"bf16 GEMM takes bf16 (M, K) @ (K, N) with N % 128 "
                         f"== 0 and K % 32 == 0, got {a_dtype} ({m}, {k}) @ "
                         f"{w.dtype} {tuple(w.shape)}")


def check_linear_fused(x, w, residual=None, activation=None):
    """Raise unless K13 takes this call: activation None or "gelu" (not
    with a residual), and the GEMM's shapes (`check_bf16_gemm`)."""
    if activation not in _MODES or (activation and residual is not None):
        raise ValueError(f"K13 takes activation None or 'gelu' without a "
                         f"residual, got {activation!r}")
    din = w.shape[0]
    check_bf16_gemm(x.dtype, x.numel() // max(din, 1), x.shape[-1], w)


def bf16_gemm_cuda(a2d, w, bias, mode, residual=None):
    """out = epilogue(a2d @ w + bias) on the card, one launch of
    `csrc/bf16_gemm_sm90.cu` (uncounted: K13 and K14 count their own).
    a2d (M, K) and w (K, N) bf16 under `check_bf16_gemm`; bias may be None
    in mode GEMM_BIAS."""
    m, k = a2d.shape
    n = w.shape[1]
    check_bf16_gemm(a2d.dtype, m, k, w)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a2d.device)
    _build.call("tpudf_bf16_gemm", a2d, w.contiguous(),
                None if bias is None else bias.float().contiguous(),
                residual, out, m, n, k, mode)
    return out


def _linear_cuda(x, w, bias, ln, residual, activation, eps):
    din, dout = w.shape
    check_linear_fused(x, w, residual, activation)
    x2d = x.reshape(-1, din).contiguous()
    if ln is not None:
        x2d = ln_bf16_cuda(x2d, ln[0], ln[1], eps)
    if residual is not None:
        out = bf16_gemm_cuda(x2d, w, bias, GEMM_RESIDUAL,
                             residual.reshape(-1, dout).contiguous())
    else:
        out = bf16_gemm_cuda(x2d, w, bias, _MODES[activation])
    LAUNCHES.hit(KERNEL)
    return out.reshape(*x.shape[:-1], dout)


def _linear_twin(x, w, bias, ln_scale, ln_bias, residual, *, activation,
                 eps):
    ln = None if ln_scale is None else (ln_scale, ln_bias)
    return linear_fused_reference(x, w, bias, ln=ln, residual=residual,
                                  activation=activation, eps=eps)


def _linear(x, w, bias, ln_scale, ln_bias, residual, *, activation, eps):
    if not x.is_cuda:
        return _linear_twin(x, w, bias, ln_scale, ln_bias, residual,
                            activation=activation, eps=eps)
    ln = None if ln_scale is None else (ln_scale, ln_bias)
    return _linear_cuda(x, w, bias, ln, residual, activation, eps)


def linear_fused(x, w, bias, *, ln=None, residual=None, activation=None,
                 eps=1e-6):
    """(..., din) → (..., dout). ln: optional (scale, bias) of a pre-LN;
    residual: optional (..., dout); activation: None or "gelu". CPU
    tensors take the plain twin; CUDA tensors launch K13 or raise.
    Differentiable through the twin's VJP."""
    ln_scale, ln_bias = ln if ln is not None else (None, None)
    return with_twin_vjp(_linear, _linear_twin, x, w, bias, ln_scale, ln_bias,
                         residual, activation=activation, eps=eps)
