"""The static-W8A8 attention sublayer — kernel K1.

x → LN (f32 E[x²]−E[x]²) → static int8 quant → int8 QKV GEMM (int32
accumulate) → dequant + bias → bf16 qkv → per-image, per-head full softmax
with an optional per-key bias log(size) → p cast to bf16 for AV → int8 quant
→ int8 out-proj → dequant + bias + residual.

Replaces tpudf/ops/int8_block.py `_attn_sublayer_kernel` (wrapper
`attn_sublayer_int8`). The CUDA kernels live in `csrc/int8_gemm.cu` and
`csrc/attention.cu` and run as four launches: LN + quant (one bf16 read,
one int8 write), the QKV GEMM, the attention, the out-proj GEMM. The TPU
kernel kept the int8 LN output, the bf16 qkv and the attention output in
VMEM; here they pass through device memory (int8, bf16, int8), and keeping
them on-chip is later work. On the card the GEMMs are bound by tensor-core
operations (mma.sync s8, int32 accumulate) and the attention at S ≤ 256 by
its f32 CUDA-core arithmetic over shared-memory K/V.

The plain twin is `_ln_qkv_reference` then `_attn_out_reference`, the JAX
package's reference forms.
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.attention import attention_qkv_reference
from tpudf_torch.ops.quant import int8_mm, quant_rows

KERNEL = "attn_sublayer_int8"


def ln_rows_f32(x2d, g, b, eps):
    """f32 LN of rows, without the cast back (what the int8 quant reads)."""
    x32 = x2d.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.clamp(torch.mean(x32 * x32, -1, keepdim=True) - mu * mu,
                      min=0.0)
    return (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _ln_qkv_reference(x2d, g, b, wq, ws, bias, a, eps):
    a = a.float()
    q = quant_rows(ln_rows_f32(x2d, g, b, eps), a)
    acc = int8_mm(q, wq)
    return (acc.float() * ((a / 127.0) * ws.float()) + bias.float()
            ).to(x2d.dtype)


def _attn_out_reference(qkv, x, wq, ws, bias, a, heads, head_dim, scale,
                        logit_bias=None):
    o = attention_qkv_reference(qkv, heads, head_dim, scale, logit_bias)
    a = a.float()
    b, s, wa = o.shape
    q8 = quant_rows(o.float(), a)
    acc = int8_mm(q8.reshape(b * s, wa), wq).reshape(b, s, -1)
    proj = acc.float() * ((a / 127.0) * ws.float()) + bias.float()
    return (x.float() + proj).to(x.dtype)


def attn_sublayer_reference(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                            a_qkv, a_out, heads, head_dim, eps=1e-6,
                            scale=None, *, logit_bias=None):
    """Plain PyTorch twin of K1 on any device."""
    b, s, w = x.shape
    scale = scale if scale is not None else head_dim ** -0.5
    qkv = _ln_qkv_reference(x.reshape(-1, w), ln_params["scale"],
                            ln_params["bias"], qkv_wq["q"], qkv_wq["scale"],
                            qkv_b, a_qkv, eps).reshape(b, s, -1)
    return _attn_out_reference(qkv, x, out_wq["q"], out_wq["scale"], out_b,
                               a_out, heads, head_dim, scale, logit_bias)


def transposed(wq):
    """(N, K) int8 layout the GEMM kernel reads; derived once by
    tpudf_torch.convert.add_kernel_layout, else here."""
    qt = wq.get("qT")
    return qt if qt is not None else wq["q"].t().contiguous()


def _f32(t):
    return t.float().contiguous()


def ln_quant_cuda(x2d, ln_params, a, eps):
    """LN + static int8 quant of bf16 rows → int8 rows (one launch)."""
    m, w = x2d.shape
    out = torch.empty((m, w), dtype=torch.int8, device=x2d.device)
    _build.call("tpudf_ln_quant_i8", x2d, _f32(ln_params["scale"]),
                _f32(ln_params["bias"]), _f32(a), out, m, w, float(eps))
    return out


GEMM_BF16, GEMM_GELU_I8, GEMM_RESIDUAL = 0, 1, 2


def i8_gemm_cuda(a8, wt, col_scale, bias, act, mode, *, residual=None,
                 sumsq=None, act_out=None):
    """out[m, n] = epilogue(Σ_k a8[m, k]·wt[n, k]) on the card.

    mode GEMM_BF16: bf16(acc·(act/127)·col_scale + bias);
    GEMM_GELU_I8: int8 quant with act_out of gelu_tanh of that;
    GEMM_RESIDUAL: bf16(residual + that), and Σ out² per row into sumsq
    (f32 atomics across column tiles) when sumsq is given."""
    m, k = a8.shape
    n = wt.shape[0]
    if wt.shape[1] != k or n % 128 or k % 64:
        raise ValueError(f"i8 GEMM needs N % 128 == 0 and K % 64 == 0, got "
                         f"M={m} N={n} K={k} (weight {tuple(wt.shape)})")
    dt = torch.int8 if mode == GEMM_GELU_I8 else torch.bfloat16
    out = torch.empty((m, n), dtype=dt, device=a8.device)
    _build.call("tpudf_i8_gemm", a8, wt, _f32(col_scale), _f32(bias),
                _f32(act), residual, out, sumsq,
                None if act_out is None else _f32(act_out), m, n, k, mode)
    return out


def _attn_sublayer_cuda(x, ln_params, qkv_wq, qkv_b, out_wq, out_b, a_qkv,
                        a_out, heads, head_dim, eps, scale, logit_bias):
    b, s, w = x.shape
    wa = heads * head_dim
    if x.dtype != torch.bfloat16 or head_dim != 64 or w % 8 or s > 256:
        raise ValueError(f"K1 takes bf16 x, head_dim 64 and S <= 256, got "
                         f"{x.dtype} head_dim {head_dim} S {s}")
    x2d = x.reshape(b * s, w).contiguous()
    h8 = ln_quant_cuda(x2d, ln_params, a_qkv, eps)
    qkv = i8_gemm_cuda(h8, transposed(qkv_wq), qkv_wq["scale"], qkv_b,
                       a_qkv, GEMM_BF16)
    o8 = torch.empty((b * s, wa), dtype=torch.int8, device=x.device)
    bias = None if logit_bias is None else _f32(logit_bias)
    _build.call("tpudf_attention_i8", qkv, bias, _f32(a_out), o8, b, s,
                heads, head_dim, float(scale))
    out = i8_gemm_cuda(o8, transposed(out_wq), out_wq["scale"], out_b, a_out,
                       GEMM_RESIDUAL, residual=x2d)
    LAUNCHES.hit(KERNEL)
    return out.reshape(b, s, w)


def attn_sublayer_int8(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                       a_qkv, a_out, heads, head_dim, eps=1e-6,
                       scale=None, *, logit_bias=None):
    """(B, S, W) → (B, S, W): the attention sublayer. CPU tensors take the
    plain twin; CUDA tensors launch K1 or raise.

    qkv_wq/out_wq: {q: (in, out) int8, scale: (out,), optional qT}; a_qkv,
    a_out: 0-d f32 activation scales; logit_bias: optional (B, S) f32."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not x.is_cuda:
        return attn_sublayer_reference(
            x, ln_params, qkv_wq, qkv_b, out_wq, out_b, a_qkv, a_out, heads,
            head_dim, eps, scale, logit_bias=logit_bias)
    return _attn_sublayer_cuda(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                               a_qkv, a_out, heads, head_dim, eps, scale,
                               logit_bias)
