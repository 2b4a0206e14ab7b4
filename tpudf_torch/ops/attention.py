"""Fused-QKV attention — kernel K9 — and its plain twin.

    qkv (B, S, 3W) bf16, laid out [q | k | v] with heads contiguous
    → o (B, S, W) bf16

Replaces tpudf/ops/attention.py `_attention_qkv_pallas` (inner `kernel`,
`_one_head` without `int8_attn`; wrapper `attention_qkv`), the float
tower's attention. Same arithmetic: scores q·k in f32 times scale, plus an
optional per-key logit bias (ToMe proportional attention: the JAX function
takes it and routes it to `_reference_qkv`; here the same kernel takes
it), softmax in f32, p rounded to bf16 for AV, AV accumulated in f32, the
output rounded once to bf16.

The CUDA kernel is `csrc/attention.cu`, the attention kernel of K1 with a
bf16 output epilogue in place of its int8 quant (one template). It takes
head_dim 64 and S ≤ 256 (base-256); any other shape on a CUDA tensor
raises. Both products run on the tensor cores (mma.sync bf16, f32
accumulate) with each warp's full score rows in registers; at S=256 the
card's bound is the bytes of qkv.

`attention_qkv_reference` is the twin, the JAX package's `_reference_qkv`;
it also serves calibration and the twin of K1.

K10 (`attention_qkv_bwd`), the backward of K9 without a logit bias:

    qkv (B, S, 3W) bf16, g (B, S, W) bf16 → dqkv (B, S, 3W) bf16

replaces tpudf/ops/attention.py `_attn_qkv_bwd_kernel` (wrapper
`_attention_qkv_bwd_pallas`, reached through the custom VJP of
`_fused_qkv_with_vjp`). Same arithmetic: P = softmax(scale q k^T) in f32,
dV = bf16(P)^T g, dP = g V^T, D = rowsum(dP * P) with the unrounded P,
dS = P * (dP - D) * scale, dQ = bf16(dS) K, dK = bf16(dS)^T Q, f32 sums,
one bf16 rounding of each output. The CUDA kernels are in
`csrc/attention.cu`: a pass over query tiles (row statistics, D and dQ)
and a pass over key tiles (dK and dV), FlashAttention-2's split, because
one head's (S, S) f32 P (256 KB at S = 256) does not fit an SM. It takes
head_dim 64 and S <= 256, as K9 does; at the MTL step's shape the card's
bound is the bytes of qkv, g and dqkv. `attention_qkv_bwd_reference` is
its twin, the TPU kernel's formulas in PyTorch.

`attention_qkv_vjp` is the tower's attention: one autograd Function whose
forward is K9 and whose backward is K10 (or their twins), saving only qkv
as the JAX VJP does.
"""

from __future__ import annotations

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build

KERNEL = "attention_qkv"
KERNEL_BWD = "attention_qkv_bwd"
HEAD_DIM = 64
MAX_SEQ = 256


def attention_qkv_reference(qkv, heads, head_dim, scale=None,
                            logit_bias=None, out_dtype=None):
    """(B, S, 3W) fused [q | k | v] → (B, S, W), full softmax with an
    optional (B, S) per-key additive logit bias (ToMe proportional
    attention). Scores and softmax in f32 from the operands' values; the
    probabilities are cast to v's dtype before the value product, whose
    f32 sum is returned in v's dtype (JAX's einsum semantics), or in
    out_dtype (the whole-layer kernel K7 quantises the f32 sum)."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, w3 = qkv.shape
    w = w3 // 3
    q = qkv[..., :w].reshape(b, s, heads, head_dim)
    k = qkv[..., w:2 * w].reshape(b, s, heads, head_dim)
    v = qkv[..., 2 * w:].reshape(b, s, heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_bias is not None:
        logits = logits + logit_bias[:, None, None, :].float()
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return o.to(out_dtype or v.dtype).reshape(b, s, w)


def _attention_qkv_cuda(qkv, heads, head_dim, scale, logit_bias):
    b, s, w3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or head_dim != HEAD_DIM or s > MAX_SEQ
            or w3 != 3 * heads * head_dim):
        raise ValueError(f"K9 takes bf16 qkv with head_dim {HEAD_DIM} and "
                         f"S <= {MAX_SEQ}, got {qkv.dtype} {tuple(qkv.shape)} "
                         f"heads {heads} head_dim {head_dim}")
    out = torch.empty((b, s, heads * head_dim), dtype=torch.bfloat16,
                      device=qkv.device)
    bias = None if logit_bias is None else logit_bias.float().contiguous()
    _build.call("tpudf_attention_bf16", qkv.contiguous(), bias, out, b, s,
                heads, head_dim, float(scale))
    LAUNCHES.hit(KERNEL)
    return out


def attention_qkv(qkv, heads, head_dim, scale=None, *, logit_bias=None):
    """(B, S, 3W) → (B, S, W). logit_bias: optional (B, S) f32 per-key
    bias. CPU tensors take the plain twin; CUDA tensors launch K9 or
    raise."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not qkv.is_cuda:
        return attention_qkv_reference(qkv, heads, head_dim, scale,
                                       logit_bias)
    return _attention_qkv_cuda(qkv, heads, head_dim, scale, logit_bias)


def attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale=None):
    """Plain twin of K10: (B, S, 3W) qkv and (B, S, W) cotangent g → dqkv
    (B, S, 3W) in qkv's dtype, laid out [dq | dk | dv]. P and dS are cast
    to qkv's dtype (bf16 on the card) only for the products that read
    them, as the TPU kernel casts them."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, w3 = qkv.shape
    w = w3 // 3
    dt = qkv.dtype

    def heads_first(t):                     # (B, S, W) → (B, H, S, d) f32
        return t.reshape(b, s, heads, head_dim).transpose(1, 2).float()

    q, k, v = (heads_first(qkv[..., i * w:(i + 1) * w]) for i in range(3))
    gh = heads_first(g)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    dsb = ds.to(dt).float()
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    return torch.cat([t.transpose(1, 2).reshape(b, s, w)
                      for t in (dq, dk, dv)], dim=-1).to(dt)


def _attention_qkv_bwd_cuda(qkv, g, heads, head_dim, scale):
    b, s, w3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16
            or head_dim != HEAD_DIM or s > MAX_SEQ
            or w3 != 3 * heads * head_dim or g.shape != (b, s, w3 // 3)):
        raise ValueError(f"K10 takes bf16 qkv (B, S, 3W) and g (B, S, W) "
                         f"with head_dim {HEAD_DIM} and S <= {MAX_SEQ}, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}, {g.dtype} "
                         f"{tuple(g.shape)}, heads {heads} head_dim "
                         f"{head_dim}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32,
                        device=qkv.device)
    _build.call("tpudf_attention_bwd_bf16", qkv.contiguous(), g.contiguous(),
                dqkv, stats, b, s, heads, head_dim, float(scale))
    LAUNCHES.hit(KERNEL_BWD)
    return dqkv


def attention_qkv_bwd(qkv, g, heads, head_dim, scale=None):
    """dqkv of K9 at qkv for the output cotangent g. CPU tensors take the
    plain twin; CUDA tensors launch K10 or raise."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not qkv.is_cuda:
        return attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
    return _attention_qkv_bwd_cuda(qkv, g, heads, head_dim, scale)


class _FusedQKVAttention(torch.autograd.Function):
    """fwd(qkv) forward, bwd(qkv, g) backward; only qkv is saved."""

    @staticmethod
    def forward(ctx, qkv, heads, head_dim, scale, fwd, bwd):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, head_dim, scale, bwd)
        return fwd(qkv, heads, head_dim, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        heads, head_dim, scale, bwd = ctx.args
        return (bwd(qkv, g.contiguous(), heads, head_dim, scale),
                None, None, None, None, None)


def attention_qkv_vjp(qkv, heads, head_dim, scale=None, *, fwd=attention_qkv,
                      bwd=attention_qkv_bwd, logit_bias=None):
    """The tower's differentiable attention: fwd (K9 or its twin) forward
    and bwd (K10 or its twin) backward. With a logit bias (ToMe, serving
    only) it calls fwd directly, as JAX sends biased attention to its XLA
    reference: the CPU twin is then differentiated by autograd, and a CUDA
    tensor that needs a gradient raises, since no kernel computes that
    gradient."""
    scale = scale if scale is not None else head_dim ** -0.5
    if logit_bias is not None:
        if qkv.is_cuda and qkv.requires_grad and torch.is_grad_enabled():
            raise ValueError("attention with a logit bias has no backward "
                             "kernel; it is a serving path")
        return fwd(qkv, heads, head_dim, scale, logit_bias=logit_bias)
    return _FusedQKVAttention.apply(qkv, heads, head_dim, scale, fwd, bwd)
