"""Plain fused-QKV attention (tpudf/ops/attention.py `_reference_qkv`).

Serves calibration and the twin of kernel K1. The Pallas attention kernels
of the JAX package (`attention_qkv`, `attention`, `attention_bshd` and the
backward kernel) are not ported yet; the main path does its attention inside
K1.
"""

from __future__ import annotations

import torch


def attention_qkv_reference(qkv, heads, head_dim, scale=None,
                            logit_bias=None):
    """(B, S, 3W) fused [q | k | v] → (B, S, W), full softmax with an
    optional (B, S) per-key additive logit bias (ToMe proportional
    attention). Scores and softmax in f32 from the operands' values; the
    probabilities are cast to v's dtype before the value product, whose
    f32 sum is returned in v's dtype (JAX's einsum semantics)."""
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
    return o.to(v.dtype).reshape(b, s, w)
