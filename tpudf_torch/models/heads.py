"""The deployed v5 binary head over pooled SigLIP features
(tpudf/models/heads.py), eval mode: L2-norm → SE gate → LN → GELU MLP →
logit. Its products run in f32 (`mm`), so its LN sees f32 and takes the
plain form, not kernel K4."""

from __future__ import annotations

import math

import torch

from tpudf_torch.models.siglip import layer_norm
from tpudf_torch.utils.nn import mm

_SQRT_HALF = math.sqrt(0.5)


def gelu_exact(x):
    """jax.nn.gelu(approximate=False): 0.5·x·erfc(−x/√2)."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF)


def _xavier(gen, shape):
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear(gen, din, dout):
    return {"w": _xavier(gen, (din, dout)), "b": torch.zeros(dout)}


def l2_normalize(f, eps=1e-6):
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + eps)


def init_binary_head(generator: torch.Generator, dim: int):
    """SE(dim→dim/16→dim) + LN→MLP(dim→dim/2→dim/4→1), Xavier-uniform."""
    g = generator
    return {
        "se": {"fc1": _linear(g, dim, dim // 16),
               "fc2": _linear(g, dim // 16, dim)},
        "ln": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
        "fc1": _linear(g, dim, dim // 2),
        "fc2": _linear(g, dim // 2, dim // 4),
        "fc3": _linear(g, dim // 4, 1),
    }


def apply_binary_head(params, features, ln_eps=1e-5):
    """features: (B, dim) pooled output → (B,) logits (no dropout)."""
    f = l2_normalize(features)
    se = torch.relu(mm(f, params["se"]["fc1"]["w"]) + params["se"]["fc1"]["b"])
    se = torch.sigmoid(mm(se, params["se"]["fc2"]["w"])
                       + params["se"]["fc2"]["b"])
    x = f * se
    x = layer_norm(x, params["ln"], ln_eps)
    x = gelu_exact(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    x = gelu_exact(mm(x, params["fc2"]["w"]) + params["fc2"]["b"])
    out = mm(x, params["fc3"]["w"]) + params["fc3"]["b"]
    return out[..., 0]
