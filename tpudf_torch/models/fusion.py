"""The deployed Linear(2→1) expert fusion over (p_sig, p_freq)
(tpudf/models/fusion.py `apply_fusion_linear`)."""

from __future__ import annotations

import torch

from tpudf_torch.utils.nn import mm


def init_fusion_linear(generator: torch.Generator):
    return {"w": torch.randn((2, 1), generator=generator) * 0.5,
            "b": torch.zeros(1)}


def apply_fusion_linear(params, p_sig, p_freq):
    """(…,) probabilities → fused logit."""
    x = torch.stack([p_sig, p_freq], dim=-1)
    return (mm(x, params["w"]) + params["b"])[..., 0]
