"""The deployed frequency-expert MLP over the 24-d feature vector
(tpudf/models/freq_mlp.py): LN(24) → Linear 24→64 → GELU → Linear 64→1,
and its loader from the shipped artifact."""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.models.heads import gelu_exact
from tpudf_torch.models.siglip import layer_norm
from tpudf_torch.utils.nn import mm


def init_freq_mlp(generator: torch.Generator, in_dim=24, hid=64):
    g = generator
    return {
        "ln": {"scale": torch.ones(in_dim), "bias": torch.zeros(in_dim)},
        "fc1": {"w": torch.randn((in_dim, hid), generator=g) * in_dim ** -0.5,
                "b": torch.zeros(hid)},
        "fc2": {"w": torch.randn((hid, 1), generator=g) * hid ** -0.5,
                "b": torch.zeros(1)},
    }


def apply_freq_mlp(params, x):
    """x: (..., 24) features → (...,) logit (no eval-time noise)."""
    x = layer_norm(x, params["ln"], 1e-5)
    x = gelu_exact(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    return (mm(x, params["fc2"]["w"]) + params["fc2"]["b"])[..., 0]


def freq_mlp_from_safetensors(path, device="cpu"):
    """The deployed artifact siglip/freq_mlp.safetensors (keys
    net.0.{weight,bias} = SafeLayerNorm, net.1 = Linear 24→64, net.3 =
    Linear 64→1) as this module's tree on `device` ((in, out) weights)."""
    from safetensors.numpy import load_file
    sd = load_file(path)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "ln": {"scale": t(sd["net.0.weight"]), "bias": t(sd["net.0.bias"])},
        "fc1": {"w": t(sd["net.1.weight"].T), "b": t(sd["net.1.bias"])},
        "fc2": {"w": t(sd["net.3.weight"].T), "b": t(sd["net.3.bias"])},
    }
