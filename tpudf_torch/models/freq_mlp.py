"""The frequency-expert MLPs over the 24-d feature vector
(tpudf/models/freq_mlp.py):
  * the deployed "simple" FreqMLP: LN(24) → Linear 24→64 → GELU → Linear
    64→1, with the optional eval-time 0.001·N(0, 1) input jitter
    (appv3.py:1483-1510; artifact freq_mlp.safetensors, keys net.0/1/3);
  * the v5 trainer FreqMLP: FeatureNormalizer → ContrastScaler (tanh) →
    BandGating (4 bands) → 2 residual MLP blocks (dropout 0.05 in
    training) → linear head → TemperatureScaler ("FreqMLP trainer.py"
    :225-305; artifact freq_mlp_v5.safetensors).
Random draws (init, jitter, dropout) come from an explicit
torch.Generator, where JAX takes a jax.random key; with no generator the
jitter and the dropout do not run. The artifacts are read with the port's
own safetensors reader (`utils/safetensors_io.py`)."""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.models.heads import _dropout, gelu_exact
from tpudf_torch.models.siglip import layer_norm
from tpudf_torch.utils.nn import mm
from tpudf_torch.utils.safetensors_io import load_file


def init_freq_mlp(generator: torch.Generator, in_dim=24, hid=64):
    g = generator
    return {
        "ln": {"scale": torch.ones(in_dim), "bias": torch.zeros(in_dim)},
        "fc1": {"w": torch.randn((in_dim, hid), generator=g) * in_dim ** -0.5,
                "b": torch.zeros(hid)},
        "fc2": {"w": torch.randn((hid, 1), generator=g) * hid ** -0.5,
                "b": torch.zeros(1)},
    }


def apply_freq_mlp(params, x, generator=None):
    """x: (..., 24) features → (...,) logit. generator: when given, adds
    the reference's eval-time jitter 0.001·N(0, 1) drawn from it."""
    if generator is not None:
        x = x + 0.001 * torch.randn(x.shape, generator=generator,
                                    device=x.device, dtype=x.dtype)
    x = layer_norm(x, params["ln"], 1e-5)
    x = gelu_exact(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    return (mm(x, params["fc2"]["w"]) + params["fc2"]["b"])[..., 0]


def freq_mlp_from_safetensors(path, device="cpu"):
    """The deployed artifact siglip/freq_mlp.safetensors (keys
    net.0.{weight,bias} = SafeLayerNorm, net.1 = Linear 24→64, net.3 =
    Linear 64→1) as this module's tree on `device` ((in, out) weights)."""
    sd = load_file(path)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "ln": {"scale": t(sd["net.0.weight"]), "bias": t(sd["net.0.bias"])},
        "fc1": {"w": t(sd["net.1.weight"].T), "b": t(sd["net.1.bias"])},
        "fc2": {"w": t(sd["net.3.weight"].T), "b": t(sd["net.3.bias"])},
    }


def freq_mlp_v5_from_safetensors(path, device="cpu"):
    """A v5-trainer artifact ("FreqMLP trainer.py":274-309 layout:
    normer.mean/std, contrast.alpha/beta, band.gates,
    blocks.N.{norm,fc1,fc2}, head, temp.T) as this module's v5 tree."""
    sd = load_file(path)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    blocks = []
    i = 0
    while f"blocks.{i}.fc1.weight" in sd:
        blocks.append({
            "ln": {"scale": t(sd[f"blocks.{i}.norm.weight"]),
                   "bias": t(sd[f"blocks.{i}.norm.bias"])},
            "fc1": {"w": t(sd[f"blocks.{i}.fc1.weight"].T),
                    "b": t(sd[f"blocks.{i}.fc1.bias"])},
            "fc2": {"w": t(sd[f"blocks.{i}.fc2.weight"].T),
                    "b": t(sd[f"blocks.{i}.fc2.bias"])},
        })
        i += 1
    return {
        "norm_mean": t(sd["normer.mean"]),
        "norm_std": t(sd["normer.std"]),
        "contrast": {"alpha": t(sd["contrast.alpha"]),
                     "beta": t(sd["contrast.beta"])},
        "gates": t(sd["band.gates"]),
        "blocks": blocks,
        "head": {"w": t(sd["head.weight"].T), "b": t(sd["head.bias"])},
        "temp": t(sd["temp.T"]).reshape(()),
    }


# ----------------------------------------------------------------- v5

def init_freq_mlp_v5(generator: torch.Generator, dim=24, hidden=64,
                     num_bands=4):
    g = generator
    s = lambda i, o: torch.randn((i, o), generator=g) * i ** -0.5

    def block():
        return {
            "ln": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
            "fc1": {"w": s(dim, hidden), "b": torch.zeros(hidden)},
            "fc2": {"w": s(hidden, dim), "b": torch.zeros(dim)},
        }

    return {
        "norm_mean": torch.zeros(dim),
        "norm_std": torch.ones(dim),
        "contrast": {"alpha": torch.ones(dim), "beta": torch.zeros(dim)},
        "gates": torch.zeros(num_bands),
        "blocks": [block(), block()],
        "head": {"w": s(dim, 1), "b": torch.zeros(1)},
        "temp": torch.tensor(1.0),
    }


def fit_freq_normalizer(params, feats):
    """FeatureNormalizer.fit ("FreqMLP trainer.py":225-229): the buffers
    become the features' mean and their unbiased std + 1e-6."""
    params = dict(params)
    params["norm_mean"] = torch.mean(feats, dim=0)
    params["norm_std"] = torch.std(feats, dim=0, unbiased=True) + 1e-6
    return params


def apply_freq_mlp_v5(params, x, generator=None, dropout=0.05):
    """x: (..., 24) → (...,) temperature-scaled logit; dropout after each
    block's fc2 only with a generator."""
    d = x.shape[-1]
    nb = params["gates"].shape[0]
    x = (x - params["norm_mean"]) / (params["norm_std"] + 1e-6)
    x = torch.tanh(params["contrast"]["alpha"] * x
                   + params["contrast"]["beta"])
    gates = torch.sigmoid(params["gates"])
    x = x * torch.repeat_interleave(gates, d // nb)
    for blk in params["blocks"]:
        r = x
        h = layer_norm(x, blk["ln"], 1e-5)
        h = gelu_exact(mm(h, blk["fc1"]["w"]) + blk["fc1"]["b"])
        h = mm(h, blk["fc2"]["w"]) + blk["fc2"]["b"]
        h = _dropout(h, dropout, generator)
        x = h + r
    z = (mm(x, params["head"]["w"]) + params["head"]["b"])[..., 0]
    return z / (params["temp"] + 1e-6)
