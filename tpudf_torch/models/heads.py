"""Classifier heads over pooled SigLIP features (tpudf/models/heads.py):
  * the deployed v5 head: L2-norm → SE gate → LN → Drop(.3) → GELU MLP
    (Drop(.2)) → logit (appv3.py:1211-1254);
  * the CiFake FastBinaryClassifier heads: tiny / small / medium-large MLPs
    with L2 norm + LN and an optional single-token self-attention
    (cifake_binary_classifier.py:574-753), and their L1 + L2 penalty;
  * the HiDF video head: per-frame L2 norm → temporal mean → LN → ReLU MLP
    (hidf_video_classifier.py:279-320).
Dropout runs only when a torch.Generator is given (training), as JAX's
runs only with an rng key; its numbers are not JAX's (another generator).
The products run in f32 (`mm`), so the LNs see f32 and take the plain
form, not kernel K4."""

from __future__ import annotations

import math

import torch

from tpudf_torch.models.siglip import layer_norm
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.utils.nn import mm, rand_rows

_SQRT_HALF = math.sqrt(0.5)


def gelu_exact(x):
    """jax.nn.gelu(approximate=False): 0.5·x·erfc(−x/√2)."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF)


def _xavier(gen, shape):
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear(gen, din, dout):
    return {"w": _xavier(gen, (din, dout)), "b": torch.zeros(dout)}


def _dropout(x, rate, generator):
    """Inverted dropout: each element kept with probability 1 − rate and
    scaled by 1 / (1 − rate) (JAX's bernoulli mask); no generator → x."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


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


def _recorder(acts):
    return (lambda k, v: acts.__setitem__(k, v)) if acts is not None \
        else (lambda k, v: None)


def apply_binary_head(params, features, ln_eps=1e-5, generator=None,
                      acts=None):
    """features: (B, dim) pooled output → (B,) logits; dropout (.3 after
    the LN, .2 after fc1) only with a generator. acts: an optional dict
    that receives the se_fc1 / se_fc2 / fc1 / fc2 / fc3 activations, where
    JAX's records them (eval/analysis.py reads them)."""
    rec = _recorder(acts)
    f = l2_normalize(features)
    se = torch.relu(mm(f, params["se"]["fc1"]["w"]) + params["se"]["fc1"]["b"])
    rec("se_fc1", se)
    se = torch.sigmoid(mm(se, params["se"]["fc2"]["w"])
                       + params["se"]["fc2"]["b"])
    rec("se_fc2", se)
    x = f * se
    x = layer_norm(x, params["ln"], ln_eps)
    x = _dropout(x, 0.3, generator)
    x = gelu_exact(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    rec("fc1", x)
    x = _dropout(x, 0.2, generator)
    x = gelu_exact(mm(x, params["fc2"]["w"]) + params["fc2"]["b"])
    rec("fc2", x)
    out = mm(x, params["fc3"]["w"]) + params["fc3"]["b"]
    rec("fc3", out)
    return out[..., 0]


def init_fast_binary_head(generator: torch.Generator, dim: int,
                          model_size: str = "small",
                          use_attention: bool = True):
    """CiFake FastBinaryClassifier head family
    (cifake_binary_classifier.py:650-688). "size" and the attention's
    "heads" are static entries (a str and an int), not parameters."""
    g = generator
    p = {"ln": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
         "size": model_size}
    if use_attention and model_size in ("tiny", "small", "large"):
        p["attn"] = {"qkv": _linear(g, dim, 3 * dim),
                     "proj": _linear(g, dim, dim),
                     "heads": 4 if model_size in ("tiny", "small")
                     else min(8, dim // 64)}
    if model_size == "tiny":
        p["cls"] = [_linear(g, dim, 1)]
    elif model_size == "small":
        p["cls"] = [_linear(g, dim, dim // 4), _linear(g, dim // 4, 1)]
    else:
        p["cls"] = [_linear(g, dim, dim // 2), _linear(g, dim // 2, dim // 4),
                    _linear(g, dim // 4, 1)]
    return p


def _single_token_attention(p, f):
    """Self-attention over a single token (cifake LightweightAttention,
    cifake_binary_classifier.py:574-595): with one token the softmax is 1,
    so it is the value path's two linear maps."""
    c = f.shape[1]
    qkv = mm(f, p["qkv"]["w"]) + p["qkv"]["b"]
    return mm(qkv[:, 2 * c:], p["proj"]["w"]) + p["proj"]["b"]


def apply_fast_binary_head(params, features, generator=None,
                           dropout_rate=0.1, kernels: KernelSet = KERNELS):
    """features: (B, dim) → (B,) logits of the fast head; dropout only
    with a generator. Its LN reads the features' dtype: bf16 rows of a 128
    multiple go to K4 (`kernels.layer_norm`), as JAX's layer_norm sends
    them to its Pallas LN."""
    f = l2_normalize(features, eps=0.0)
    f = layer_norm(f, params["ln"], 1e-5, kernels)
    if "attn" in params:
        f = _single_token_attention(params["attn"], f)
    size, layers = params["size"], params["cls"]
    if size == "tiny":
        f = _dropout(f, dropout_rate * 0.5, generator)
        f = mm(f, layers[0]["w"]) + layers[0]["b"]
    elif size == "small":
        f = gelu_exact(mm(f, layers[0]["w"]) + layers[0]["b"])
        f = _dropout(f, dropout_rate, generator)
        f = mm(f, layers[1]["w"]) + layers[1]["b"]
    else:
        f = gelu_exact(mm(f, layers[0]["w"]) + layers[0]["b"])
        f = _dropout(f, dropout_rate, generator)
        f = gelu_exact(mm(f, layers[1]["w"]) + layers[1]["b"])
        f = _dropout(f, dropout_rate * 0.5, generator)
        f = mm(f, layers[2]["w"]) + layers[2]["b"]
    return f[..., 0]


def fast_head_regularization(params, l1=1e-5, l2=1e-4):
    """L1 + L2 penalty on the fast head's classifier weights (cifake
    :696-707)."""
    loss = 0.0
    for lin in params["cls"]:
        for leaf in (lin["w"], lin["b"]):
            loss = loss + l1 * torch.sum(torch.abs(leaf)) \
                + l2 * torch.sum(leaf ** 2)
    return loss


# ------------------------------------------------------------- video head

def init_video_head(generator: torch.Generator, dim: int):
    """HiDF BinaryVideoClassifier head (hidf_video_classifier.py:279-289):
    LN(dim) → dim/2 → dim/4 → 1, Xavier-uniform."""
    g = generator
    return {
        "ln": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
        "fc1": _linear(g, dim, dim // 2),
        "fc2": _linear(g, dim // 2, dim // 4),
        "fc3": _linear(g, dim // 4, 1),
    }


def apply_video_head(params, frame_features, generator=None,
                     dropout_rate=0.3, acts=None):
    """frame_features: (B, T, dim) per-frame pooled features → (B,)
    logits: L2 norm per frame (eps 0) → temporal mean → LN → ReLU MLP
    (hidf_video_classifier.py:300-320); dropout (rate after the LN, 0.67
    rate after fc1) only with a generator. acts: an optional dict that
    receives the fc1 / fc2 / fc3 activations."""
    rec = _recorder(acts)
    f = l2_normalize(frame_features, eps=0.0)
    pooled = torch.mean(f, dim=1)
    x = layer_norm(pooled, params["ln"], 1e-5)
    x = _dropout(x, dropout_rate, generator)
    x = torch.relu(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    rec("fc1", x)
    x = _dropout(x, dropout_rate * 0.67, generator)
    x = torch.relu(mm(x, params["fc2"]["w"]) + params["fc2"]["b"])
    rec("fc2", x)
    out = mm(x, params["fc3"]["w"]) + params["fc3"]["b"]
    rec("fc3", out)
    return out[..., 0]
