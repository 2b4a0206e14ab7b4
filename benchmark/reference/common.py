"""Arithmetic shared by the references: the precision of a reference run,
TF32 off, layer norm, GELU, symmetric integer quantisation and its exact
product, multi-head attention with a per-key bias."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

FP8_MAX = 448.0            # float8_e4m3fn's largest finite value


@dataclasses.dataclass(frozen=True)
class Precision:
    """levels: the largest code of an integer stage (127: int8, 7: int4);
    low: the dtype the stages that the program runs in bf16 are rounded
    through (None: f32); high: the same for its f32 stages."""
    name: str
    levels: int
    low: torch.dtype | None
    high: torch.dtype | None

    def lowp(self, x):
        return _round(x, self.low)

    def highp(self, x):
        return _round(x, self.high)


SOUND = Precision("sound", 127, None, None)
CONTROL = Precision("control", 7, torch.float8_e4m3fn, torch.bfloat16)


def _round(x, dtype):
    """x rounded through dtype and back to f32; fp8 with a per-tensor
    scale that maps the largest |x| to the format's largest value."""
    if dtype is None:
        return x
    if dtype == torch.float8_e4m3fn:
        s = torch.clamp(x.detach().abs().amax(), min=1e-12) / FP8_MAX
        return (x / s).to(dtype).float() * s
    return x.to(dtype).float()


def ste(x, fn):
    """fn(x) forward, the identity backward (a rounding inside autograd)."""
    return x + (fn(x) - x).detach()


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32 on the card, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def gelu_exact(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def codes(x, amax, levels):
    """Symmetric codes of x with the scale amax / levels, as f32."""
    return torch.clamp(torch.round(x * (levels / amax)), -levels, levels)


def quant_weight(w, levels):
    """(..., K, N) → (codes, (..., N) scales): symmetric per output
    column."""
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / levels, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale[..., None, :]), -levels,
                       levels), scale


def int_matmul(xc, wc):
    """Exact product of integer codes held in f32 (f64 sums)."""
    return (xc.double() @ wc.double()).float()


def attention(q, k, v, scale, bias=None):
    """q, k, v (B, H, S, d); bias (B, S) per key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def split_heads(t, heads):
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def merge_heads(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)
