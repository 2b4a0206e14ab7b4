"""Weights made on the device from the seed, in the trees the port's
builders take: the tower in the layout of `models/convert.from_hf_state_
dict` (matmul weights (in, out), the patch kernel (p·p·3, W) in (kh, kw,
c) order, block leaves stacked on a leading L axis), the heads as
`entry.init_params` lays them out, the MTL tree as `entry.mtl_params`
does. One `torch.randn` on a generator of the card fills every leaf of a
tree; matrices are N(0, 1/fan_in), biases N(0, 0.02²), layer
norm scales 1 + N(0, 0.1²), the position table and MAP probe N(0, 0.02²).
The same seed gives the same tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

WEIGHTS, INPUTS = 0, 1      # the generators' purposes


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A generator of `device` for one purpose of a seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + purpose) % (2 ** 63))


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    kind: str = "matrix"     # matrix | bias | scale | small
    fan_in: int = 1


def _matrix(*shape, fan_in=None):
    return Leaf(tuple(shape), "matrix", fan_in or shape[-2])


def _bias(*shape):
    return Leaf(tuple(shape), "bias")


def _ln(*lead, w):
    return {"scale": Leaf(tuple(lead) + (w,), "scale"),
            "bias": _bias(*lead, w)}


def tower_spec(config: dict) -> dict:
    """The SigLIP tower with its MAP head."""
    w, m = config["hidden_size"], config["intermediate_size"]
    n_layers, p = config["num_hidden_layers"], config["patch_size"]
    n = (config["image_size"] // p) ** 2
    L = n_layers
    return {
        "embed": {"kernel": _matrix(p * p * 3, w), "bias": _bias(w),
                  "pos": Leaf((n, w), "small")},
        "blocks": {
            "ln1": _ln(L, w=w),
            "attn": {"qkv_w": _matrix(L, w, 3 * w), "qkv_b": _bias(L, 3 * w),
                     "out_w": _matrix(L, w, w), "out_b": _bias(L, w)},
            "ln2": _ln(L, w=w),
            "mlp": {"fc1_w": _matrix(L, w, m), "fc1_b": _bias(L, m),
                    "fc2_w": _matrix(L, m, w), "fc2_b": _bias(L, w)}},
        "post_ln": _ln(w=w),
        "head": {"probe": Leaf((1, w), "small"),
                 "in_w": _matrix(w, 3 * w), "in_b": _bias(3 * w),
                 "out_w": _matrix(w, w), "out_b": _bias(w),
                 "ln": _ln(w=w),
                 "fc1_w": _matrix(w, m), "fc1_b": _bias(m),
                 "fc2_w": _matrix(m, w), "fc2_b": _bias(w)}}


def _linear(din, dout):
    return {"w": _matrix(din, dout), "b": _bias(dout)}


def detect_spec(config: dict) -> dict:
    """{"backbone", "head", "freq", "fusion"}: the tower, the v5 binary
    head, the frequency MLP (24 → 64 → 1) and the Linear(2 → 1) fusion."""
    w = config["hidden_size"]
    return {
        "backbone": tower_spec(config),
        "head": {"se": {"fc1": _linear(w, w // 16),
                        "fc2": _linear(w // 16, w)},
                 "ln": _ln(w=w), "fc1": _linear(w, w // 2),
                 "fc2": _linear(w // 2, w // 4), "fc3": _linear(w // 4, 1)},
        "freq": {"ln": _ln(w=24), "fc1": _linear(24, 64),
                 "fc2": _linear(64, 1)},
        "fusion": _linear(2, 1)}


def _conv(kh, kw, cin, cout):
    return {"w": _matrix(kh, kw, cin, cout, fan_in=kh * kw * cin),
            "b": _bias(cout)}


def mtl_spec(config: dict, taps, embed_dim: int) -> dict:
    """{"backbone", "cls_head", "decoder"} of `init_mtl`: the tower, the
    3-class head, the SegFormer decoder over len(taps) hidden states."""
    w, e, k = config["hidden_size"], embed_dim, len(taps)
    return {
        "backbone": tower_spec(config),
        "cls_head": _linear(w, 3),
        "decoder": {
            "projs": [_linear(w, e) for _ in range(k)],
            "smooth": [{"dw": _conv(3, 3, 1, e), "pw": _conv(1, 1, e, e)}
                       for _ in range(k)],
            "attn1": _conv(1, 1, e * k, (e * k) // 4),
            "attn2": _conv(1, 1, (e * k) // 4, e * k),
            "fuse": _conv(1, 1, e * k, e),
            "head": _conv(1, 1, e, 1)}}


def _leaves(spec):
    if isinstance(spec, dict):
        for v in spec.values():
            yield from _leaves(v)
    elif isinstance(spec, list):
        for v in spec:
            yield from _leaves(v)
    else:
        yield spec


def make(spec, gen: torch.Generator, device):
    """The f32 tree of `spec` from one randn call of `gen`, each leaf in
    storage of its own (a view would keep the whole draw alive)."""
    total = sum(math.prod(leaf.shape) for leaf in _leaves(spec))
    buf = torch.randn(total, generator=gen, device=device)
    offset = 0

    def fill(s):
        nonlocal offset
        if isinstance(s, dict):
            return {k: fill(v) for k, v in s.items()}
        if isinstance(s, list):
            return [fill(v) for v in s]
        n = math.prod(s.shape)
        v = buf[offset:offset + n].view(s.shape)
        offset += n
        if s.kind == "matrix":
            v.mul_(s.fan_in ** -0.5)
        elif s.kind == "scale":
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.02)
        return v.clone()

    return fill(spec)
