"""SegFormer-style tamper-localisation decoder and the multi-task model
(tpudf/models/segformer.py) on PyTorch tensors.

K tapped hidden states → per-tap linear projection to embed_dim → token
grid → depthwise 3x3 + pointwise 1x1 convolution → exact GELU → concat →
sigmoid channel gate (two 1x1 convolutions) → 1x1 fuse → bilinear upsample
to the image size (jax.image.resize's rule, `data/pipeline.resize`) → 1x1
logit head. The 3-class head sits on the MAP-pooled output.

Parameters keep the JAX package's layout: convolution weights are HWIO
(a depthwise weight is (3, 3, 1, e)); `_conv2d` hands F.conv2d an OIHW view
of them, so trees cross between the packages unchanged (`convert.py`).
The decoder runs NCHW inside; its inputs and outputs are JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from tpudf_torch.core.precision import DEFAULT_POLICY, Policy, tree_map
from tpudf_torch.data.pipeline import resize
from tpudf_torch.models.siglip import SigLIPConfig, init_siglip, siglip_forward
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.utils.nn import mm, rand_rows


@dataclasses.dataclass(frozen=True)
class MTLConfig:
    backbone: SigLIPConfig
    seg_layers: tuple = (2, 6, 10, -1)   # hidden-state taps (ref default)
    embed_dim: int = 256
    num_classes: int = 3


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _conv(gen, kh, kw, cin, cout):
    """torch Conv2d's default init, U(±1/sqrt(fan_in)) for weight and bias,
    in HWIO."""
    bound = (1.0 / (kh * kw * cin)) ** 0.5
    return {"w": _uniform(gen, (kh, kw, cin, cout), bound),
            "b": _uniform(gen, (cout,), bound)}


def init_segformer_decoder(generator: torch.Generator, cfg: MTLConfig):
    """Seeded decoder parameters with the JAX init's shapes and bounds."""
    w, e = cfg.backbone.width, cfg.embed_dim
    k = len(cfg.seg_layers)
    g = generator
    return {
        "projs": [{"w": torch.randn((w, e), generator=g) * (w ** -0.5),
                   "b": torch.zeros(e)} for _ in range(k)],
        "smooth": [{"dw": _conv(g, 3, 3, 1, e), "pw": _conv(g, 1, 1, e, e)}
                   for _ in range(k)],
        "attn1": _conv(g, 1, 1, e * k, (e * k) // 4),
        "attn2": _conv(g, 1, 1, (e * k) // 4, e * k),
        "fuse": _conv(g, 1, 1, e * k, e),
        "head": _conv(g, 1, 1, e, 1),
    }


def init_mtl(generator: torch.Generator, cfg: MTLConfig,
             backbone_params=None):
    """Full MTL bundle: backbone + 3-class head + seg decoder."""
    if backbone_params is None:
        backbone_params = init_siglip(generator, cfg.backbone)
    w = cfg.backbone.width
    return {
        "backbone": backbone_params,
        "cls_head": {"w": torch.randn((w, cfg.num_classes),
                                      generator=generator) * (w ** -0.5),
                     "b": torch.zeros(cfg.num_classes)},
        "decoder": init_segformer_decoder(generator, cfg),
    }


def _conv2d(x, p, groups=1):
    """'SAME' stride-1 convolution of NCHW x with an HWIO weight."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)           # OIHW view
    return F.conv2d(x, w, p["b"].to(x.dtype), padding=w.shape[-1] // 2,
                    groups=groups)


def apply_segformer_decoder(params, hidden_list: Sequence, grid_hw,
                            target_size: int):
    """hidden_list: K tensors (B, N, W) → (B, target, target) seg logits."""
    h, w = grid_hw
    feats = []
    for proj, smooth, tokens in zip(params["projs"], params["smooth"],
                                    hidden_list):
        dt = tokens.dtype
        x = mm(tokens, proj["w"].to(dt)) + proj["b"].to(dt)
        b, _, e = x.shape
        x = x.reshape(b, h, w, e).permute(0, 3, 1, 2)   # NCHW
        x = _conv2d(x, smooth["dw"], groups=e)
        x = _conv2d(x, smooth["pw"])
        feats.append(F.gelu(x))
    x = torch.cat(feats, dim=1)                          # (B, E*K, H, W)
    a = F.gelu(_conv2d(x, params["attn1"]))
    a = torch.sigmoid(_conv2d(a, params["attn2"]))
    x = _conv2d(a * x, params["fuse"])
    x = resize(x, (*x.shape[:2], target_size, target_size), "bilinear")
    return _conv2d(x, params["head"])[:, 0]


def mtl_forward(params, pixels, cfg: MTLConfig,
                policy: Policy = DEFAULT_POLICY, cls_dropout_generator=None,
                dropout_rate=0.0, stop_grad_below=0, frozen_blocks_q=None,
                kernels: KernelSet = KERNELS):
    """pixels: (B, S, S, 3) → (cls_logits (B, 3), seg_logits (B, S, S)),
    both f32. The pooled output feeds the 3-class head; the hidden states
    at seg_layers (i → i + 1, -1 → the last) feed the decoder, upsampled to
    the input size. stop_grad_below / frozen_blocks_q: see siglip_forward."""
    out = siglip_forward(params["backbone"], pixels, cfg.backbone, policy,
                         output_hidden_states=True,
                         stop_grad_below=stop_grad_below,
                         frozen_blocks_q=frozen_blocks_q, kernels=kernels)
    pooled = out["pooled"]
    if cls_dropout_generator is not None and dropout_rate > 0:
        keep = 1.0 - dropout_rate
        drop = rand_rows(pooled.shape, cls_dropout_generator,
                         pooled.device) < keep
        pooled = torch.where(drop, pooled / keep, torch.zeros_like(pooled))
    dt = pooled.dtype
    cls_logits = (mm(pooled, params["cls_head"]["w"].to(dt))
                  + params["cls_head"]["b"].to(dt))
    hs = out["hidden_states"]
    last = len(hs) - 1
    feats = [hs[i + 1 if i >= 0 else last] for i in cfg.seg_layers]
    g = math.isqrt(feats[0].shape[1])
    seg = apply_segformer_decoder(params["decoder"], feats, (g, g),
                                  pixels.shape[1])
    return cls_logits.float(), seg.float()


def freeze_mask(params, cfg: MTLConfig, freeze_below: int = 21):
    """Frozen-variant mask (Siglip2sidafrozen.py:754-770): a tree of bools,
    True = trainable, False on the patch and position embeddings; and the
    (L,) bool vector of trainable layers, layer i trainable when
    i >= freeze_below."""
    mask = tree_map(lambda _: True, params)
    mask["backbone"]["embed"] = tree_map(lambda _: False,
                                         mask["backbone"]["embed"])
    return mask, torch.arange(cfg.backbone.layers) >= freeze_below
