"""SigLIP vision tower (tpudf/models/siglip.py) on PyTorch tensors.

Same parameter layout as the JAX package (all matmul weights (in, out);
block leaves stacked on a leading L axis; int8 leaves {q, scale}):
  params = {
    "embed": {"kernel": (p*p*3, W) flattened (kh,kw,c), "bias": (W,),
              "pos": (N, W)},
    "blocks": {"ln1", "attn": {"qkv_w","qkv_b","out_w","out_b"}, "ln2",
               "mlp": {"fc1_w","fc1_b","fc2_w","fc2_b"}[, "act_scales"]},
    "post_ln": {"scale","bias"},
    "head": {"probe","in_w","in_b","out_w","out_b","ln","fc1_w","fc1_b",
             "fc2_w","fc2_b"},
  }
Pixels are NHWC. On the card the tower runs the static-W8A8 blocks through
kernels K1 and K2 by default, or through the route `TPUDF_INT8_KERNELS`
names (K5, K6 or K9 / 9b and the out-projection, K7, K8 and the int8
products; `_static_int8_block`), the
dynamic-int8 blocks through the int8 products, K9 and K4, the float
(bf16) blocks through K13 (LN1 + QKV), K9 (attention), K13 (out-proj +
residual) and K14 (LN2 + MLP + residual), and its bf16 layer norms
through K4. `tower_params` derives once what the
forward reads: float blocks in the compute dtype, int8 blocks with the
kernel layout.

Training form (the MTL trainer): the float blocks, the layer norms and the
head are differentiable, K9's backward is K10 and K13/K14/K4 backpropagate
through their twins' VJPs; gradients reach f32 master weights through the
casts to the compute dtype. `stop_grad_below=k` runs the embeddings and
layers < k without autograd (JAX's stop_gradient at the freeze boundary),
optionally on a static-W8A8 copy of those k layers (`frozen_blocks_q`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from tpudf_torch.convert import add_kernel_layout
from tpudf_torch.core.precision import (DEFAULT_POLICY, Policy, cast_tree,
                                        round_tree, tree_map)
from tpudf_torch.ops.attention import attention_qkv_vjp
from tpudf_torch.ops.int8_block import (attn_sublayer_int8_fits,
                                        layer_int8_eligible)
from tpudf_torch.ops.quant import (int8_matmul, int8_matmul_pre,
                                   int8_matmul_static, is_quantized,
                                   is_static_quantized, prepad_siglip_static)
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.ops.tome import merge_schedule, merge_step
from tpudf_torch.utils.nn import gelu_tanh


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    image_size: int = 256
    patch_size: int = 16
    ln_eps: float = 1e-6
    with_head: bool = True          # MAP attention-pooling head
    remat: bool = False             # recompute each block in the backward

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


CONFIGS = {
    "base-256": SigLIPConfig(768, 12, 12, 3072, 256, 16),
    "base-384": SigLIPConfig(768, 12, 12, 3072, 384, 16),
    "large-384": SigLIPConfig(1024, 24, 16, 4096, 384, 16),
    "so400m-512": SigLIPConfig(1152, 27, 16, 4304, 512, 16),
    "test-32": SigLIPConfig(64, 2, 2, 128, 32, 16),
    "test-64": SigLIPConfig(64, 2, 2, 128, 64, 8),
}


# ---------------------------------------------------------------- init

def _dense_init(gen, fan_in, shape):
    return torch.randn(shape, generator=gen) * (fan_in ** -0.5)


def _ln_init(width):
    return {"scale": torch.ones(width), "bias": torch.zeros(width)}


def init_siglip(generator: torch.Generator, cfg: SigLIPConfig):
    """Random-init parameter tree on the generator's device, with the JAX
    package's distributions (its numbers differ: another generator)."""
    w, pd = cfg.width, cfg.patch_size * cfg.patch_size * 3
    g = generator
    params: dict[str, Any] = {
        "embed": {
            "kernel": _dense_init(g, pd, (pd, w)),
            "bias": torch.zeros(w),
            "pos": torch.randn((cfg.num_patches, w), generator=g) * 0.02,
        },
    }

    def block():
        return {
            "ln1": _ln_init(w),
            "attn": {
                "qkv_w": _dense_init(g, w, (w, 3 * w)),
                "qkv_b": torch.zeros(3 * w),
                "out_w": _dense_init(g, w, (w, w)),
                "out_b": torch.zeros(w),
            },
            "ln2": _ln_init(w),
            "mlp": {
                "fc1_w": _dense_init(g, w, (w, cfg.mlp_dim)),
                "fc1_b": torch.zeros(cfg.mlp_dim),
                "fc2_w": _dense_init(g, cfg.mlp_dim, (cfg.mlp_dim, w)),
                "fc2_b": torch.zeros(w),
            },
        }

    blocks = [block() for _ in range(cfg.layers)]
    params["blocks"] = _stack(blocks)
    params["post_ln"] = _ln_init(w)
    if cfg.with_head:
        params["head"] = {
            "probe": torch.randn((1, w), generator=g) * 0.02,
            "in_w": _dense_init(g, w, (w, 3 * w)),
            "in_b": torch.zeros(3 * w),
            "out_w": _dense_init(g, w, (w, w)),
            "out_b": torch.zeros(w),
            "ln": _ln_init(w),
            "fc1_w": _dense_init(g, w, (w, cfg.mlp_dim)),
            "fc1_b": torch.zeros(cfg.mlp_dim),
            "fc2_w": _dense_init(g, cfg.mlp_dim, (cfg.mlp_dim, w)),
            "fc2_b": torch.zeros(w),
        }
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_slice(blocks, i):
    """Layer i of the stacked block tree (views, no copies)."""
    return tree_map(lambda a: a[i], blocks)


# ---------------------------------------------------------------- forward

def layer_norm(x, p, eps, kernels: KernelSet = KERNELS):
    """f32-statistics layer norm. bf16 rows of a 128-multiple width go to
    kernel K4 (its wrapper takes the twin for a CPU tensor), as the JAX
    tower sends them to the Pallas LN on a TPU; everything else is plain."""
    if x.dtype == torch.bfloat16 and x.shape[-1] % 128 == 0:
        return kernels.layer_norm(x, p["scale"], p["bias"], eps)
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    m2 = torch.mean(x32 * x32, -1, keepdim=True)
    var = torch.clamp(m2 - mu * mu, min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def patchify(pixels, patch):
    """(B, H, W, 3) NHWC → (B, N, patch*patch*3) flattened (kh, kw, c):
    the rows `patch_embed`'s kernel multiplies."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)            # (B, gh, gw, kh, kw, c)
    return x.reshape(b, gh * gw, patch * patch * c)


def patch_embed(pixels, kernel, bias, patch):
    """(B, H, W, 3) → (B, N, W) as one strided conv (JAX's is XLA).
    kernel: (patch*patch*3, W) in (kh, kw, c) order."""
    b, h, w, _ = pixels.shape
    k = kernel.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(pixels.permute(0, 3, 1, 2), k.to(pixels.dtype),
                 stride=patch)                                  # (B, W, gh, gw)
    y = y.flatten(2).transpose(1, 2)
    return y + bias.to(pixels.dtype)


def _bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float64 interpolation matrix of torch F.interpolate
    mode='bicubic', align_corners=False, antialias=False (cubic convolution
    kernel a=-0.75, border-replicate): JAX's `_bicubic_matrix`."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    m = np.zeros((dst, src), np.float64)
    scale = src / dst
    for i in range(dst):
        c = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(c))
        t = c - x0
        for tap, dist in zip(range(x0 - 1, x0 + 3),
                             (1 + t, t, 1 - t, 2 - t)):
            m[i, min(max(tap, 0), src - 1)] += k(dist)
    return m


@contextlib.contextmanager
def _no_tf32():
    """f32 products in f32 on the card (TF32 keeps ~3 digits)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def interpolate_pos(pos, src_grid: int, dst_hw: tuple[int, int]):
    """Bicubic position-embedding interpolation for another image size:
    (src_grid², W) → (dst_h · dst_w, W) in f32, HF's
    interpolate_pos_encoding=True (JAX's `interpolate_pos`): the float64
    matrices of `_bicubic_matrix` applied as f32 by two products."""
    n, w = pos.shape
    grid = pos.float().reshape(src_grid, src_grid, w)
    mh, mw = (torch.from_numpy(_bicubic_matrix(src_grid, d)).to(
        device=pos.device, dtype=torch.float32) for d in dst_hw)
    with _no_tf32():
        out = torch.einsum("ij,jkc->ikc", mh, grid)
        out = torch.einsum("kj,ijc->ikc", mw, out)
    return out.reshape(dst_hw[0] * dst_hw[1], w)


def embed(ep, pixels, cfg: SigLIPConfig):
    """Patch embedding + position embedding, interpolated when the patch
    grid is not the config's (JAX's siglip_forward)."""
    _, h, w, _ = pixels.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    x = patch_embed(pixels, ep["kernel"], ep["bias"], cfg.patch_size)
    pos = ep["pos"]
    if (gh, gw) != (cfg.grid, cfg.grid):
        pos = interpolate_pos(pos, cfg.grid, (gh, gw))
    return x + pos.to(pixels.dtype)


def probe_attention(x_q, x_kv, heads, d, in_w, in_b, logit_bias=None):
    """The single-query path of `_mha` up to the out-projection: x_q (B,
    1, W) attends over x_kv (B, S, W) through the fused input projection
    in_w (W, 3·heads·d) of `heads` heads of d, columns [q | k | v] →
    (B, 1, heads·d) in x_q's dtype. A tensor-parallel rank passes its own
    heads' columns (parallel/sharding.py)."""
    b, skv, w = x_kv.shape
    wq = heads * d
    q = (x_q[:, 0] @ in_w[:, :wq] + in_b[:wq]).reshape(b, heads, d)
    kv = x_kv.reshape(b * skv, w) @ in_w[:, wq:] + in_b[wq:]
    kv = kv.reshape(b, skv, 2, heads, d)
    k, v = kv[:, :, 0], kv[:, :, 1]                     # (B, S, H, d)
    logits = (torch.sum(k.float() * q.float()[:, None], dim=-1)
              * (d ** -0.5))
    if logit_bias is not None:
        logits = logits + logit_bias[:, :, None].float()
    probs = torch.softmax(logits, dim=1)                # over S
    o = torch.sum(v.float() * probs[..., None], dim=1)
    return o.reshape(b, 1, wq).to(x_q.dtype)


def _mha(x_q, x_kv, heads, in_w, in_b, out_w, out_b, *, logit_bias=None,
         kernels: KernelSet = KERNELS):
    """Multi-head attention with the fused (W, 3W) input projection
    (columns [q | k | v]), JAX's `_mha`. x_q (B, Sq, W), x_kv (B, Skv, W).
    Sq == 1 (the MAP probe) takes the single-query path; otherwise the
    projections go to (B, H, S, d) and, without a logit bias, through
    kernel 11 (`kernels.attention`); with one, through the plain softmax,
    as JAX sends it to XLA. logit_bias: optional (B, Skv) per-key bias."""
    b, sq, w = x_q.shape
    skv = x_kv.shape[1]
    d = w // heads
    if sq == 1:
        o = probe_attention(x_q, x_kv, heads, d, in_w, in_b, logit_bias)
        return o @ out_w + out_b

    def heads_first(t, n):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    q = heads_first(x_q @ in_w[:, :w] + in_b[:w], sq)
    k = heads_first(x_kv @ in_w[:, w:2 * w] + in_b[w:2 * w], skv)
    v = heads_first(x_kv @ in_w[:, 2 * w:] + in_b[2 * w:], skv)
    if logit_bias is None:
        o = kernels.attention(q, k, v)
    else:
        logits = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
                  * (d ** -0.5) + logit_bias[:, None, None, :].float())
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                         v.float()).to(v.dtype)
    o = o.transpose(1, 2).reshape(b, sq, w)
    return o @ out_w + out_b


def map_head(tokens, hp, cfg: SigLIPConfig, logit_bias=None,
             kernels: KernelSet = KERNELS):
    """MAP (attention-pooling) head: the probe attends over the tokens, then
    LN + MLP residual. logit_bias weights merged tokens by size."""
    b = tokens.shape[0]
    dt = tokens.dtype
    probe = hp["probe"][None].to(dt).expand(b, 1, cfg.width)
    h = _mha(probe, tokens, cfg.heads, hp["in_w"].to(dt), hp["in_b"].to(dt),
             hp["out_w"].to(dt), hp["out_b"].to(dt), logit_bias=logit_bias,
             kernels=kernels)
    res = h
    h = layer_norm(h, hp["ln"], cfg.ln_eps, kernels)
    h = gelu_tanh(h @ hp["fc1_w"].to(dt) + hp["fc1_b"].to(dt))
    h = res + (h @ hp["fc2_w"].to(dt) + hp["fc2_b"].to(dt))
    return h[:, 0]


def _float_block(x, bp, cfg: SigLIPConfig, logit_bias, kernels):
    """Float block (JAX `_block_apply_impl`, unquantized): K13 with LN1 →
    K9 → K13 with the residual → K14."""
    d = cfg.head_dim
    qkv_w, qkv_b = bp["attn"]["qkv_w"], bp["attn"]["qkv_b"]
    out_w = bp["attn"]["out_w"]
    scale, d_run = None, d
    if not (d % 128 == 0 or 128 % d == 0):
        # zero-pad each head's slot in the projection weights to a 128
        # multiple (so400m d=72 → 128), as the JAX tower does for its
        # lane-aligned kernel: padded dims add zero scores and outputs
        dp = ((d + 127) // 128) * 128
        scale = d ** -0.5          # keep the original softmax scale
        w_ = qkv_w.shape[0]
        qkv_w = F.pad(qkv_w.reshape(w_, 3, cfg.heads, d),
                      (0, dp - d)).reshape(w_, 3 * cfg.heads * dp)
        qkv_b = F.pad(qkv_b.reshape(3, cfg.heads, d),
                      (0, dp - d)).reshape(-1)
        out_w = F.pad(out_w.reshape(cfg.heads, d, w_),
                      (0, 0, 0, dp - d)).reshape(cfg.heads * dp, w_)
        d_run = dp
    qkv = kernels.linear_fused(x, qkv_w, qkv_b,
                               ln=(bp["ln1"]["scale"], bp["ln1"]["bias"]),
                               eps=cfg.ln_eps)
    o = attention_qkv_vjp(qkv, cfg.heads, d_run, scale,
                          fwd=kernels.attention_qkv,
                          bwd=kernels.attention_qkv_bwd,
                          logit_bias=logit_bias,
                          jax_head_dim=None if d_run == d else d)
    x = kernels.linear_fused(o, out_w, bp["attn"]["out_b"], residual=x)
    return kernels.mlp_block_fused(x, bp["ln2"], bp["mlp"], cfg.ln_eps)


def _with_sumsq(out):
    o32 = out.float()
    return out, torch.sum(o32 * o32, dim=-1)


def _kernel_heads(cfg: SigLIPConfig):
    """(head_dim as the kernels see it, softmax scale): a head_dim that is
    not lane-aligned (so400m's 72) is zero-padded to a 128 multiple and
    keeps its own scale, 72^-0.5; an aligned one runs as it is (None)."""
    d = cfg.head_dim
    if d % 128 == 0 or 128 % d == 0:
        return d, None
    return ((d + 127) // 128) * 128, d ** -0.5


def _aligned_quant_block(bp, cfg: SigLIPConfig):
    """One quantised layer (static or dynamic) as the kernels take it:
    each head's slot zero-padded to `_kernel_heads` and the MLP hidden to a
    128 multiple (so400m: 72 → 128, 4304 → 4352), the pads of
    `quant.prepad_siglip_static`. A tree quantised with cfg is padded
    already and passes unchanged; one quantised without cfg is padded here,
    in the graph, as JAX's static branch keeps un-prepadded trees working
    (tpudf/models/siglip.py:375-431). Exact algebra: padded columns are
    exactly 0."""
    d_run, _ = _kernel_heads(cfg)
    if (bp["attn"]["qkv_w"]["q"].shape[-1] == 3 * cfg.heads * d_run
            and bp["mlp"]["fc1_w"]["q"].shape[-1] % 128 == 0):
        return bp
    one = tree_map(lambda a: a[None], bp)
    return tree_map(lambda a: a[0],
                    prepad_siglip_static({"blocks": one}, cfg)["blocks"])


def _dynamic_int8_block(x, bp, cfg: SigLIPConfig, logit_bias, kernels):
    """quantize_siglip without act_scales: per-row dynamic activation
    scales on the four projections (quant.int8_matmul, XLA in JAX), the
    attention through K9 and the layer norms through K4. At so400m the
    heads run padded to 128 with scale 72^-0.5 and the MLP at 4352
    (`_aligned_quant_block`): the padded columns of qkv, o and the hidden
    are exactly 0, so each row's dynamic scale is JAX's, whose dynamic
    branch runs the unpadded geometry through XLA."""
    cdt = x.dtype
    bp = _aligned_quant_block(bp, cfg)
    d_run, attn_scale = _kernel_heads(cfg)
    attn, mlp_p = bp["attn"], bp["mlp"]

    def mm(a, wq):
        return int8_matmul(a, wq, a.dtype, acc=kernels.int8_acc)

    h = layer_norm(x, bp["ln1"], cfg.ln_eps, kernels)
    qkv = mm(h, attn["qkv_w"]) + attn["qkv_b"].to(cdt)
    o = kernels.attention_qkv(qkv, cfg.heads, d_run, attn_scale,
                              logit_bias=logit_bias)
    x = x + (mm(o, attn["out_w"]) + attn["out_b"].to(cdt))
    h = layer_norm(x, bp["ln2"], cfg.ln_eps, kernels)
    h = gelu_tanh(mm(h, mlp_p["fc1_w"]) + mlp_p["fc1_b"].to(cdt))
    return x + (mm(h, mlp_p["fc2_w"]) + mlp_p["fc2_b"].to(cdt))


def _static_int8_block(x, bp, cfg: SigLIPConfig, logit_bias, emit_sumsq,
                       kernels):
    """JAX `_block_apply_impl`'s static-W8A8 branch. TPUDF_INT8_KERNELS
    (default FPP, read per block as JAX reads it) picks each sublayer's
    route: first letter F = K1, P = K5, X = K8 + int8_matmul_pre; second
    (after P or X) P = K6, X = K9 + int8_matmul_static; third P = K2, X =
    K8 + int8_matmul_pre + GELU + int8_matmul_static. LLL runs K7, the
    whole layer, where `layer_int8_eligible` holds and there is no logit
    bias; otherwise FPP. JAX's wrappers decide from the shapes as well:
    F where `attn_sublayer_int8_fits` is false runs K5 then the P
    attention, and P's `attn_out_int8` takes its reference route (K9, or
    9b under TPUDF_INT8_ATTN=1, + the out-projection) where its own
    predicate fails (so400m-512) or a logit bias is present. The X routes
    keep JAX's dtypes: the vectors are cast to the compute dtype before
    their adds, and int8_matmul_pre rounds to bf16 before the bias."""
    bp = _aligned_quant_block(bp, cfg)
    sc = bp["act_scales"]
    heads = cfg.heads
    d, attn_scale = _kernel_heads(cfg)
    attn, mlp_p = bp["attn"], bp["mlp"]
    cdt = x.dtype
    variant = os.environ.get("TPUDF_INT8_KERNELS", "FPP")
    if variant == "LLL":
        if layer_int8_eligible(x, bp, heads, d, logit_bias):
            out = kernels.siglip_layer_int8(x, bp, heads, d, cfg.ln_eps,
                                            attn_scale)
            return _with_sumsq(out) if emit_sumsq else out
        variant = "FPP"
    b, s, w = x.shape
    if variant[0] == "F" and not attn_sublayer_int8_fits(b, s, w, heads * d,
                                                         d):
        variant = "PP" + variant[2]
    if variant[0] == "F":
        x = kernels.attn_sublayer_int8(
            x, bp["ln1"], attn["qkv_w"], attn["qkv_b"], attn["out_w"],
            attn["out_b"], sc["qkv"], sc["out"], heads, d, cfg.ln_eps,
            attn_scale, logit_bias=logit_bias,
            live=None if d == cfg.head_dim else cfg.head_dim)
    else:
        if variant[0] == "P":
            qkv = kernels.ln_qkv_int8(x, bp["ln1"], attn["qkv_w"],
                                      attn["qkv_b"], sc["qkv"], cfg.ln_eps)
        else:
            hq = kernels.layer_norm_quant(x, bp["ln1"]["scale"],
                                          bp["ln1"]["bias"], sc["qkv"],
                                          cfg.ln_eps)
            qkv = (int8_matmul_pre(hq, attn["qkv_w"], sc["qkv"],
                                   acc=kernels.int8_acc)
                   + attn["qkv_b"].to(cdt)).to(cdt)
        if variant[1] == "P":
            x = kernels.attn_out_int8(qkv, x, attn["out_w"], attn["out_b"],
                                      sc["out"], heads, d, attn_scale,
                                      logit_bias=logit_bias)
        else:
            o = kernels.attention_qkv(qkv, heads, d, attn_scale,
                                      logit_bias=logit_bias)
            x = x + (int8_matmul_static(o, attn["out_w"], sc["out"],
                                        acc=kernels.int8_acc)
                     + attn["out_b"].to(cdt))
    if variant[2] == "P":
        return kernels.mlp_block_fused_int8(
            x, bp["ln2"], mlp_p, {"fc1": sc["fc1"], "fc2": sc["fc2"]},
            cfg.ln_eps, emit_sumsq=emit_sumsq)
    hq = kernels.layer_norm_quant(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                  sc["fc1"], cfg.ln_eps)
    h = gelu_tanh(int8_matmul_pre(hq, mlp_p["fc1_w"], sc["fc1"],
                                  acc=kernels.int8_acc)
                  + mlp_p["fc1_b"].to(cdt))
    out = x + (int8_matmul_static(h, mlp_p["fc2_w"], sc["fc2"],
                                  acc=kernels.int8_acc)
               + mlp_p["fc2_b"].to(cdt))
    return _with_sumsq(out) if emit_sumsq else out


def _block_apply(x, bp, cfg: SigLIPConfig, logit_bias=None, emit_sumsq=False,
                 kernels: KernelSet = KERNELS):
    """One tower block. emit_sumsq=True → (out, (B, S) Σ out²) for the ToMe
    merge that follows: from K2's epilogue on the P-MLP routes, else from
    the bf16 output, as JAX's `_block_apply` does."""
    if is_static_quantized(bp):
        return _static_int8_block(x, bp, cfg, logit_bias, emit_sumsq,
                                  kernels)
    if is_quantized(bp):
        out = _dynamic_int8_block(x, bp, cfg, logit_bias, kernels)
    else:
        out = _float_block(x, bp, cfg, logit_bias, kernels)
    return _with_sumsq(out) if emit_sumsq else out


def _compute_blocks(blocks, cdt):
    """The JAX tower casts every floating block leaf to the compute dtype
    in its graph. Float blocks are cast (no copy for leaves already in it,
    as `tower_params` leaves them) and their MLP hidden padded to a 128
    multiple (`_pad_float_mlp`, a no-op on `tower_params`' blocks): the
    trainer's f32 masters keep JAX's shapes, autograd slices the gradient
    of the padded copy back, and K14 takes the padded shapes (so400m-512:
    4304 → 4352), where JAX sends the unaligned hidden to its XLA
    `_reference`. Int8 blocks keep f32 vectors, rounded through the
    compute dtype, because their kernels read f32."""
    if is_quantized(blocks):
        return round_tree(blocks, cdt)
    return _pad_float_mlp(cast_tree(blocks, cdt))


def _pad_float_mlp(blocks):
    """The float blocks' MLP hidden zero-padded to a 128 multiple (so400m:
    4304 → 4352): fc1 columns, fc1 bias and fc2 rows. Exact algebra, the
    pad of JAX's int8 prepad: the padded hidden units are gelu(0) = 0 and
    the zero fc2 rows ignore them; K14's GEMMs take the padded shapes."""
    m = blocks["mlp"]
    inter = m["fc1_w"].shape[-1]
    if inter % 128 == 0:
        return blocks
    pad = ((inter + 127) // 128) * 128 - inter
    return {**blocks, "mlp": {
        "fc1_w": F.pad(m["fc1_w"], (0, pad)),
        "fc1_b": F.pad(m["fc1_b"], (0, pad)),
        "fc2_w": F.pad(m["fc2_w"], (0, 0, 0, pad)),
        "fc2_b": m["fc2_b"]}}


def tower_params(params, cdt):
    """What `siglip_forward` reads, derived once (at engine build): float
    blocks cast to the compute dtype with their MLP hidden padded to a 128
    multiple (`_pad_float_mlp`), int8 blocks with the kernel layout. The
    outputs are those of the tree as given. The trainer's float blocks do
    not come through here: `_compute_blocks` pads their compute copy in
    the graph each step."""
    blocks = params["blocks"]
    if is_quantized(blocks):
        blocks = add_kernel_layout(blocks)
    else:
        blocks = cast_tree(_pad_float_mlp(blocks), cdt)
    return {**params, "blocks": blocks}


def siglip_forward(params, pixels, cfg: SigLIPConfig,
                   policy: Policy = DEFAULT_POLICY, *,
                   output_hidden_states: bool = False,
                   stop_grad_below: int = 0, frozen_blocks_q=None,
                   tome_r: int = 0, tome_floor: int = 0,
                   kernels: KernelSet = KERNELS):
    """Run the vision tower on (B, H, W, 3) SigLIP-normalised NHWC pixels.

    Returns {"tokens": (B, N', W), "pooled": (B, W)}; with ToMe also
    "sizes": (B, N'); with output_hidden_states also "hidden_states", the
    embedding output and then each block's output (HF order). tome_r
    merges that many token pairs between blocks (ops/tome.py; serving
    only); tome_floor is the smallest token count the schedule may reach
    (0 → S/4; the deployed engine passes deployed_floor = S/8).

    stop_grad_below=k: the embeddings and layers < k run without autograd,
    so their outputs and taps carry no gradient (JAX's stop_gradient at the
    freeze boundary). frozen_blocks_q: a static-W8A8 block tree of exactly
    those k layers (train/mtl.quantize_frozen_prefix), run on K1/K2 in
    their place. The serving callers run under torch.no_grad().

    cfg.remat: each block that runs with autograd is recomputed in the
    backward (`torch.utils.checkpoint`, non-reentrant), as JAX wraps the
    block in `jax.checkpoint`: activation memory for one more forward of
    each block (its kernels launch twice).

    A tree that `parallel.sharding.shard_siglip_params` split by heads
    (its "tp" entry) runs the tensor-parallel tower on this rank's heads
    (`tp_siglip_forward`)."""
    if "tp" in params:
        from tpudf_torch.parallel.sharding import tp_siglip_forward
        if tome_r or output_hidden_states or stop_grad_below:
            raise ValueError("the tensor-parallel tower runs without ToMe, "
                             "hidden states or a frozen prefix")
        return tp_siglip_forward(params, pixels, cfg, policy, kernels)
    cdt = policy.compute_dtype
    k = max(0, min(int(stop_grad_below), cfg.layers))
    if tome_r and (output_hidden_states or k):
        raise ValueError("tome_r is an inference-only speed mode: "
                         "incompatible with hidden_states/training")
    lo = None
    if k and frozen_blocks_q is not None:
        # the quantized prefix must cover exactly the k frozen layers, or
        # layers would run twice or not at all with no error
        n_frozen = frozen_blocks_q["ln1"]["scale"].shape[0]
        if n_frozen != k:
            raise ValueError(
                f"frozen_blocks_q holds {n_frozen} layers but "
                f"stop_grad_below={k}; quantize_frozen_prefix and the train "
                "step must use the same freeze boundary")
        lo = _compute_blocks(frozen_blocks_q, cdt)
    grad = torch.is_grad_enabled()
    with torch.set_grad_enabled(grad and not k):
        x = embed(params["embed"], pixels.to(cdt), cfg)
    hidden = [x] if output_hidden_states else None
    blocks = _compute_blocks(params["blocks"], cdt)

    sizes = None
    if tome_r:
        floor = int(tome_floor) if tome_floor else max(8, x.shape[1] // 4)
        sched = merge_schedule(x.shape[1], cfg.layers, int(tome_r),
                               min_tokens=floor)
        sizes = torch.ones(x.shape[:2], dtype=torch.float32,
                           device=x.device)
    for i in range(cfg.layers):
        bp = layer_slice(blocks if lo is None or i >= k else lo, i)
        lb = None if (sizes is None or i == 0) else torch.log(sizes)
        merging = sizes is not None and i < cfg.layers - 1 and sched[i] > 0
        with torch.set_grad_enabled(grad and i >= k):
            if cfg.remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(
                    _block_apply, x, bp, cfg, lb, merging, kernels,
                    use_reentrant=False)
            else:
                out = _block_apply(x, bp, cfg, lb, emit_sumsq=merging,
                                   kernels=kernels)
        if merging:
            x, sumsq = out
            x, sizes = merge_step(x, sizes, sched[i], sumsq=sumsq)
        else:
            x = out
        if hidden is not None:
            hidden.append(x)
    tokens = layer_norm(x, params["post_ln"], cfg.ln_eps, kernels)
    out = {"tokens": tokens}
    if sizes is not None:
        out["sizes"] = sizes
    if hidden is not None:
        out["hidden_states"] = tuple(hidden)
    if cfg.with_head and "head" in params:
        out["pooled"] = map_head(
            tokens, params["head"], cfg,
            logit_bias=None if sizes is None else torch.log(sizes),
            kernels=kernels)
    return out
