"""Megatron-style tensor parallelism of the SigLIP tower over the mesh's
model axis (tpudf/parallel/sharding.py), as a per-rank split.

`siglip_param_spec` names each leaf's rule; `shard_siglip_params` gives
a rank its part of the tree:
  * qkv_w / qkv_b (the blocks) and in_w / in_b (the MAP head): split by
    heads INSIDE each of q, k and v. The fused axis is laid out [3, H, d]
    (models/siglip.py), so rank i of m keeps heads [i·H/m, (i+1)·H/m) of
    q, of k and of v, in that layout. (The JAX spec's P(None, None, m) on
    the fused 3W axis is a layout under global semantics; a contiguous
    split of it would give rank 0 all of q and half of k.)
  * out_w and fc2_w: split by rows (the heads', the hidden units');
    fc1_w / fc1_b: by columns; every other leaf is replicated.
A head_dim that is not lane-aligned (so400m's 72) is zero-padded to the
kernels' width (128) and the MLP hidden to a 128 multiple (4304 → 4352),
as the single-process tower pads them in its graph; the split comes after
the padding.

`tp_siglip_forward` runs the tower on a rank's part (models/siglip.py
dispatches to it). A block on each rank:
  1. K13 with LN1 on the local QKV columns;
  2. K9 over H/m heads;
  3. K13 for the out-projection on the local rows, without bias or
     residual; an all-reduce (f32) over the model group; then the bias
     and the residual once;
  4. K13 with LN2 + fc1 + GELU on the local columns, K13 for fc2 on the
     local rows, an all-reduce, the bias and the residual. (K14 fuses the
     residual into fc2, so the split block cannot use it.)
The MAP head's probe attention splits its heads the same way; its
out-projection and MLP follow steps 3 and 4 with plain products (a single
query: no kernel, as in the single-process tower). The embedding, the
layer norms outside K13 and the head's LN run replicated on every rank.
Under autograd the all-reduces are Megatron's f / g (parallel/dist.py):
f at each column-parallel input (the activations, LN1 / LN2's scale and
bias that K13 fuses, the probe), g at each row-parallel output.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpudf_torch.core.mesh import Mesh
from tpudf_torch.core.precision import cast_tree, tree_map
from tpudf_torch.ops.attention import attention_qkv_vjp
from tpudf_torch.ops.quant import is_quantized
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.parallel.dist import (all_gather, broadcast, copy_to_model,
                                       reduce_from_model)

REPLICATED, QKV, COLS, ROWS = "replicated", "qkv", "cols", "rows"


def siglip_param_spec(tensor_parallel: bool = True):
    """The split rule of every leaf of a SigLIP tree (blocks stacked on a
    leading L axis, which is never split)."""
    r = REPLICATED
    qkv, cols, rows = ((QKV, COLS, ROWS) if tensor_parallel
                       else (r, r, r))
    ln = {"scale": r, "bias": r}
    return {
        "embed": {"kernel": r, "bias": r, "pos": r},
        "blocks": {
            "ln1": ln,
            "attn": {"qkv_w": qkv, "qkv_b": qkv, "out_w": rows,
                     "out_b": r},
            "ln2": ln,
            "mlp": {"fc1_w": cols, "fc1_b": cols, "fc2_w": rows,
                    "fc2_b": r},
        },
        "post_ln": ln,
        "head": {"probe": r, "in_w": qkv, "in_b": qkv, "out_w": rows,
                 "out_b": r, "ln": ln, "fc1_w": cols, "fc1_b": cols,
                 "fc2_w": rows, "fc2_b": r},
    }


def _prune_to(tree, like):
    """Keep only the keys present in `like` (e.g. headless param trees)."""
    if isinstance(like, dict):
        return {k: _prune_to(tree[k], v) for k, v in like.items()}
    return tree


def named_shardings(mesh: Mesh, spec_tree, params):
    """The rule of each leaf of `params` (the spec pruned to its keys)."""
    return _prune_to(spec_tree, params)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """What a rank's tower needs besides its weights: the model group and
    its size, the heads this rank holds, their width as the kernels run
    them and the softmax scale (None: head_dim^-0.5), and the config's
    head_dim where it was padded (K10's route)."""
    group: Any
    parts: int
    heads: int
    head_dim: int
    scale: float | None
    jax_head_dim: int | None


def _split(a, rule, parts, index, heads):
    if rule == REPLICATED or parts == 1:
        return a
    if rule == QKV:
        d = a.shape[-1] // (3 * heads)
        hl = heads // parts
        v = a.reshape(*a.shape[:-1], 3, heads, d)
        return v[..., index * hl:(index + 1) * hl, :].reshape(
            *a.shape[:-1], 3 * hl * d).contiguous()
    dim = -1 if rule == COLS else -2
    return a.chunk(parts, dim=dim)[index].contiguous()


def _padded_blocks(blocks, cfg):
    """Each head's slot zero-padded to the kernels' width and the MLP
    hidden to a 128 multiple (exact algebra: the pads are zeros that add
    nothing), as `siglip._float_block` and `_pad_float_mlp` pad them."""
    from tpudf_torch.models.siglip import _kernel_heads, _pad_float_mlp
    blocks = _pad_float_mlp(blocks)
    d, (dp, _) = cfg.head_dim, _kernel_heads(cfg)
    if dp == d:
        return blocks
    a = blocks["attn"]
    lead = a["qkv_w"].shape[:-1]
    w = a["out_w"].shape[-1]
    return {**blocks, "attn": {
        "qkv_w": F.pad(a["qkv_w"].reshape(*lead, 3, cfg.heads, d),
                       (0, dp - d)).reshape(*lead, 3 * cfg.heads * dp),
        "qkv_b": F.pad(a["qkv_b"].reshape(-1, 3, cfg.heads, d),
                       (0, dp - d)).reshape(-1, 3 * cfg.heads * dp),
        "out_w": F.pad(a["out_w"].reshape(-1, cfg.heads, d, w),
                       (0, 0, 0, dp - d)).reshape(-1, cfg.heads * dp, w),
        "out_b": a["out_b"]}}


def _map_rules(fn, tree, rules):
    if isinstance(tree, dict):
        return {k: _map_rules(fn, v, rules[k]) for k, v in tree.items()}
    return fn(tree, rules)


def split_siglip_tree(params, cfg, parts: int, index: int):
    """Rank `index` of `parts`' part of a float SigLIP tree (or of a tree
    of the same shapes, such as its gradients), after the padding of
    `_padded_blocks`. No collective."""
    if cfg.heads % parts:
        raise ValueError(f"{cfg.heads} heads do not split over {parts} "
                         "ranks")
    params = {**params, "blocks": _padded_blocks(params["blocks"], cfg)}
    rules = _prune_to(siglip_param_spec(True), params)
    return _map_rules(
        lambda a, rule: _split(a, rule, parts, index, cfg.heads),
        params, rules)


def replicate_tree(mesh: Mesh, params):
    """Every tensor leaf on this rank's device with rank 0's values (a
    broadcast over the world)."""
    return tree_map(lambda a: broadcast(torch.as_tensor(a).to(mesh.device))
                    if torch.is_tensor(a) else a, params)


def shard_siglip_params(mesh: Mesh, params, tensor_parallel: bool = True,
                        cfg=None):
    """This rank's part of a float SigLIP tree: rank 0's values (a
    broadcast), padded and split by `siglip_param_spec`, with the "tp"
    entry the tower reads. Without tensor parallelism, or on a model axis
    of 1, the whole tree (`replicate_tree`)."""
    params = replicate_tree(mesh, params)
    if not tensor_parallel or mesh.model == 1:
        return params
    if cfg is None:
        raise ValueError("the tensor-parallel split needs the SigLIP "
                         "config (its heads)")
    if is_quantized(params["blocks"]):
        raise ValueError("tensor parallelism splits the float tower; an "
                         "int8 tree runs data-parallel")
    from tpudf_torch.models.siglip import _kernel_heads
    dp, scale = _kernel_heads(cfg)
    out = split_siglip_tree(params, cfg, mesh.model, mesh.model_index)
    out["tp"] = TPShard(mesh.model_group, mesh.model,
                        cfg.heads // mesh.model, dp, scale,
                        None if dp == cfg.head_dim else cfg.head_dim)
    return out


def _gather_rule(a, rule, tp: TPShard, heads):
    if rule == REPLICATED:
        return a
    parts = all_gather(a[None], tp.group)          # (m, ...)
    if rule == QKV:
        hl = heads // tp.parts
        d = a.shape[-1] // (3 * hl)
        v = parts.reshape(tp.parts, *a.shape[:-1], 3, hl, d)
        v = v.movedim(0, -3)                         # (..., 3, m, hl, d)
        return v.reshape(*a.shape[:-1], 3 * heads * d)
    dim = -1 if rule == COLS else -2
    return torch.cat(list(parts), dim=dim)


def unshard_siglip_params(params, cfg):
    """The whole tree from the model group's parts (an all-gather), with
    the padding taken off: the inverse of `shard_siglip_params`."""
    if "tp" not in params:
        return params
    tp = params["tp"]
    tree = {k: v for k, v in params.items() if k != "tp"}
    rules = _prune_to(siglip_param_spec(True), tree)
    full = _map_rules(lambda a, rule: _gather_rule(a, rule, tp, cfg.heads),
                      tree, rules)
    if tp.jax_head_dim is not None:
        d, dp, h = cfg.head_dim, tp.head_dim, cfg.heads
        a = full["blocks"]["attn"]
        lead = a["qkv_w"].shape[:-1]
        w = a["out_w"].shape[-1]
        a["qkv_w"] = a["qkv_w"].reshape(*lead, 3, h, dp)[..., :d].reshape(
            *lead, 3 * h * d)
        a["qkv_b"] = a["qkv_b"].reshape(-1, 3, h, dp)[..., :d].reshape(
            -1, 3 * h * d)
        a["out_w"] = a["out_w"].reshape(-1, h, dp, w)[:, :, :d].reshape(
            -1, h * d, w)
    m = full["blocks"]["mlp"]
    if m["fc1_w"].shape[-1] != cfg.mlp_dim:
        i = cfg.mlp_dim
        m["fc1_w"], m["fc1_b"] = m["fc1_w"][..., :i], m["fc1_b"][..., :i]
        m["fc2_w"] = m["fc2_w"][..., :i, :]
    return full


# ---------------------------------------------------------------- forward

def _row_out(part, bias, residual, group):
    """A row-parallel product's partial sum, all-reduced in f32, plus the
    bias and the residual once, in the residual's dtype."""
    y = reduce_from_model(part.float(), group)
    return (y + bias.float() + residual.float()).to(residual.dtype)


def _tp_block(x, bp, cfg, tp: TPShard, kernels: KernelSet):
    g = tp.group
    attn, mlp = bp["attn"], bp["mlp"]

    def ln(p):
        return copy_to_model(p["scale"], g), copy_to_model(p["bias"], g)

    qkv = kernels.linear_fused(copy_to_model(x, g), attn["qkv_w"],
                               attn["qkv_b"], ln=ln(bp["ln1"]),
                               eps=cfg.ln_eps)
    o = attention_qkv_vjp(qkv, tp.heads, tp.head_dim, tp.scale,
                          fwd=kernels.attention_qkv,
                          bwd=kernels.attention_qkv_bwd,
                          jax_head_dim=tp.jax_head_dim)
    x = _row_out(kernels.linear_fused(o, attn["out_w"], None),
                 attn["out_b"], x, g)
    h = kernels.linear_fused(copy_to_model(x, g), mlp["fc1_w"],
                             mlp["fc1_b"], ln=ln(bp["ln2"]),
                             activation="gelu", eps=cfg.ln_eps)
    return _row_out(kernels.linear_fused(h, mlp["fc2_w"], None),
                    mlp["fc2_b"], x, g)


def _tp_map_head(tokens, hp, cfg, tp: TPShard, kernels: KernelSet):
    from tpudf_torch.models.siglip import layer_norm, probe_attention
    from tpudf_torch.utils.nn import gelu_tanh
    g = tp.group
    b, dt = tokens.shape[0], tokens.dtype
    probe = copy_to_model(hp["probe"], g)[None].to(dt).expand(
        b, 1, cfg.width)
    o = probe_attention(probe, copy_to_model(tokens, g), tp.heads,
                        cfg.head_dim, hp["in_w"].to(dt), hp["in_b"].to(dt))
    h = _row_out(o @ hp["out_w"].to(dt), hp["out_b"].to(dt),
                 torch.zeros((), dtype=dt, device=o.device), g)
    res = h
    h = layer_norm(h, hp["ln"], cfg.ln_eps, kernels)
    h = gelu_tanh(copy_to_model(h, g) @ hp["fc1_w"].to(dt)
                  + hp["fc1_b"].to(dt))
    h = _row_out(h @ hp["fc2_w"].to(dt), hp["fc2_b"].to(dt), res, g)
    return h[:, 0]


def tp_siglip_forward(params, pixels, cfg, policy,
                      kernels: KernelSet = KERNELS):
    """The tower on this rank's part (`shard_siglip_params`): the
    embedding replicated, each block split as the module docstring says,
    the post-LN replicated, the MAP head split by heads. Returns
    {"tokens", "pooled"} like `siglip_forward`, whole on every rank."""
    from tpudf_torch.models.siglip import embed, layer_norm, layer_slice
    tp = params["tp"]
    cdt = policy.compute_dtype
    x = embed(params["embed"], pixels.to(cdt), cfg)
    blocks = cast_tree(params["blocks"], cdt)
    for i in range(cfg.layers):
        bp = layer_slice(blocks, i)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _tp_block, x, bp, cfg, tp, kernels, use_reentrant=False)
        else:
            x = _tp_block(x, bp, cfg, tp, kernels)
    tokens = layer_norm(x, params["post_ln"], cfg.ln_eps, kernels)
    out = {"tokens": tokens}
    if cfg.with_head and "head" in params:
        out["pooled"] = _tp_map_head(tokens, params["head"], cfg, tp,
                                     kernels)
    return out
