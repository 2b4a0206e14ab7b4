"""The SigLIP vision tower (Zhai et al. 2023; Hugging Face
SiglipVisionModel) in f32: patch embedding, pre-LN blocks (fused qkv
projection, softmax attention, tanh-GELU MLP), post-LN, the MAP
attention-pooling head. Two forms:

- `w8a8_tower`: static W8A8 (per-column int8 weights, one calibrated
  per-tensor activation scale per projection and layer, `calibrate`),
  with ToMe between blocks (bipartite soft matching, size-weighted
  averages, log-size attention bias; Bolya et al. 2023);
- `float_tower`: every product in f32, optionally keeping the hidden
  states and with autograd only from a given layer up.

`cfg` is the configuration file's dict (Hugging Face key names).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (attention, codes, gelu_tanh,
                                        int_matmul, layer_norm,
                                        merge_heads, quant_weight,
                                        split_heads, ste)

TOME_R = 96


def dims(cfg: dict) -> dict:
    return {"W": cfg["hidden_size"], "L": cfg["num_hidden_layers"],
            "H": cfg["num_attention_heads"], "P": cfg["patch_size"],
            "eps": cfg["layer_norm_eps"]}


def layer(blocks, i):
    """Layer i of the stacked block tree, in f32."""
    if isinstance(blocks, dict):
        return {k: layer(v, i) for k, v in blocks.items()}
    return blocks[i].float()


def embed(ep, x, cfg: dict, prec):
    """(B, S, S, 3) normalised pixels → (B, N, W) patch embeddings plus
    positions."""
    b, s, _, c = x.shape
    p = cfg["patch_size"]
    g = s // p
    if g * g != ep["pos"].shape[0]:
        raise ValueError(f"the reference runs the configuration's own "
                         f"image size, not {s}")
    rows = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, g * g, p * p * c)
    return (ste(rows, prec.lowp) @ ste(ep["kernel"].float(), prec.lowp)
            + ep["bias"] + ep["pos"])


def tome_schedule(n: int, layers: int) -> list[int]:
    """Merges after each block but the last: TOME_R, clipped so the count stays
    >= max(8, n // 8) and a multiple of 8, and no more than half."""
    floor = max(8, n // 8)
    out, t = [], n
    for _ in range(layers - 1):
        ri = min(TOME_R, max(0, t - floor), t // 2)
        ri -= ri % 8
        out.append(ri)
        t -= ri
    return out


def merge(x, sizes, r: int):
    """One bipartite soft matching step: even tokens (A) each find their
    most cosine-similar odd token (B); the r A tokens with the highest
    such similarity are averaged, weighted by size, into their partners.
    Survivors: every B token, then the unmerged A tokens in order."""
    b, s, w = x.shape
    a_tok, b_tok = x[:, 0::2], x[:, 1::2]
    an = a_tok / a_tok.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    bn = b_tok / b_tok.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    best, partner = (an @ bn.transpose(1, 2)).max(dim=-1)
    order = torch.sort(best, dim=-1, descending=True, stable=True)[1]
    ha, hb = a_tok.shape[1], b_tok.shape[1]
    merged = torch.zeros((b, ha), dtype=torch.bool, device=x.device)
    merged.scatter_(1, order[:, :r], True)
    rank = torch.cumsum((~merged).long(), dim=1) - 1
    dest_a = torch.where(merged, partner, hb + rank)
    dest = torch.empty((b, s), dtype=torch.long, device=x.device)
    dest[:, 0::2] = dest_a
    dest[:, 1::2] = torch.arange(hb, device=x.device)
    num = torch.zeros((b, s - r, w), device=x.device).scatter_add_(
        1, dest[..., None].expand(b, s, w), x * sizes[..., None])
    den = torch.zeros((b, s - r), device=x.device).scatter_add_(
        1, dest, sizes)
    return num / den[..., None], den


@torch.no_grad()
def calibrate(params, x, cfg: dict):
    """The abs-max (at least 1e-3) of each projection's input per layer
    over the float tower on the calibration images x (normalised):
    {"qkv", "out", "fc1", "fc2"} of (L,) f32."""
    from benchmark.reference.common import SOUND
    d = dims(cfg)
    h = embed(params["embed"], x.float(), cfg, SOUND)
    out = {"qkv": [], "out": [], "fc1": [], "fc2": []}

    def amax(t):
        return t.abs().amax().clamp(min=1e-3)

    for i in range(d["L"]):
        bp = layer(params["blocks"], i)
        a = layer_norm(h, bp["ln1"], d["eps"])
        out["qkv"].append(amax(a))
        qkv = a @ bp["attn"]["qkv_w"] + bp["attn"]["qkv_b"]
        o = _attn(qkv, d["H"], None)
        out["out"].append(amax(o))
        h = h + o @ bp["attn"]["out_w"] + bp["attn"]["out_b"]
        a = layer_norm(h, bp["ln2"], d["eps"])
        out["fc1"].append(amax(a))
        g = gelu_tanh(a @ bp["mlp"]["fc1_w"] + bp["mlp"]["fc1_b"])
        out["fc2"].append(amax(g))
        h = h + g @ bp["mlp"]["fc2_w"] + bp["mlp"]["fc2_b"]
    return {k: torch.stack(v) for k, v in out.items()}


def _attn(qkv, heads, bias):
    w = qkv.shape[-1] // 3
    q, k, v = (split_heads(qkv[..., j * w:(j + 1) * w], heads)
               for j in range(3))
    return merge_heads(attention(q, k, v, (w // heads) ** -0.5, bias))


def quantize_blocks(blocks, levels: int):
    """The blocks' four projection weights as (codes, scales)."""
    return {name: quant_weight(w.float(), levels) for name, w in (
        ("qkv", blocks["attn"]["qkv_w"]), ("out", blocks["attn"]["out_w"]),
        ("fc1", blocks["mlp"]["fc1_w"]), ("fc2", blocks["mlp"]["fc2_w"]))}


@torch.no_grad()
def w8a8_tower(params, scales, qweights, x, cfg: dict, prec):
    """(B, S, S, 3) normalised pixels → (tokens after the post-LN, their
    sizes) with ToMe on the deployed schedule. scales: `calibrate`'s; qweights: `quantize_blocks` at
    prec.levels. Each projection's input is coded with its scale, the
    codes multiplied exactly, the sum scaled back."""
    d = dims(cfg)
    lv = prec.levels
    h = prec.lowp(embed(params["embed"], x.float(), cfg, prec))
    sizes = torch.ones(h.shape[:2], device=h.device)
    sched = tome_schedule(h.shape[1], d["L"])

    def proj(a, name, i, bias):
        amax = scales[name][i]
        wc, ws = qweights[name][0][i], qweights[name][1][i]
        return int_matmul(codes(a, amax, lv), wc) * (amax / lv) * ws + bias

    for i in range(d["L"]):
        bp = layer(params["blocks"], i)
        bias = torch.log(sizes) if i > 0 else None
        a = layer_norm(h, bp["ln1"], d["eps"])
        qkv = prec.lowp(proj(a, "qkv", i, bp["attn"]["qkv_b"]))
        h = prec.lowp(h + proj(_attn(qkv, d["H"], bias), "out", i,
                               bp["attn"]["out_b"]))
        a = layer_norm(h, bp["ln2"], d["eps"])
        g = gelu_tanh(proj(a, "fc1", i, bp["mlp"]["fc1_b"]))
        h = prec.lowp(h + proj(g, "fc2", i, bp["mlp"]["fc2_b"]))
        if i < d["L"] - 1 and sched[i]:
            h, sizes = merge(h, sizes, sched[i])
    return layer_norm(h, _f32(params["post_ln"]), d["eps"]), sizes


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def float_tower(params, x, cfg: dict, prec, *, hidden: bool = False,
                grad_from: int | None = None):
    """(B, S, S, 3) normalised pixels → (tokens after the post-LN, hidden
    states or None): every product in f32 (its operands rounded by
    prec.lowp), no ToMe. hidden: the embeddings' output and each block's
    (Hugging Face order). grad_from=k: the embeddings and layers < k run
    without autograd (a frozen prefix); None: autograd as the caller has
    it."""
    d = dims(cfg)
    grad = torch.is_grad_enabled()

    def mm(a, w):
        return ste(a, prec.lowp) @ ste(w, prec.lowp)

    with torch.set_grad_enabled(grad and not grad_from):
        h = embed(params["embed"], x.float(), cfg, prec)
    states = [h] if hidden else None
    for i in range(d["L"]):
        with torch.set_grad_enabled(grad and (grad_from is None
                                              or i >= grad_from)):
            bp = layer(params["blocks"], i)
            a = layer_norm(h, bp["ln1"], d["eps"])
            qkv = mm(a, bp["attn"]["qkv_w"]) + bp["attn"]["qkv_b"]
            h = h + mm(_attn(qkv, d["H"], None), bp["attn"]["out_w"]) \
                + bp["attn"]["out_b"]
            a = layer_norm(h, bp["ln2"], d["eps"])
            g = gelu_tanh(mm(a, bp["mlp"]["fc1_w"]) + bp["mlp"]["fc1_b"])
            h = h + mm(g, bp["mlp"]["fc2_w"]) + bp["mlp"]["fc2_b"]
        if hidden:
            states.append(h)
    return layer_norm(h, params["post_ln"], d["eps"]), states


def map_head(tokens, hp, cfg: dict, prec, bias=None):
    """The MAP head: a learned probe attends over the tokens (per-key
    bias: log sizes after ToMe), then LN and a tanh-GELU MLP with a
    residual → (B, W)."""
    d = dims(cfg)
    w = d["W"]
    b = tokens.shape[0]

    def mm(a, m):
        return ste(a, prec.lowp) @ ste(m, prec.lowp)

    q = (mm(hp["probe"], hp["in_w"][:, :w]) + hp["in_b"][:w]).reshape(1, 1, w)
    kv = mm(tokens, hp["in_w"][:, w:]) + hp["in_b"][w:]
    qh = split_heads(q.expand(b, 1, w), d["H"])
    o = attention(qh, split_heads(kv[..., :w], d["H"]),
                  split_heads(kv[..., w:], d["H"]), (w // d["H"]) ** -0.5,
                  bias)
    h = mm(merge_heads(o), hp["out_w"]) + hp["out_b"]
    a = layer_norm(h, hp["ln"], d["eps"])
    h = h + mm(gelu_tanh(mm(a, hp["fc1_w"]) + hp["fc1_b"]), hp["fc2_w"]) \
        + hp["fc2_b"]
    return h[:, 0]
