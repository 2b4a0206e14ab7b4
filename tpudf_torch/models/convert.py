"""Checkpoint conversion: HF / open_clip / reference-MTL state dicts → the
port's parameter tree (tpudf/models/convert.py on PyTorch tensors).

Published SigLIP weights come two ways: HF `SiglipVisionModel` state dicts
(`vision_model.encoder.layers.N.self_attn.q_proj.weight`, ...) and
open_clip / timm towers (`trunk.blocks.N.attn.qkv.weight`, ...); the
reference's multi-task checkpoints add a 3-class head and a SegFormer
decoder around an HF encoder. This module maps a plain `{name: array}`
dict of any of them, by name, onto the tree of `models/siglip.py`: f32 CPU
tensors in JAX's layout ((in, out) matmul weights, a (p·p·3, W) patch
kernel in (kh, kw, c) order, block leaves stacked on a leading L axis,
HWIO decoder convolutions). Each leaf is the source array, transposed as
JAX transposes it, bit for bit.

It differs from `tpudf_torch/convert.py`, the numpy bridge from JAX trees:
that one takes a tree already in the tpudf layout (a numpy copy of a JAX
pytree) and only turns its leaves into tensors; this one reads checkpoints
by their parameter names and builds the layout.

`.safetensors` files are read by the port's own reader
(`utils/safetensors_io.py`, numpy alone; BF16 tensors widen to f32), so
the card's machine, which has no `safetensors` package, reads them too.
`transformers` is imported only inside the branch that reads an HF hub
id; importing this module does not need it.

CLI: convert an HF model directory / `.safetensors` file / torch `.pt` or
`.bin` / open_clip checkpoint into the port's checkpoint (`params`, written
by `train/checkpoint.save_checkpoint`) and a `config.json` sidecar:

    python -m tpudf_torch.models.convert --src model.safetensors \\
        --out ckpts/siglip_large_384 [--kind auto|hf|open_clip|mtl]
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from tpudf_torch.core.precision import tree_map
from tpudf_torch.models.siglip import SigLIPConfig, _stack


def _np(x):
    """An f32 numpy array of a tensor (bf16 included) or array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(a):
    """An f32 CPU tensor of a numpy array (a transposed view is copied)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _strip_prefix(sd: Mapping) -> dict:
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(vision_model\.|visual\.|module\.)", "", k)
        # nested prefix e.g. "vision_model.vision_model."
        k = re.sub(r"^vision_model\.", "", k)
        out[k] = v
    return out


def _conv_kernel(conv, cfg: SigLIPConfig):
    """(W, 3, p, p) conv weight → (p·p·3, W) in (kh, kw, c) order."""
    p = cfg.patch_size
    return conv.transpose(2, 3, 1, 0).reshape(p * p * 3, cfg.width)


def config_from_hf(hf_cfg) -> SigLIPConfig:
    """A SigLIPConfig from a transformers SiglipVisionConfig."""
    return SigLIPConfig(
        width=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers,
        heads=hf_cfg.num_attention_heads,
        mlp_dim=hf_cfg.intermediate_size,
        image_size=hf_cfg.image_size,
        patch_size=hf_cfg.patch_size,
        ln_eps=hf_cfg.layer_norm_eps,
    )


def from_hf_state_dict(sd: Mapping, cfg: SigLIPConfig) -> dict:
    """Convert an HF SiglipVisionModel state dict (tensors or arrays)."""
    sd = {k: _np(v) for k, v in _strip_prefix(sd).items()}
    w = cfg.width
    params = {"embed": {
        "kernel": _t(_conv_kernel(sd["embeddings.patch_embedding.weight"],
                                  cfg)),
        "bias": _t(sd["embeddings.patch_embedding.bias"]),
        "pos": _t(sd["embeddings.position_embedding.weight"]),
    }}
    blocks = []
    for i in range(cfg.layers):
        pre = f"encoder.layers.{i}."
        a = pre + "self_attn."
        blocks.append({
            "ln1": {"scale": sd[pre + "layer_norm1.weight"],
                    "bias": sd[pre + "layer_norm1.bias"]},
            "attn": {
                "qkv_w": np.concatenate(
                    [sd[a + f"{n}_proj.weight"].T for n in "qkv"], axis=1),
                "qkv_b": np.concatenate(
                    [sd[a + f"{n}_proj.bias"] for n in "qkv"]),
                "out_w": sd[a + "out_proj.weight"].T,
                "out_b": sd[a + "out_proj.bias"],
            },
            "ln2": {"scale": sd[pre + "layer_norm2.weight"],
                    "bias": sd[pre + "layer_norm2.bias"]},
            "mlp": {
                "fc1_w": sd[pre + "mlp.fc1.weight"].T,
                "fc1_b": sd[pre + "mlp.fc1.bias"],
                "fc2_w": sd[pre + "mlp.fc2.weight"].T,
                "fc2_b": sd[pre + "mlp.fc2.bias"],
            },
        })
    params["blocks"] = _stack([tree_map(_t, b) for b in blocks])
    params["post_ln"] = {"scale": _t(sd["post_layernorm.weight"]),
                         "bias": _t(sd["post_layernorm.bias"])}
    if "head.probe" in sd and cfg.with_head:
        params["head"] = {
            "probe": _t(sd["head.probe"].reshape(1, w)),
            "in_w": _t(sd["head.attention.in_proj_weight"].T),
            "in_b": _t(sd["head.attention.in_proj_bias"]),
            "out_w": _t(sd["head.attention.out_proj.weight"].T),
            "out_b": _t(sd["head.attention.out_proj.bias"]),
            "ln": {"scale": _t(sd["head.layernorm.weight"]),
                   "bias": _t(sd["head.layernorm.bias"])},
            "fc1_w": _t(sd["head.mlp.fc1.weight"].T),
            "fc1_b": _t(sd["head.mlp.fc1.bias"]),
            "fc2_w": _t(sd["head.mlp.fc2.weight"].T),
            "fc2_b": _t(sd["head.mlp.fc2.bias"]),
        }
    return params


def from_reference_mtl_state_dict(sd: Mapping, mtl_cfg) -> dict:
    """Convert a reference SigLIP2_MTL torch checkpoint (encoder.* HF
    vision tower + cls_head.* + decoder.* SegFormer decoder) into the MTL
    bundle of models/segformer.init_mtl. Handles the compiled-model
    `_orig_mod.` prefix."""
    sd = {k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k: v
          for k, v in sd.items()}
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    backbone = from_hf_state_dict(enc, mtl_cfg.backbone)

    def lin(k):                      # torch Linear weight → (in, out)
        return _t(_np(sd[k]).T)

    def conv(k):                     # torch OIHW conv weight → HWIO
        return _t(_np(sd[k]).transpose(2, 3, 1, 0))

    def vec(k):
        return _t(_np(sd[k]))

    # cls head: plain Linear or Dropout+Linear sequential
    c = "cls_head." if "cls_head.weight" in sd else "cls_head.1."
    n = len(mtl_cfg.seg_layers)
    dec = {
        "projs": [{"w": lin(f"decoder.projs.{i}.proj.weight"),
                   "b": vec(f"decoder.projs.{i}.proj.bias")}
                  for i in range(n)],
        "smooth": [{
            "dw": {"w": conv(f"decoder.smooth.{i}.0.weight"),
                   "b": vec(f"decoder.smooth.{i}.0.bias")},
            "pw": {"w": conv(f"decoder.smooth.{i}.1.weight"),
                   "b": vec(f"decoder.smooth.{i}.1.bias")},
        } for i in range(n)],
        "attn1": {"w": conv("decoder.fuse_attn.0.weight"),
                  "b": vec("decoder.fuse_attn.0.bias")},
        "attn2": {"w": conv("decoder.fuse_attn.2.weight"),
                  "b": vec("decoder.fuse_attn.2.bias")},
        "fuse": {"w": conv("decoder.fuse.0.weight"),
                 "b": vec("decoder.fuse.0.bias")},
        "head": {"w": conv("decoder.head.weight"),
                 "b": vec("decoder.head.bias")},
    }
    return {"backbone": backbone,
            "cls_head": {"w": lin(c + "weight"), "b": vec(c + "bias")},
            "decoder": dec}


def from_open_clip_state_dict(sd: Mapping, cfg: SigLIPConfig) -> dict:
    """Convert an open_clip SigLIP vision tower (timm ViT naming:
    `trunk.patch_embed.proj.*`, `trunk.blocks.N.attn.qkv.*`,
    `trunk.attn_pool.*`). Accepts full-CLIP dicts (keys under `visual.`)."""
    sd = {k: _np(v) for k, v in _strip_prefix(sd).items()}
    sd = {re.sub(r"^trunk\.", "", k): v for k, v in sd.items()}
    w = cfg.width
    pos = sd["pos_embed"]
    if pos.ndim == 3:
        pos = pos[0]
    params = {"embed": {
        "kernel": _t(_conv_kernel(sd["patch_embed.proj.weight"], cfg)),
        "bias": _t(sd["patch_embed.proj.bias"]),
        "pos": _t(pos)}}
    blocks = []
    for i in range(cfg.layers):
        pre = f"blocks.{i}."
        blocks.append({
            "ln1": {"scale": sd[pre + "norm1.weight"],
                    "bias": sd[pre + "norm1.bias"]},
            "attn": {
                "qkv_w": sd[pre + "attn.qkv.weight"].T,
                "qkv_b": sd[pre + "attn.qkv.bias"],
                "out_w": sd[pre + "attn.proj.weight"].T,
                "out_b": sd[pre + "attn.proj.bias"],
            },
            "ln2": {"scale": sd[pre + "norm2.weight"],
                    "bias": sd[pre + "norm2.bias"]},
            "mlp": {
                "fc1_w": sd[pre + "mlp.fc1.weight"].T,
                "fc1_b": sd[pre + "mlp.fc1.bias"],
                "fc2_w": sd[pre + "mlp.fc2.weight"].T,
                "fc2_b": sd[pre + "mlp.fc2.bias"],
            },
        })
    params["blocks"] = _stack([tree_map(_t, b) for b in blocks])
    params["post_ln"] = {"scale": _t(sd["norm.weight"]),
                         "bias": _t(sd["norm.bias"])}
    if "attn_pool.latent" in sd and cfg.with_head:
        # timm AttentionPoolLatent: latent (1, 1, W), separate q, fused kv
        params["head"] = {
            "probe": _t(sd["attn_pool.latent"].reshape(1, w)),
            "in_w": _t(np.concatenate([sd["attn_pool.q.weight"].T,
                                       sd["attn_pool.kv.weight"].T], axis=1)),
            "in_b": _t(np.concatenate([sd["attn_pool.q.bias"],
                                       sd["attn_pool.kv.bias"]])),
            "out_w": _t(sd["attn_pool.proj.weight"].T),
            "out_b": _t(sd["attn_pool.proj.bias"]),
            "ln": {"scale": _t(sd["attn_pool.norm.weight"]),
                   "bias": _t(sd["attn_pool.norm.bias"])},
            "fc1_w": _t(sd["attn_pool.mlp.fc1.weight"].T),
            "fc1_b": _t(sd["attn_pool.mlp.fc1.bias"]),
            "fc2_w": _t(sd["attn_pool.mlp.fc2.weight"].T),
            "fc2_b": _t(sd["attn_pool.mlp.fc2.bias"]),
        }
    return params


# ----------------------------------------------------------------- CLI

def _load_state_dict(src: str) -> dict:
    """{name: f32 array} from a safetensors file, a torch .pt/.bin, an HF
    model directory, or an HF hub id (which needs the network)."""
    import os
    from tpudf_torch.utils.safetensors_io import load_file
    if os.path.isfile(src) and src.endswith(".safetensors"):
        return load_file(src)
    if os.path.isfile(src):                 # torch checkpoint
        obj = torch.load(src, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj.get("model", obj)) \
            if isinstance(obj, dict) else obj
        return {k: _np(v) for k, v in sd.items()}
    if os.path.isdir(src):
        st = [f for f in os.listdir(src) if f.endswith(".safetensors")]
        if st:
            sd = {}
            for f in sorted(st):
                sd.update(load_file(os.path.join(src, f)))
            return sd
        raise FileNotFoundError(f"no safetensors under {src}")
    from transformers import SiglipVisionModel
    model = SiglipVisionModel.from_pretrained(src)
    return {k: _np(v) for k, v in model.state_dict().items()}


def _detect_kind(sd: Mapping) -> str:
    keys = set(sd)
    stripped = set(_strip_prefix(sd))
    if any(k.startswith(("encoder.layers.", "_orig_mod.encoder."))
           or k.startswith("cls_head.") for k in keys):
        if any(k.startswith(("decoder.", "_orig_mod.decoder."))
               for k in keys):
            return "mtl"
    if any(k.startswith(("trunk.", "patch_embed.")) for k in stripped):
        return "open_clip"
    return "hf"


def _infer_config(sd: Mapping) -> SigLIPConfig:
    """The geometry of a source dict, from its shapes and layer names."""
    sd = {re.sub(r"^trunk\.", "", k): v for k, v in _strip_prefix(sd).items()}
    if "embeddings.patch_embedding.weight" in sd:
        conv = sd["embeddings.patch_embedding.weight"]
        pos = sd["embeddings.position_embedding.weight"]
        layers = 1 + max(int(m.group(1)) for k in sd
                         if (m := re.match(r"encoder\.layers\.(\d+)\.", k)))
        mlp = sd["encoder.layers.0.mlp.fc1.weight"].shape[0]
    else:
        conv = sd["patch_embed.proj.weight"]
        pos = sd["pos_embed"]
        pos = pos[0] if len(pos.shape) == 3 else pos
        layers = 1 + max(int(m.group(1)) for k in sd
                         if (m := re.match(r"blocks\.(\d+)\.", k)))
        mlp = sd["blocks.0.mlp.fc1.weight"].shape[0]
    width, _, p, _ = conv.shape
    image_size = int(round(pos.shape[0] ** 0.5)) * p
    # SigLIP family head counts: 64-dim heads except so400m (1152/16=72)
    heads = {768: 12, 1024: 16, 1152: 16}.get(width, max(width // 64, 1))
    return SigLIPConfig(width=int(width), layers=layers, heads=heads,
                        mlp_dim=int(mlp), image_size=image_size,
                        patch_size=int(p))


def main(argv=None):
    import argparse
    import dataclasses
    import json
    import os

    from tpudf_torch.train.checkpoint import save_checkpoint

    ap = argparse.ArgumentParser(
        description="Convert HF/open_clip SigLIP weights to a tpudf_torch "
                    "checkpoint (+ config.json sidecar).")
    ap.add_argument("--src", required=True,
                    help="HF dir / hub id / .safetensors / torch .pt")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--kind", default="auto",
                    choices=["auto", "hf", "open_clip", "mtl"])
    ap.add_argument("--seg_layers", default="0,5,11",
                    help="MTL only: comma-separated tap layers")
    ap.add_argument("--embed_dim", type=int, default=512,
                    help="MTL only: decoder embed dim")
    args = ap.parse_args(argv)

    sd = _load_state_dict(args.src)
    kind = _detect_kind(sd) if args.kind == "auto" else args.kind
    if kind == "mtl":
        from tpudf_torch.models.segformer import MTLConfig
        enc = {k.split("encoder.", 1)[1]: v for k, v in sd.items()
               if k.startswith(("encoder.", "_orig_mod.encoder."))}
        bb_cfg = _infer_config(enc)
        cfg = MTLConfig(backbone=bb_cfg,
                        seg_layers=tuple(int(s) for s in
                                         args.seg_layers.split(",")),
                        embed_dim=args.embed_dim)
        params = from_reference_mtl_state_dict(sd, cfg)
        cfg_json = {"kind": "mtl",
                    "backbone": dataclasses.asdict(bb_cfg),
                    "seg_layers": list(cfg.seg_layers),
                    "embed_dim": cfg.embed_dim}
    else:
        cfg = _infer_config(sd)
        params = (from_hf_state_dict(sd, cfg) if kind == "hf"
                  else from_open_clip_state_dict(sd, cfg))
        cfg_json = {"kind": kind, "backbone": dataclasses.asdict(cfg)}
    del sd

    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "params"), params)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=2)
    n = []
    tree_map(lambda t: n.append(t.numel()), params)
    print(f"[convert] kind={kind} params={sum(n) / 1e6:.1f}M -> {args.out}")


if __name__ == "__main__":
    main()
