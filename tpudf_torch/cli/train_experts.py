"""Expert-stack preparation CLI (tpudf/cli/train_experts.py): frequency
MLP → fusion head → CORAL, one command producing the deployed artifact set.

On a REAL/FAKE folder corpus:
  1. the 24-d FFT/SRM features of every image and the SigLIP expert's
     z_sig (the corpus pass: one device batch each, under inference mode;
     K3's SRM moments and the bf16 tower's kernels on the card)
  2. the frequency MLP (the deployed simple arch; --v5 also trains the v5
     trainer arch as a second artifact)
  3. the Linear(2, 1) fusion head on the two experts' probabilities (the
     deployed appv3.py:1573-1590 head)
  4. the fused logits' CORAL cutpoints, NLL temperature and bins histogram

Artifacts land in --save_dir under the reference's names and formats
(freq_mlp.safetensors keys net.0/1/3; freq_mlp_v5.safetensors;
fusion_head.safetensors fc.weight / fc.bias; coral_cutpoints.json
prob-space q25/q50/q75/max; coral_temp.json; coral_bins.npy), so
`python -m tpudf_torch.cli.infer --artifacts SAVE_DIR` reads them. The
safetensors files are written by the port's own writer
(utils/safetensors_io.py), so no safetensors package is needed.

Usage:
  python -m tpudf_torch.cli.train_experts --data_dir DIR [--device cuda] \\
      [--model_size base-256] [--backbone_ckpt model.safetensors|model.pt] \\
      [--head_ckpt runs/binary/best] [--v5] [--save_dir runs/experts]

--head_ckpt reads a checkpoint of `python -m tpudf_torch.cli.train_binary`
(torch.save; its EMA head when it kept one), not the JAX package's orbax
checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

FREQ_TEMP = 1.25        # the engine's temperature of the frequency expert


def build_argparser():
    from tpudf_torch.models.siglip import CONFIGS
    p = argparse.ArgumentParser(description="tpudf_torch expert-stack "
                                            "trainer")
    p.add_argument("--data_dir", required=True,
                   help="folder dataset with REAL/FAKE class dirs (under "
                        "train/ or at the top)")
    p.add_argument("--save_dir", default="runs/experts")
    p.add_argument("--model_size", default="base-256",
                   choices=sorted(CONFIGS))
    p.add_argument("--backbone_ckpt", default=None,
                   help="HF SiglipVisionModel state dict (.safetensors or a "
                        "torch .pt of {name: tensor})")
    p.add_argument("--head_ckpt", default=None,
                   help="checkpoint from tpudf_torch.cli.train_binary (its "
                        "v5 head; EMA params if present)")
    p.add_argument("--v5", action="store_true",
                   help="also train + save the v5-trainer freq arch "
                        "(freq_mlp_v5.safetensors)")
    p.add_argument("--freq_epochs", type=int, default=60)
    p.add_argument("--fusion_steps", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p


def _gather(data_dir):
    """Image paths under DIR/train/{REAL,FAKE} and DIR/{REAL,FAKE}, sorted
    per folder, and their labels (FAKE = 1)."""
    from tpudf_torch.data.datasets import IMG_EXTS
    paths, labels = [], []
    for cls, y in (("REAL", 0.0), ("FAKE", 1.0)):
        for root in (os.path.join(data_dir, "train", cls),
                     os.path.join(data_dir, cls)):
            if not os.path.isdir(root):
                continue
            for f in sorted(os.listdir(root)):
                if f.lower().endswith(IMG_EXTS):
                    paths.append(os.path.join(root, f))
                    labels.append(y)
    if not paths:
        raise SystemExit(f"no REAL/FAKE images under {data_dir}")
    return paths, np.asarray(labels, np.float32)


def _batches(paths, size, batch, device="cuda"):
    """Yield (pixels f32 [0, 1] (B, S, S, 3), gray256 (B, 256, 256))
    tensors on `device`: PIL's default resize to S, then the 0.299 / 0.587
    / 0.114 luma and, at S != 256, jax.image.resize's antialiased bilinear
    to 256 (data/pipeline.resize)."""
    import torch
    from PIL import Image

    from tpudf_torch.data.pipeline import resize, rgb_to_gray
    for s in range(0, len(paths), batch):
        imgs = []
        for p in paths[s:s + batch]:
            im = Image.open(p).convert("RGB").resize((size, size))
            imgs.append(np.asarray(im, np.float32) / 255.0)
        px = torch.from_numpy(np.stack(imgs)).to(device)
        g = rgb_to_gray(px)
        if size != 256:
            g = resize(g, (g.shape[0], 256, 256), "bilinear")
        yield px, g


def corpus_pass(paths, cfg, tower, head, batch_size, device, kernels=None):
    """The 24-d features and z_sig of every image (numpy (N, 24), (N,)):
    `extract_freq_vector` on the gray plane and the v5 head over the
    frozen tower's pooled features, one device batch at a time under
    inference mode. tower: `siglip.tower_params` of the backbone (or a
    static W8A8 tree)."""
    import torch

    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.data.pipeline import normalize_siglip
    from tpudf_torch.models.heads import apply_binary_head
    from tpudf_torch.models.siglip import siglip_forward
    from tpudf_torch.ops.fft_features import extract_freq_vector
    from tpudf_torch.ops.routes import KERNELS
    kernels = kernels or KERNELS
    feats, z_sig = [], []
    with torch.inference_mode():
        for px, gray in _batches(paths, cfg.image_size, batch_size, device):
            feats.append(extract_freq_vector(gray, kernels).cpu().numpy())
            pooled = siglip_forward(tower, normalize_siglip(px), cfg,
                                    DEFAULT_POLICY, kernels=kernels)["pooled"]
            z_sig.append(apply_binary_head(head, pooled).float().cpu()
                         .numpy())
    return np.concatenate(feats), np.concatenate(z_sig)


def _np(t):
    return t.detach().float().cpu().numpy()


def _save_freq_simple(path, params):
    from tpudf_torch.utils.safetensors_io import save_file
    save_file({
        "net.0.weight": _np(params["ln"]["scale"]),
        "net.0.bias": _np(params["ln"]["bias"]),
        "net.1.weight": _np(params["fc1"]["w"]).T,
        "net.1.bias": _np(params["fc1"]["b"]),
        "net.3.weight": _np(params["fc2"]["w"]).T,
        "net.3.bias": _np(params["fc2"]["b"]),
    }, path)


def _save_freq_v5(path, params):
    from tpudf_torch.utils.safetensors_io import save_file
    sd = {
        "normer.mean": _np(params["norm_mean"]),
        "normer.std": _np(params["norm_std"]),
        "contrast.alpha": _np(params["contrast"]["alpha"]),
        "contrast.beta": _np(params["contrast"]["beta"]),
        "band.gates": _np(params["gates"]),
        "head.weight": _np(params["head"]["w"]).T,
        "head.bias": _np(params["head"]["b"]),
        "temp.T": _np(params["temp"]).reshape(1),
    }
    for i, blk in enumerate(params["blocks"]):
        sd[f"blocks.{i}.norm.weight"] = _np(blk["ln"]["scale"])
        sd[f"blocks.{i}.norm.bias"] = _np(blk["ln"]["bias"])
        sd[f"blocks.{i}.fc1.weight"] = _np(blk["fc1"]["w"]).T
        sd[f"blocks.{i}.fc1.bias"] = _np(blk["fc1"]["b"])
        sd[f"blocks.{i}.fc2.weight"] = _np(blk["fc2"]["w"]).T
        sd[f"blocks.{i}.fc2.bias"] = _np(blk["fc2"]["b"])
    save_file(sd, path)


def _train_linear_fusion(p_sig, p_freq, labels, steps, seed, device="cuda"):
    """Logistic Linear(2, 1) on the probabilities, full batch, Adam at
    5e-2 from w = (1.5, 1.5), b = 0: the deployed fusion head's format
    (appv3.py:1573-1590). Returns (params, the last step's loss)."""
    import torch

    from tpudf_torch.models.fusion import apply_fusion_linear
    from tpudf_torch.train.losses import bce_with_logits
    from tpudf_torch.train.steps import (adam, fit_step, frozen_copy,
                                         tensor_leaves, trainable)

    params = trainable({"w": torch.tensor([[1.5], [1.5]]),
                        "b": torch.zeros(1)}, device)
    opt = adam(5e-2)
    st = opt.init([t.detach() for t in tensor_leaves(params)])
    on = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    ps, pf, y = on(p_sig), on(p_freq), on(labels)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        st, loss = fit_step(params, opt, st, lambda p: bce_with_logits(
            apply_fusion_linear(p, ps, pf), y))
    return frozen_copy(params), float(loss)


def main(argv=None):
    import torch

    from tpudf_torch.cli.infer import restore_head
    from tpudf_torch.core.precision import DEFAULT_POLICY, tree_map
    from tpudf_torch.entry import load_backbone
    from tpudf_torch.eval.metrics import roc_auc
    from tpudf_torch.models.freq_mlp import apply_freq_mlp
    from tpudf_torch.models.fusion import apply_fusion_linear
    from tpudf_torch.models.heads import init_binary_head
    from tpudf_torch.models.siglip import CONFIGS, init_siglip, tower_params
    from tpudf_torch.train.experts import fit_coral, train_freq_mlp
    from tpudf_torch.utils.safetensors_io import save_file

    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = CONFIGS[args.model_size]

    paths, labels = _gather(args.data_dir)
    print(f"[experts] {len(paths)} images "
          f"({int(labels.sum())} fake / {int((1 - labels).sum())} real)")

    # backbone + visual head (the seeds of cli/infer and cli/train_binary)
    if args.backbone_ckpt:
        backbone = load_backbone(args.backbone_ckpt, cfg)
    else:
        print("[warn] random backbone (smoke mode)")
        backbone = init_siglip(torch.Generator().manual_seed(args.seed), cfg)
    head = init_binary_head(torch.Generator().manual_seed(args.seed + 1),
                            cfg.width)
    if args.head_ckpt:
        head = restore_head(args.head_ckpt, head)
    on_dev = lambda t: t.to(device)
    tower = tower_params(tree_map(on_dev, backbone),
                         DEFAULT_POLICY.compute_dtype)
    head = tree_map(on_dev, head)
    feats, z_sig = corpus_pass(paths, cfg, tower, head, args.batch_size,
                               device)
    del tower

    # ---- the frequency MLP (the deployed simple arch for the artifact)
    freq_params, freq_auc = train_freq_mlp(
        feats, labels, v5=False, epochs=args.freq_epochs, seed=args.seed,
        device=device)
    _save_freq_simple(os.path.join(args.save_dir, "freq_mlp.safetensors"),
                      freq_params)
    summary = {"freq_auc": float(freq_auc)}
    if args.v5:
        v5_params, v5_auc = train_freq_mlp(
            feats, labels, v5=True, epochs=args.freq_epochs, seed=args.seed,
            device=device)
        _save_freq_v5(os.path.join(args.save_dir, "freq_mlp_v5.safetensors"),
                      v5_params)
        summary["freq_v5_auc"] = float(v5_auc)

    # ---- the deployed Linear(2, 1) fusion on probabilities
    with torch.no_grad():
        z_freq = apply_freq_mlp(freq_params, torch.as_tensor(
            feats, device=device)).cpu().numpy()
    p_sig = 1.0 / (1.0 + np.exp(-z_sig))
    p_freq = 1.0 / (1.0 + np.exp(-z_freq / FREQ_TEMP))
    fusion_params, fusion_loss = _train_linear_fusion(
        p_sig, p_freq, labels, args.fusion_steps, args.seed, device)
    save_file({"fc.weight": _np(fusion_params["w"]).T,
               "fc.bias": _np(fusion_params["b"])},
              os.path.join(args.save_dir, "fusion_head.safetensors"))
    summary["fusion_loss"] = fusion_loss

    # ---- CORAL cutpoints + temperature + bins
    with torch.no_grad():
        z_fused = apply_fusion_linear(
            fusion_params, torch.as_tensor(p_sig, device=device),
            torch.as_tensor(p_freq, device=device)).cpu().numpy()
    fit = fit_coral(z_fused, labels)
    q = 1.0 / (1.0 + np.exp(-np.asarray(fit.cutpoints)))
    with open(os.path.join(args.save_dir, "coral_cutpoints.json"), "w") as f:
        json.dump({"q25": float(q[0]), "q50": float(q[1]),
                   "q75": float(q[2]), "max": float(q[3])}, f, indent=2)
    with open(os.path.join(args.save_dir, "coral_temp.json"), "w") as f:
        json.dump({"temperature": float(fit.temperature)}, f, indent=2)
    np.save(os.path.join(args.save_dir, "coral_bins.npy"),
            fit.bins_histogram)
    summary["fused_auc"] = float(roc_auc(labels, z_fused))
    summary["coral_cutpoints_prob"] = [float(v) for v in q]
    summary["coral_temperature"] = float(fit.temperature)

    with open(os.path.join(args.save_dir, "experts_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[experts]", json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
