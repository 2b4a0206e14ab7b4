"""HiDF-style video classifier trainer CLI (tpudf/cli/train_video.py;
hidf_video_classifier.py:2805-3121): a frozen SigLIP tower over T frames a
clip + the trainable temporal video head, on a REAL|FAKE folder of clips,
with warmup-cosine AdamW, early stopping on the val F1, best-F1
checkpointing, a CSV ledger (the val BCE in each row) and an
--evaluate_only mode.

Usage:
  python -m tpudf_torch.cli.train_video --data_dir DIR [--device cuda] \\
      [--model_size base-256] [--num_frames 8] [--batch_size 8] \\
      [--epochs 10] [--int8_backbone] [--save_dir runs/video]

--backbone_ckpt reads an HF SiglipVisionModel state dict (`.safetensors`,
or a torch `.pt` of {name: tensor}); --int8_backbone calibrates the frozen
tower's activation scales on the first training batch's frames (at most
16) and runs it on the static W8A8 kernels. --analysis runs the
publication analysis after training (hidf_video_classifier.py:3124-3284):
sampled train / val confidences, the video head's activation statistics
on one validation batch's tower forward (the tower trained with: W8A8
under --int8_backbone, else bf16), the learning-vs-memorization battery
and its 16-panel dashboard, `learning_analysis.json`, and the inference
figure suite of the val split under save_dir/figures (eval/analysis.py,
eval/plots.py); without matplotlib it writes the JSON, says so, and draws
nothing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    from tpudf_torch.models.siglip import CONFIGS
    p = argparse.ArgumentParser(description="tpudf_torch video trainer")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--save_dir", default="runs/video")
    p.add_argument("--model_size", default="base-256",
                   choices=sorted(CONFIGS))
    p.add_argument("--backbone_ckpt", default=None,
                   help="HF SiglipVisionModel state dict (.safetensors or a "
                        "torch .pt of {name: tensor})")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--int8_backbone", action="store_true",
                   help="run the frozen backbone on the static W8A8 "
                        "kernels during training (calibrated on the first "
                        "training batch's frames)")
    p.add_argument("--evaluate_only", action="store_true")
    p.add_argument("--analysis", action="store_true",
                   help="post-training publication analysis: activation "
                        "stats, learning-vs-memorization 16-panel dashboard "
                        "+ inference figure suite "
                        "(hidf_video_classifier.py:2034-3284)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tpudf_torch.core.precision import DEFAULT_POLICY, tree_map
    from tpudf_torch.data.datasets import FolderVideoDataset
    from tpudf_torch.data.pipeline import normalize_siglip
    from tpudf_torch.data.prefetch import prefetch
    from tpudf_torch.entry import load_backbone
    from tpudf_torch.eval.metrics import binary_metrics
    from tpudf_torch.models.heads import init_video_head
    from tpudf_torch.models.siglip import CONFIGS, init_siglip, tower_params
    from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                       quantize_siglip_static)
    from tpudf_torch.train.checkpoint import save_checkpoint
    from tpudf_torch.train.loops import LoopConfig, run_training
    from tpudf_torch.train.steps import make_optimizer
    from tpudf_torch.train.video import (auto_pos_weight,
                                         make_video_eval_step,
                                         make_video_train_step)

    device = torch.device(args.device)
    cfg = CONFIGS[args.model_size]
    if args.backbone_ckpt:
        backbone = load_backbone(args.backbone_ckpt, cfg)
    else:
        print("[warn] random backbone (smoke mode)")
        backbone = init_siglip(torch.Generator().manual_seed(args.seed), cfg)
    head = init_video_head(torch.Generator().manual_seed(args.seed + 1),
                           cfg.width)
    backbone = tree_map(lambda t: t.to(device), backbone)
    head = tree_map(lambda t: t.to(device), head)

    train_ds = FolderVideoDataset(args.data_dir, "train", args.num_frames,
                                  cfg.image_size)
    val_ds = FolderVideoDataset(args.data_dir, "val", args.num_frames,
                                cfg.image_size)
    labels = [l for _, l in train_ds.samples]
    pos_w = auto_pos_weight(labels) if labels else 1.0

    def frames_of(batch):
        """uint8 (B, T, S, S, 3) numpy → normalised f32 on the device."""
        x = torch.from_numpy(batch["frames"]).to(device).float() / 255.0
        return normalize_siglip(x)

    if args.int8_backbone:
        first = next(iter(train_ds.batches(min(2, max(len(train_ds), 1)))))
        fr = frames_of(first)
        calib = fr.reshape(-1, *fr.shape[2:])[:16]
        with torch.no_grad():
            scales = calibrate_siglip_act_scales(backbone, cfg, calib,
                                                 DEFAULT_POLICY)
            backbone = quantize_siglip_static(backbone, scales, cfg)
        print("[int8] frozen backbone statically quantized (W8A8)")
    tower = tower_params(backbone, DEFAULT_POLICY.compute_dtype)
    n_backbone = jax_param_count(backbone)
    del backbone
    optimizer = make_optimizer(args.lr, total_steps=max(
        len(train_ds) // args.batch_size, 1) * args.epochs)
    init_fn, step = make_video_train_step(cfg, optimizer, DEFAULT_POLICY,
                                          pos_w)
    eval_step = make_video_eval_step(cfg, DEFAULT_POLICY)
    box = {"state": init_fn(head)}

    def train_epoch(epoch):
        losses = []
        for i, batch in enumerate(prefetch(train_ds.batches(
                args.batch_size, shuffle=True, seed=args.seed + epoch))):
            b = {"frames": frames_of(batch),
                 "labels": torch.from_numpy(batch["labels"]).to(device)}
            gen = torch.Generator(device=device).manual_seed(
                epoch * 9999 + i)
            box["state"], m = step(box["state"], tower, b, gen)
            losses.append(float(m["loss"]))
        return {"loss": np.mean(losses) if losses else np.nan}

    def eval_epoch(epoch):
        probs, labels = [], []
        for batch in prefetch(val_ds.batches(args.batch_size)):
            z = eval_step(box["state"].head, tower, frames_of(batch))
            probs.append(torch.sigmoid(z.float()).cpu().numpy())
            labels.append(batch["labels"])
        if not probs:
            return {"f1": 0.0}
        y = np.concatenate(labels)
        p = np.clip(np.concatenate(probs), 1e-7, 1 - 1e-7)
        # the val BCE: the learning-vs-memorization battery reads
        # history['val_loss']
        loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
        return {"loss": loss, **binary_metrics(y, p)}

    if args.evaluate_only:
        print("[evaluate_only]", eval_epoch(0))
        return

    def save_best(epoch, row):
        save_checkpoint(os.path.join(args.save_dir, "best"),
                        box["state"]._asdict() | {"epoch": epoch}, row)

    history = run_training(
        LoopConfig(epochs=args.epochs, patience=args.patience,
                   monitor="f1", save_dir=args.save_dir),
        train_epoch, eval_epoch, save_best)

    if args.analysis:
        publication_analysis(args, cfg, tower, n_backbone, box["state"].head,
                             train_ds, val_ds, eval_step, frames_of,
                             history)
    return history


def jax_param_count(tree) -> int:
    """The entries of a parameter tree as the JAX package counts its
    leaves: the kernels' transposed int8 copies (`qT`, added by
    `tower_params`) are not parameters."""
    import torch
    if isinstance(tree, dict):
        return sum(jax_param_count(v) for k, v in tree.items() if k != "qT")
    if isinstance(tree, (list, tuple)):
        return sum(jax_param_count(v) for v in tree)
    return tree.numel() if torch.is_tensor(tree) else 0


def publication_analysis(args, cfg, tower, n_backbone, head, train_ds,
                         val_ds, eval_step, frames_of, history):
    """Post-training suite (hidf_video_classifier.py:3124-3284, JAX's
    `_publication_analysis`): sampled train / val confidences (up to 10
    batches of each split through the eval step), activation statistics
    of the head on one validation batch's tower forward, the
    learning-vs-memorization metric battery + 16-panel dashboard,
    learning_analysis.json, and the inference figure suite on the val
    split. Returns the metrics and the activation statistics."""
    import json

    import torch

    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.eval.analysis import (activation_statistics,
                                           learning_memorization_metrics,
                                           plot_memorization_dashboard,
                                           video_head_activations)
    from tpudf_torch.eval.plots import (figures_available,
                                        render_inference_report)
    from tpudf_torch.models.siglip import siglip_forward

    def _probs(ds, cap_batches=10):
        probs, labels = [], []
        for i, batch in enumerate(ds.batches(args.batch_size)):
            if i >= cap_batches:
                break
            z = eval_step(head, tower, frames_of(batch))
            probs.append(torch.sigmoid(z.double()).cpu().numpy())
            labels.append(np.asarray(batch["labels"], np.float64))
        if not probs:
            return np.zeros(0), np.zeros(0)
        return np.concatenate(probs), np.concatenate(labels)

    train_p, _ = _probs(train_ds)
    val_p, val_y = _probs(val_ds)

    act_stats = None
    for batch in val_ds.batches(args.batch_size):
        fr = frames_of(batch)
        b, t = fr.shape[:2]
        with torch.no_grad():
            feats = siglip_forward(
                tower, fr.reshape(b * t, *fr.shape[2:]), cfg,
                DEFAULT_POLICY)["pooled"].reshape(b, t, -1)
        act_stats = activation_statistics(
            video_head_activations(head, feats))
        break

    metrics = learning_memorization_metrics(
        history, train_probs=train_p if len(train_p) else None,
        val_probs=val_p if len(val_p) else None,
        activation_stats=act_stats)
    n_head = jax_param_count(head) if head else 0
    with open(os.path.join(args.save_dir,
                           "learning_analysis.json"), "w") as f:
        json.dump({k: v for k, v in metrics.items()
                   if not isinstance(v, np.ndarray)}, f, indent=2,
                  default=float)
    path = "learning_analysis.json only"
    if not figures_available():
        print("[analysis] matplotlib is not installed: no dashboard and no "
              "figures")
    else:
        path = plot_memorization_dashboard(
            metrics, history, args.save_dir, train_probs=train_p,
            val_probs=val_p, n_params={"backbone": n_backbone,
                                       "head": n_head})
        if len(val_p):
            render_inference_report(val_y, val_p,
                                    os.path.join(args.save_dir, "figures"))
    print(f"[analysis] {metrics.get('learning_type')} "
          f"(score {metrics.get('learning_score'):.1f}/10) → {path}")
    return metrics, act_stats


if __name__ == "__main__":
    main()
