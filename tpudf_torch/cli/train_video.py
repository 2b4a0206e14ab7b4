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
16) and runs it on the static W8A8 kernels. --analysis (the publication
analysis suite) needs eval/analysis.py and eval/plots.py, which the port
does not have yet (ROADMAP Queue A item 6): it exits before training.
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
                   help="post-training publication analysis (not in the "
                        "port yet: exits before training)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.analysis:
        raise SystemExit("--analysis needs eval/analysis.py and "
                         "eval/plots.py, which tpudf_torch does not have yet "
                         "(ROADMAP Queue A item 6); run without --analysis")
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

    return run_training(
        LoopConfig(epochs=args.epochs, patience=args.patience,
                   monitor="f1", save_dir=args.save_dir),
        train_epoch, eval_epoch, save_best)


if __name__ == "__main__":
    main()
