"""CiFake-style binary classifier trainer CLI (tpudf/cli/train_binary.py)
on PyTorch: a frozen SigLIP tower + a trainable head on a TRAIN/VAL/TEST x
REAL|FAKE folder dataset, with EMA, mixup, warmup-cosine, early stopping,
best-F1 checkpointing, a CSV ledger and an --evaluate_only mode.

Usage:
  python -m tpudf_torch.cli.train_binary --data_dir DIR [--device cuda] \\
      --model_size large-384 --epochs 10 --save_dir runs/binary

--backbone_ckpt reads an HF SiglipVisionModel state dict (`.safetensors`,
or a torch `.pt` of {name: tensor}) into the tower (`entry.load_backbone`);
--int8_backbone calibrates the frozen tower's activation scales on the
first training batch and quantises it to static W8A8; a bare --tome_r
trains on the deployed ToMe features (r = 96, floor S/8). The trainer is
`entry.build_binary_trainer`, the function chip_smoke.py drives.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpudf_torch binary trainer")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--save_dir", default="runs/binary")
    from tpudf_torch.models.siglip import CONFIGS
    p.add_argument("--model_size", default="base-256",
                   choices=sorted(CONFIGS))
    p.add_argument("--head", default="v5", choices=["v5", "fast"])
    p.add_argument("--backbone_ckpt", default=None,
                   help="HF SiglipVisionModel state dict (.safetensors or a "
                        "torch .pt of {name: tensor})")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--mixup_alpha", type=float, default=0.0)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--augment", action="store_true", default=True)
    p.add_argument("--no_augment", dest="augment", action="store_false")
    p.add_argument("--tome_r", type=int, default=None, const=-1, nargs="?",
                   help="extract features with ToMe token merging so the "
                        "head trains on the deployed serving features; "
                        "bare --tome_r uses the deployed schedule")
    p.add_argument("--int8_backbone", action="store_true",
                   help="run the frozen backbone on the static W8A8 kernels "
                        "(calibrated on the first training batch)")
    p.add_argument("--evaluate_only", action="store_true")
    p.add_argument("--resume", default=None)
    p.add_argument("--subset", type=float, default=1.0,
                   help="fraction of train data (smoke runs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.data.augment import train_augment
    from tpudf_torch.data.datasets import FolderImageDataset
    from tpudf_torch.data.pipeline import normalize_siglip
    from tpudf_torch.data.prefetch import prefetch
    from tpudf_torch.entry import build_binary_trainer
    from tpudf_torch.eval.metrics import binary_metrics
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.train.checkpoint import (restore_train_state,
                                              save_checkpoint)
    from tpudf_torch.train.loops import LoopConfig, run_training
    from tpudf_torch.train.steps import TrainState, tensor_leaves

    device = torch.device(args.device)
    cfg = CONFIGS[args.model_size]
    size = cfg.image_size
    if not args.backbone_ckpt:
        print("[warn] no --backbone_ckpt: random backbone (smoke mode)")

    train_ds = FolderImageDataset(args.data_dir, "train", size)
    val_ds = FolderImageDataset(args.data_dir, "val", size)
    if args.subset < 1.0:
        train_ds.samples = train_ds.samples[
            :max(int(len(train_ds.samples) * args.subset), args.batch_size)]

    def pixels_of(batch):
        """uint8 NHWC numpy → f32 [0, 1] on the device."""
        return torch.from_numpy(batch["pixels"]).to(device).float() / 255.0

    calib = None
    if args.int8_backbone:
        first = next(iter(train_ds.batches(min(16, len(train_ds)))))
        calib = normalize_siglip(pixels_of(first))

    restored = None
    if args.resume and os.path.exists(args.resume):
        restored = restore_train_state(args.resume, device)
        # reconcile the checkpoint's EMA with the flag BEFORE the step is
        # built (its decay is fixed there): a restored EMA without
        # --ema_decay continues at 0.999, --ema_decay on a checkpoint
        # without EMA seeds it from the restored params
        has_ema = restored["ema"] is not None
        if has_ema and not args.ema_decay:
            args.ema_decay = 0.999
            print("[resume][warn] checkpoint tracks EMA but --ema_decay "
                  "was not given — continuing EMA with decay 0.999")
        elif not has_ema and args.ema_decay:
            restored["ema"] = tree_map(
                lambda t: t.detach().clone() if torch.is_tensor(t) else t,
                restored["params"])
            print("[resume][warn] --ema_decay given but checkpoint has no "
                  "EMA slot — seeding EMA from the restored params")

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    trainer = build_binary_trainer(
        device, seed=args.seed, cfg_name=args.model_size, head=args.head,
        int8_backbone=args.int8_backbone, tome_r=args.tome_r,
        ema_decay=args.ema_decay or None, mixup_alpha=args.mixup_alpha,
        backbone_ckpt=args.backbone_ckpt, lr=args.lr,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        total_steps=steps_per_epoch * args.epochs, calib_pixels=calib)
    if args.int8_backbone:
        print("[int8] frozen backbone statically quantized (W8A8) — "
              "training features and eval both use the int8 tower")
    state = trainer.state
    if restored is not None:
        for leaf in tensor_leaves(restored["params"]):
            leaf.requires_grad_(True)
        state = TrainState(restored["params"], restored["opt_state"],
                           restored["ema"], int(restored["step"]))
        print(f"[resume] restored {args.resume} "
              f"(epoch {restored.get('epoch')})")
    box = {"state": state}

    def train_epoch(epoch):
        losses, accs = [], []
        for i, batch in enumerate(prefetch(train_ds.batches(
                args.batch_size, shuffle=True, seed=args.seed + epoch,
                drop_last=True))):
            x = pixels_of(batch)
            gen = torch.Generator(device=device).manual_seed(
                epoch * 100000 + i)
            if args.augment:
                x = train_augment(gen, x)
            b = {"pixels": normalize_siglip(x),
                 "labels": torch.from_numpy(batch["labels"]).to(device)}
            box["state"], m = trainer.step(box["state"], trainer.backbone, b,
                                           gen)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
        return {"loss": np.mean(losses) if losses else np.nan,
                "acc": np.mean(accs) if accs else np.nan}

    def eval_epoch(epoch):
        probs, labels = [], []
        st = box["state"]
        params = st.ema if st.ema is not None else st.params
        for batch in prefetch(val_ds.batches(args.batch_size)):
            z = trainer.logits(params, normalize_siglip(pixels_of(batch)))
            probs.append(torch.sigmoid(z.float()).cpu().numpy())
            labels.append(batch["labels"])
        return binary_metrics(np.concatenate(labels), np.concatenate(probs))

    if args.evaluate_only:
        print("[evaluate_only]", eval_epoch(0))
        return

    def save_best(epoch, row):
        save_checkpoint(os.path.join(args.save_dir, "best"),
                        box["state"]._asdict() | {"epoch": epoch},
                        metrics=row)

    run_training(LoopConfig(epochs=args.epochs, patience=args.patience,
                            monitor="f1", save_dir=args.save_dir),
                 train_epoch, eval_epoch, save_best)


if __name__ == "__main__":
    main()
