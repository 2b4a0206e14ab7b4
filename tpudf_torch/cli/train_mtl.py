"""SID_Set multi-task trainer CLI (tpudf/cli/train_mtl.py) on PyTorch: 3-class
classification + tamper-mask segmentation with the frozen-backbone option,
dynamic loss weights, dice/IoU/pixel-AUC eval and the mask-threshold sweep.

Usage:
  python -m tpudf_torch.cli.train_mtl --epochs 8 --subset_train 0.05
  python -m tpudf_torch.cli.train_mtl --data_dir DIR [--device cuda]

Without --data_dir the CLI trains on SID_Set (saberzl/SID_Set, splits
train and validation) through the Hugging Face `datasets` package
(`data.datasets.load_sid_set`): it needs that package and the dataset in
its local cache (or the network), and exits with "provide --data_dir"
where either is missing. It takes max(n * subset_train, batch_size) of
the n training records and max(n * min(2 * subset_train, 1),
batch_size) of the validation ones (at most n), each mapped by
`sid_example_to_arrays`. DIR holds {train,val}/images/*.png,
{train,val}/masks/<same name>.png (optional) and {train,val}/labels.csv
with `name,label` (0 real / 1 synthetic / 2 tampered). The MTL tree is
built before the data is read, as in the JAX CLI. --backbone_ckpt reads an
HF SiglipVisionModel state dict (`.safetensors`, or a torch `.pt`) into
the tower; --image_size other than the config's interpolates the position
table (the production run: --model_size large-384 at 256 px). The device
is cuda unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpudf_torch MTL trainer")
    p.add_argument("--save_dir", default="runs/mtl")
    p.add_argument("--model_size", default="base-256")
    p.add_argument("--backbone_ckpt", default=None)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--seg_layers", type=int, nargs="+", default=[2, 6, 10, -1])
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--freeze_below", type=int, default=21)
    p.add_argument("--no_freeze", action="store_true")
    p.add_argument("--int8_frozen", action="store_true",
                   help="run the frozen backbone prefix on the static W8A8 "
                        "kernels inside the train step (calibrated on the "
                        "first 16 training images)")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--seg_loss", default="combined",
                   choices=["combined", "bce_dice"])
    p.add_argument("--subset_train", type=float, default=1.0)
    p.add_argument("--mask_thr", type=float, default=0.5)
    p.add_argument("--sweep_mask_thr", action="store_true", default=True)
    p.add_argument("--no_sweep_mask_thr", dest="sweep_mask_thr",
                   action="store_false")
    p.add_argument("--patience", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir", default=None,
                   help="optional local folder dataset instead of HF SID_Set")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p.parse_args(argv)


def _load_local_sid(root, split, image_size):
    """Local SID-style layout: {root}/{split}/images/*.png,
    {root}/{split}/masks/<same name>.png (optional),
    {root}/{split}/labels.csv with `name,label`."""
    import csv

    from PIL import Image

    base = os.path.join(root, split)
    labels = {}
    with open(os.path.join(base, "labels.csv")) as f:
        for row in csv.DictReader(f):
            labels[row["name"]] = int(row["label"])
    out = []
    img_dir = os.path.join(base, "images")
    mask_dir = os.path.join(base, "masks")
    for name in sorted(labels):
        img = Image.open(os.path.join(img_dir, name)).convert("RGB") \
            .resize((image_size, image_size), Image.BICUBIC)
        label = labels[name]
        mpath = os.path.join(mask_dir, name)
        if os.path.exists(mpath):
            m = Image.open(mpath).convert("L").resize(
                (image_size, image_size), Image.NEAREST)
            mask = (np.asarray(m, np.float32) > 127).astype(np.float32)
            has_mask = label == 2
        else:
            mask = np.zeros((image_size, image_size), np.float32)
            has_mask = False
        out.append({"pixels": np.asarray(img, np.uint8), "cls": label,
                    "binary": float(label > 0), "mask": mask,
                    "has_mask": has_mask})
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tpudf_torch.data.datasets import load_sid_set, sid_example_to_arrays
    from tpudf_torch.data.pipeline import normalize_siglip
    from tpudf_torch.data.prefetch import prefetch
    from tpudf_torch.entry import build_mtl_trainer, mtl_params
    from tpudf_torch.eval.metrics import (PixelAUCBuffer, dice_iou,
                                          multiclass_metrics,
                                          sweep_mask_threshold)
    from tpudf_torch.train.checkpoint import save_checkpoint
    from tpudf_torch.train.loops import LoopConfig, run_training
    from tpudf_torch.train.mtl import dynamic_loss_weights

    device = torch.device(args.device)
    params = mtl_params(device, seed=args.seed, cfg_name=args.model_size,
                        embed_dim=args.embed_dim, seg_layers=args.seg_layers,
                        backbone_ckpt=args.backbone_ckpt)

    # dataset: local folder (images/ masks/ labels.csv) or HF SID_Set
    if args.data_dir:
        train_data = _load_local_sid(args.data_dir, "train", args.image_size)
        val_data = _load_local_sid(args.data_dir, "val", args.image_size)
        if args.subset_train < 1.0:
            k = max(int(len(train_data) * args.subset_train),
                    args.batch_size)
            train_data = train_data[:k]
    else:
        try:
            train_raw = load_sid_set("train")
            val_raw = load_sid_set("validation")
        except Exception as e:
            raise SystemExit(f"SID_Set unavailable ({e}); provide --data_dir")

        def materialize(raw, frac):
            n = len(raw)
            take = max(int(n * frac), args.batch_size)
            return [sid_example_to_arrays(raw[i], args.image_size)
                    for i in range(min(take, n))]

        train_data = materialize(train_raw, args.subset_train)
        val_data = materialize(val_raw, min(args.subset_train * 2, 1.0))

    def pixels_of(chunk):
        px = torch.from_numpy(np.stack([c["pixels"] for c in chunk]))
        return normalize_siglip(px.to(device))

    int8_frozen = args.int8_frozen and not args.no_freeze
    state, step, eval_step = build_mtl_trainer(
        params, cfg_name=args.model_size,
        freeze_below=None if args.no_freeze else args.freeze_below,
        int8_frozen=int8_frozen, embed_dim=args.embed_dim,
        seg_layers=args.seg_layers, lr=args.lr,
        total_steps=max(len(train_data) // args.batch_size, 1) * args.epochs,
        accum_steps=args.accum_steps, seg_loss=args.seg_loss,
        calib_pixels=pixels_of(train_data[:16]) if int8_frozen else None,
        image_size=args.image_size)
    state_box = {"state": state, "mask_thr": args.mask_thr}

    def batches(data, shuffle, seed):
        idx = np.arange(len(data))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        bs = args.batch_size
        for s in range(0, len(idx) - bs + 1, bs):
            chunk = [data[i] for i in idx[s:s + bs]]
            yield {
                "pixels": pixels_of(chunk),
                "cls": torch.tensor([c["cls"] for c in chunk],
                                    device=device),
                "mask": torch.from_numpy(np.stack([c["mask"] for c in chunk]))
                .to(device),
                "has_mask": torch.tensor([float(c["has_mask"])
                                          for c in chunk], device=device),
            }

    def train_epoch(epoch):
        cls_w, seg_w = dynamic_loss_weights(epoch, args.epochs)
        losses = []
        for i, b in enumerate(prefetch(
                batches(train_data, True, args.seed + epoch))):
            gen = torch.Generator(device=device).manual_seed(
                epoch * 7919 + i)
            state_box["state"], m = step(state_box["state"], b, gen, cls_w,
                                         seg_w)
            losses.append(float(m["loss"]))
        return {"loss": np.mean(losses) if losses else np.nan}

    def eval_epoch(epoch):
        all_cls, all_true = [], []
        dices, ious = [], []
        pix = PixelAUCBuffer()
        probs_cat, masks_cat = [], []
        for b in prefetch(batches(val_data, False, 0)):
            cls_logits, seg_probs = eval_step(state_box["state"].params,
                                              b["pixels"])
            all_cls.append(cls_logits.cpu().numpy())
            all_true.append(b["cls"].cpu().numpy())
            hm = b["has_mask"].cpu().numpy() > 0
            if hm.any():
                sp = seg_probs.cpu().numpy()[hm]
                tm = b["mask"].cpu().numpy()[hm]
                dd, ii = dice_iou((sp > state_box["mask_thr"])
                                  .astype(np.float32), tm)
                dices += list(dd)
                ious += list(ii)
                pix.add(sp, tm)
                probs_cat.append(sp)
                masks_cat.append(tm)
        m = multiclass_metrics(np.concatenate(all_true),
                               np.concatenate(all_cls))
        out = {"f1": m["macro_f1"], "acc": m["accuracy"],
               "dice": float(np.mean(dices)) if dices else 0.0,
               "iou": float(np.mean(ious)) if ious else 0.0,
               "pixel_auc": pix.auc()}
        if args.sweep_mask_thr and probs_cat:
            best = sweep_mask_threshold(np.concatenate(probs_cat),
                                        np.concatenate(masks_cat))
            state_box["mask_thr"] = best["threshold"]
            out["mask_thr"] = best["threshold"]
        return out

    def save_best(epoch, row):
        save_checkpoint(os.path.join(args.save_dir, "best"),
                        state_box["state"]._asdict() | {"epoch": epoch}, row)

    run_training(LoopConfig(epochs=args.epochs, patience=args.patience,
                            monitor="f1", save_dir=args.save_dir),
                 train_epoch, eval_epoch, save_best)


if __name__ == "__main__":
    main()
