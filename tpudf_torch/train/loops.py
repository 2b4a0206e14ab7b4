"""Generic epoch-loop engine: the L2 training toolkit as a reusable loop.

A copy of tpudf/train/loops.py (numpy only).

Re-designs the reference's per-script epoch loops (cifake :794-2295, hidf
:370-3285, sid :1094-1764) into one engine with:
  * warmup-cosine or plateau LR scheduling (train/steps.py optimizer)
  * EMA of trainable params
  * early stopping on a monitored metric with patience
  * progressive resizing hooks (per-epoch image-size ladder, static shapes
    per stage — the TPU answer to the reference's dynamic resize,
    cifake :1609-1635)
  * per-epoch CSV ledger + best-checkpoint saving
    (siglip2siddataset.py:1099-1105, 1563-1580)
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class LoopConfig:
    epochs: int = 10
    patience: int = 5
    monitor: str = "f1"
    mode: str = "max"
    save_dir: str | None = None
    csv_name: str = "training_log.csv"
    ckpt_name: str = "best"
    progressive_sizes: tuple | None = None   # e.g. (320, 384, 448)


class EarlyStopper:
    """Patience-based early stopping (hidf adaptive-patience analogue)."""

    def __init__(self, patience: int, mode="max"):
        self.patience = patience
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True if this value is a new best."""
        better = value > self.best if self.mode == "max" else value < self.best
        if better:
            self.best = value
            self.count = 0
            return True
        self.count += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.count >= self.patience


def epoch_size_for(cfg: LoopConfig, epoch: int, default_size: int) -> int:
    """Progressive-resize ladder: pick the stage size for this epoch."""
    if not cfg.progressive_sizes:
        return default_size
    stages = cfg.progressive_sizes
    stage = min(epoch * len(stages) // max(cfg.epochs, 1), len(stages) - 1)
    return stages[stage]


def run_training(
    cfg: LoopConfig,
    train_epoch_fn: Callable[[int], dict],
    eval_epoch_fn: Callable[[int], dict],
    save_fn: Callable[[int, dict], None] | None = None,
    log_fn: Callable[[str], None] = print,
):
    """Drive epochs; returns history list of merged metric dicts."""
    stopper = EarlyStopper(cfg.patience, cfg.mode)
    history = []
    csv_path = None
    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)
        csv_path = os.path.join(cfg.save_dir, cfg.csv_name)

    for epoch in range(cfg.epochs):
        t0 = time.time()
        train_metrics = train_epoch_fn(epoch)
        eval_metrics = eval_epoch_fn(epoch)
        row = {"epoch": epoch, "time_sec": round(time.time() - t0, 2),
               **{f"train_{k}": _f(v) for k, v in train_metrics.items()},
               **{f"val_{k}": _f(v) for k, v in eval_metrics.items()}}
        history.append(row)
        if csv_path:
            _append_csv(csv_path, row)

        monitored = eval_metrics.get(cfg.monitor)
        is_best = monitored is not None and stopper.update(float(monitored))
        log_fn(f"[epoch {epoch}] " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items() if k != "epoch"))
        if is_best and save_fn is not None:
            save_fn(epoch, {**row, "best": float(stopper.best)})
            log_fn(f"[epoch {epoch}] new best {cfg.monitor}={stopper.best:.4f}")
        if stopper.should_stop:
            log_fn(f"[early-stop] no {cfg.monitor} improvement for "
                   f"{cfg.patience} epochs")
            break
    return history


def _f(v):
    try:
        return float(v)
    except Exception:
        return v


def _append_csv(path, row: dict):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow(row)
