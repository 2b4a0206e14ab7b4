"""Evaluation metrics: classification, segmentation, streaming pixel-AUC.

A copy of tpudf/eval/metrics.py (numpy only, no framework), kept here so
that this package imports nothing of `tpudf`. Covers the reference metric
battery (hidf_video_classifier.py:430-840, siglip2siddataset.py:1053-1092,
1514-1561): acc/precision/recall/F1/AUC/AP/MCC, dice/IoU, reservoir-sampled
pixel-level AUC, and threshold sweeps.
"""

from __future__ import annotations

import numpy as np


def roc_auc(labels, scores):
    """Rank-based ROC-AUC (ties handled by midranks)."""
    y = np.asarray(labels).astype(bool)
    s = np.asarray(scores, np.float64)
    n_pos = int(y.sum())
    n_neg = int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    ranks[order] = np.arange(1, len(s) + 1)
    # midranks for ties
    s_sorted = s[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision(labels, scores):
    y = np.asarray(labels).astype(bool)
    s = np.asarray(scores, np.float64)
    if y.sum() == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    return float((precision * y).sum() / y.sum())


def binary_metrics(labels, probs, thr=0.5):
    """Full binary battery (hidf evaluate(): 11 metrics)."""
    y = np.asarray(labels).astype(int)
    p = np.asarray(probs, np.float64)
    pred = (p >= thr).astype(int)
    tp = int(((pred == 1) & (y == 1)).sum())
    tn = int(((pred == 0) & (y == 0)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    eps = 1e-12
    prec = tp / (tp + fp + eps)
    rec = tp / (tp + fn + eps)
    spec = tn / (tn + fp + eps)
    f1 = 2 * prec * rec / (prec + rec + eps)
    mcc_den = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    mcc = ((tp * tn - fp * fn) / mcc_den) if mcc_den > 0 else 0.0
    bal_acc = 0.5 * (rec + spec)
    return {
        "accuracy": (tp + tn) / max(len(y), 1),
        "precision": prec, "recall": rec, "specificity": spec,
        "f1": f1, "mcc": float(mcc), "balanced_accuracy": bal_acc,
        "auc": roc_auc(y, p), "ap": average_precision(y, p),
        "tp": tp, "tn": tn, "fp": fp, "fn": fn,
        "n": len(y), "threshold": thr,
    }


def multiclass_metrics(labels, logits_or_preds):
    """3-class accuracy + per-class F1 + confusion matrix
    (siglip2siddataset.py:1514-1533)."""
    y = np.asarray(labels).astype(int)
    a = np.asarray(logits_or_preds)
    pred = a.argmax(-1).astype(int) if a.ndim == 2 else a.astype(int)
    k = int(max(y.max(initial=0), pred.max(initial=0))) + 1
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (y, pred), 1)
    per_class_f1 = []
    for c in range(k):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        per_class_f1.append(2 * tp / max(2 * tp + fp + fn, 1))
    return {"accuracy": float((pred == y).mean()) if len(y) else float("nan"),
            "macro_f1": float(np.mean(per_class_f1)),
            "per_class_f1": [float(f) for f in per_class_f1],
            "confusion": cm}


def dice_iou(pred_mask, true_mask, eps=1e-6):
    """Per-sample hard dice/IoU; masks (B, H, W) in {0,1}."""
    p = np.asarray(pred_mask).reshape(len(pred_mask), -1)
    t = np.asarray(true_mask).reshape(len(true_mask), -1)
    inter = (p * t).sum(1)
    dice = 2 * inter / (p.sum(1) + t.sum(1) + eps)
    iou = inter / ((p + t - p * t).sum(1) + eps)
    return dice, iou


class PixelAUCBuffer:
    """Reservoir-sampled streaming pixel-level localization AUC
    (siglip2siddataset.py:1053-1092; 400k pixel cap)."""

    def __init__(self, cap=400_000, seed=0):
        self.cap = int(cap)
        self.scores = np.empty(self.cap, np.float32)
        self.labels = np.empty(self.cap, np.int8)
        self.n_seen = 0
        self.rng = np.random.default_rng(seed)

    def add(self, probs, masks):
        p = np.asarray(probs).ravel()
        y = np.asarray(masks).ravel().astype(np.int8)
        for i in range(0, len(p), 1 << 20):
            self._add_chunk(p[i:i + (1 << 20)], y[i:i + (1 << 20)])

    def _add_chunk(self, p, y):
        k = len(p)
        fill = min(self.cap - self.n_seen, k) if self.n_seen < self.cap else 0
        if fill > 0:
            self.scores[self.n_seen:self.n_seen + fill] = p[:fill]
            self.labels[self.n_seen:self.n_seen + fill] = y[:fill]
            self.n_seen += fill
            p, y = p[fill:], y[fill:]
        if len(p) == 0:
            return
        # reservoir replacement for the remainder
        idx_stream = self.n_seen + np.arange(len(p))
        accept = self.rng.random(len(p)) < self.cap / (idx_stream + 1)
        targets = self.rng.integers(0, self.cap, len(p))
        sel = np.flatnonzero(accept)
        self.scores[targets[sel]] = p[sel]
        self.labels[targets[sel]] = y[sel]
        self.n_seen += len(p)

    def auc(self):
        n = min(self.n_seen, self.cap)
        if n == 0:
            return float("nan")
        return roc_auc(self.labels[:n], self.scores[:n])


def sweep_mask_threshold(probs, masks, thresholds=None):
    """Mask-threshold sweep for best F1/dice/IoU
    (siglip2siddataset.py:204-240, 1533-1552). probs/masks: (B, H, W)."""
    if thresholds is None:
        thresholds = np.linspace(0.1, 0.9, 17)
    best = {"threshold": 0.5, "f1": -1.0, "dice": 0.0, "iou": 0.0}
    p = np.asarray(probs)
    t = np.asarray(masks)
    for thr in thresholds:
        pb = (p > thr).astype(np.float32)
        d, i = dice_iou(pb, t)
        tp = (pb * t).sum()
        prec = tp / max(pb.sum(), 1e-6)
        rec = tp / max(t.sum(), 1e-6)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        if f1 > best["f1"]:
            best = {"threshold": float(thr), "f1": float(f1),
                    "dice": float(d.mean()), "iou": float(i.mean())}
    return best


def optimal_threshold(labels, probs, metric="f1", grid=None):
    """F1-optimal / Youden / precision-constrained threshold search
    (inference_deepfakeface_complete.py:392-478,
    inference_ai_human_images.py:409-434)."""
    y = np.asarray(labels).astype(int)
    p = np.asarray(probs, np.float64)
    if grid is None:
        grid = np.linspace(0.05, 0.95, 181)
    best_t, best_v = 0.5, -np.inf
    for t in grid:
        pred = (p >= t).astype(int)
        tp = ((pred == 1) & (y == 1)).sum()
        fp = ((pred == 1) & (y == 0)).sum()
        fn = ((pred == 0) & (y == 1)).sum()
        tn = ((pred == 0) & (y == 0)).sum()
        eps = 1e-12
        if metric == "f1":
            v = 2 * tp / max(2 * tp + fp + fn, 1)
        elif metric == "youden":
            v = tp / (tp + fn + eps) + tn / (tn + fp + eps) - 1
        elif metric == "balanced_accuracy":
            v = 0.5 * (tp / (tp + fn + eps) + tn / (tn + fp + eps))
        else:
            raise ValueError(metric)
        if v > best_v:
            best_t, best_v = float(t), float(v)
    return best_t, best_v


def precision_constrained_threshold(labels, probs, min_precision=0.9):
    """Highest-recall threshold subject to precision >= min_precision
    (inference_ai_human_images.py:409-424)."""
    y = np.asarray(labels).astype(int)
    p = np.asarray(probs, np.float64)
    best_t, best_rec = None, -1.0
    for t in np.linspace(0.05, 0.99, 189):
        pred = (p >= t).astype(int)
        tp = ((pred == 1) & (y == 1)).sum()
        fp = ((pred == 1) & (y == 0)).sum()
        fn = ((pred == 0) & (y == 1)).sum()
        if tp + fp == 0:
            continue
        prec = tp / (tp + fp)
        rec = tp / max(tp + fn, 1)
        if prec >= min_precision and rec > best_rec:
            best_t, best_rec = float(t), float(rec)
    return best_t, best_rec
