"""Statistical validation: bootstrap CIs, significance tests, calibration.

A copy of tpudf/eval/stats.py (numpy only), kept here so that this
package imports nothing of `tpudf`.

Mirrors the reference publication-analysis suite
(hidf_video_classifier.py:736-842; inference_deepfakeface_complete.py:652).
"""

from __future__ import annotations

import numpy as np

from tpudf_torch.eval.metrics import binary_metrics, roc_auc


def bootstrap_ci(labels, probs, metric="auc", n_boot=1000, alpha=0.05,
                 seed=0, thr=0.5):
    """Percentile bootstrap CI for a binary metric
    (hidf_video_classifier.py:736-766)."""
    y = np.asarray(labels)
    p = np.asarray(probs)
    rng = np.random.default_rng(seed)
    vals = []
    n = len(y)
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        if metric == "auc":
            v = roc_auc(y[idx], p[idx])
        else:
            v = binary_metrics(y[idx], p[idx], thr)[metric]
        if np.isfinite(v):
            vals.append(v)
    if not vals:
        return {"point": float("nan"), "lo": float("nan"),
                "hi": float("nan"), "n_boot": n_boot, "alpha": alpha}
    vals = np.sort(vals)
    lo = vals[int(alpha / 2 * len(vals))]
    hi = vals[int((1 - alpha / 2) * len(vals)) - 1]
    point = roc_auc(y, p) if metric == "auc" else binary_metrics(y, p, thr)[metric]
    return {"point": float(point), "lo": float(lo), "hi": float(hi),
            "n_boot": n_boot, "alpha": alpha}


def binomial_test_vs_random(n_correct, n_total, p0=0.5):
    """Two-sided binomial significance vs chance
    (hidf_video_classifier.py:767-842 analogue; normal approximation with
    continuity correction — avoids a SciPy dependency)."""
    if n_total == 0:
        return float("nan")
    mean = n_total * p0
    sd = np.sqrt(n_total * p0 * (1 - p0))
    if sd == 0:
        return float(n_correct != mean)
    z = (abs(n_correct - mean) - 0.5) / sd
    # two-sided p-value via erfc
    from math import erfc, sqrt
    return float(erfc(z / sqrt(2)))


def mcnemar_test(correct_a, correct_b):
    """McNemar's test between two models' per-sample correctness vectors."""
    a = np.asarray(correct_a).astype(bool)
    b = np.asarray(correct_b).astype(bool)
    n01 = int((~a & b).sum())
    n10 = int((a & ~b).sum())
    n = n01 + n10
    if n == 0:
        return 1.0
    from math import erfc, sqrt
    z = (abs(n01 - n10) - 1) / sqrt(n)
    return float(erfc(max(z, 0.0) / sqrt(2)))


def expected_calibration_error(labels, probs, n_bins=10):
    """ECE over equal-width probability bins."""
    y = np.asarray(labels, np.float64)
    p = np.asarray(probs, np.float64)
    bins = np.clip((p * n_bins).astype(int), 0, n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        m = bins == b
        if m.sum() == 0:
            continue
        ece += m.mean() * abs(p[m].mean() - y[m].mean())
    return float(ece)


def reliability_curve(labels, probs, n_bins=10):
    """(bin_centers, mean_pred, frac_pos, counts) for calibration plots
    (inference_deepfakeface_complete.py:652)."""
    y = np.asarray(labels, np.float64)
    p = np.asarray(probs, np.float64)
    bins = np.clip((p * n_bins).astype(int), 0, n_bins - 1)
    centers, mp, fp, cnt = [], [], [], []
    for b in range(n_bins):
        m = bins == b
        centers.append((b + 0.5) / n_bins)
        cnt.append(int(m.sum()))
        mp.append(float(p[m].mean()) if m.any() else np.nan)
        fp.append(float(y[m].mean()) if m.any() else np.nan)
    return np.asarray(centers), np.asarray(mp), np.asarray(fp), np.asarray(cnt)


def isotonic_fit(scores, labels):
    """Pool-adjacent-violators isotonic regression (sklearn-free;
    inference_deepfakeface_complete.py:383-391). Returns (x_sorted, y_fit)
    usable with np.interp for calibration."""
    order = np.argsort(scores)
    x = np.asarray(scores, np.float64)[order]
    y = np.asarray(labels, np.float64)[order]
    w = np.ones_like(y)
    # PAV
    vals = list(y)
    wts = list(w)
    idx = [[i] for i in range(len(y))]
    i = 0
    while i < len(vals) - 1:
        if vals[i] > vals[i + 1] + 1e-12:
            tot = wts[i] + wts[i + 1]
            merged = (vals[i] * wts[i] + vals[i + 1] * wts[i + 1]) / tot
            vals[i:i + 2] = [merged]
            wts[i:i + 2] = [tot]
            idx[i:i + 2] = [idx[i] + idx[i + 1]]
            i = max(i - 1, 0)
        else:
            i += 1
    fit = np.empty_like(y)
    for v, members in zip(vals, idx):
        for m in members:
            fit[m] = v
    return x, fit


def apply_isotonic(x_fit, y_fit, scores):
    return np.interp(np.asarray(scores, np.float64), x_fit, y_fit,
                     left=y_fit[0] if len(y_fit) else 0.5,
                     right=y_fit[-1] if len(y_fit) else 0.5)
