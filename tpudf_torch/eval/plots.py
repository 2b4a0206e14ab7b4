"""Publication inference-plot suite (tpudf/eval/plots.py).

A copy of the JAX package's module (host numpy and matplotlib, Agg),
kept here so that this package imports nothing of `tpudf`. The figures of
the reference's 12-figure inference report
(inference_deepfakeface_complete.py:479-827): confusion matrices (raw +
row-normalized), ROC, PR, probability distribution, threshold analysis,
calibration curve, method comparison, combined curves, per-class
comparison and headline-metric bars, all written by one
`render_inference_report` call under the JAX package's file names. The
curves come from the same metric primitives as the CLI evals
(eval/metrics.py, eval/stats.py), so the figures and the JSON reports
agree.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from tpudf_torch.eval.metrics import (average_precision, binary_metrics,
                                optimal_threshold, roc_auc)
from tpudf_torch.eval.stats import reliability_curve

CLASS_NAMES = ("REAL", "FAKE")


def figures_available() -> bool:
    """Whether matplotlib is installed: the figures need it, the metrics
    do not."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, save_dir, name):
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def _tie_boundaries(s_sorted):
    """Indices (into the cumsum arrays) of the LAST sample of each distinct
    score — curve vertices must only sit at thresholds between distinct
    scores, or tied scores draw a per-sample staircase that disagrees with
    the midrank AUC/AP shown in the legend (all-equal scores must plot as
    the chance diagonal, not a corner)."""
    return np.nonzero(np.append(s_sorted[1:] != s_sorted[:-1], True))[0]


def roc_points(labels, scores):
    """(fpr, tpr) arrays over score-sorted thresholds (exact, no binning;
    tied scores collapse to one curve vertex)."""
    y = np.asarray(labels, np.float64)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    cut = _tie_boundaries(s)
    tp = np.cumsum(y)[cut]
    fp = np.cumsum(1 - y)[cut]
    P, N = max(tp[-1], 1e-12), max(fp[-1], 1e-12)
    tpr = np.concatenate([[0.0], tp / P])
    fpr = np.concatenate([[0.0], fp / N])
    return fpr, tpr


def pr_points(labels, scores):
    """(recall, precision) arrays over descending score thresholds (tied
    scores collapse to one curve vertex)."""
    y = np.asarray(labels, np.float64)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    cut = _tie_boundaries(s)
    tp = np.cumsum(y)[cut]
    k = cut + 1.0
    precision = tp / k
    recall = tp / max(tp[-1], 1e-12)
    return np.concatenate([[0.0], recall]), \
        np.concatenate([[1.0], precision])


# ------------------------------------------------------------- figures

def plot_confusion(labels, preds, save_dir, normalized=False,
                   class_names=CLASS_NAMES, name=None):
    """Confusion matrix, optionally row-normalized
    (inference_deepfakeface_complete.py:479-521)."""
    plt = _plt()
    y = np.asarray(labels).astype(int)
    p = np.asarray(preds).astype(int)
    n = len(class_names)
    cm = np.zeros((n, n), np.float64)
    for a, b in zip(y, p):
        cm[a, b] += 1
    show = cm / np.maximum(cm.sum(1, keepdims=True), 1) if normalized else cm
    fig, ax = plt.subplots(figsize=(4.2, 4))
    im = ax.imshow(show, cmap="Blues",
                   vmin=0, vmax=(1.0 if normalized else None))
    for i in range(n):
        for j in range(n):
            txt = f"{show[i, j]:.2f}" if normalized else f"{int(cm[i, j])}"
            ax.text(j, i, txt, ha="center", va="center", fontsize=10,
                    color="white" if show[i, j] > 0.6 * show.max() else "black")
    ax.set_xticks(range(n), class_names)
    ax.set_yticks(range(n), class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title("Confusion matrix" + (" (normalized)" if normalized else ""))
    fig.colorbar(im, fraction=0.046)
    return _save(fig, save_dir, name or (
        "confusion_matrix_normalized.png" if normalized
        else "confusion_matrix.png"))


def plot_roc(labels, probs, save_dir, name="roc_curve.png"):
    """ROC with AUC annotation (ref :527-548)."""
    plt = _plt()
    fpr, tpr = roc_points(labels, probs)
    auc = roc_auc(labels, probs)
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.plot(fpr, tpr, lw=2, label=f"AUC = {auc:.4f}")
    ax.plot([0, 1], [0, 1], "--", color="gray", lw=1, label="chance")
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.set_title("ROC curve")
    ax.legend(loc="lower right")
    return _save(fig, save_dir, name)


def plot_precision_recall(labels, probs, save_dir,
                          name="precision_recall_curve.png"):
    """PR curve with AP annotation (ref :555-574)."""
    plt = _plt()
    rec, prec = pr_points(labels, probs)
    ap = average_precision(labels, probs)
    base = float(np.mean(labels))
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.plot(rec, prec, lw=2, label=f"AP = {ap:.4f}")
    ax.axhline(base, ls="--", color="gray", lw=1,
               label=f"prevalence = {base:.2f}")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_ylim(0, 1.02)
    ax.set_title("Precision-recall curve")
    ax.legend(loc="lower left")
    return _save(fig, save_dir, name)


def plot_probability_distribution(labels, probs, save_dir, threshold=0.5,
                                  name="probability_distribution.png"):
    """Per-class p(fake) histograms with the decision threshold
    (ref :581-605)."""
    plt = _plt()
    y = np.asarray(labels)
    p = np.asarray(probs)
    fig, ax = plt.subplots(figsize=(5.4, 4))
    bins = np.linspace(0, 1, 41)
    ax.hist(p[y < 0.5], bins=bins, alpha=0.6, label="REAL", color="#2a7")
    ax.hist(p[y >= 0.5], bins=bins, alpha=0.6, label="FAKE", color="#d43")
    ax.axvline(threshold, color="black", ls="--", lw=1.2,
               label=f"threshold {threshold:.3f}")
    ax.set_xlabel("p(fake)")
    ax.set_ylabel("count")
    ax.set_title("Predicted probability distribution")
    ax.legend()
    return _save(fig, save_dir, name)


def plot_threshold_analysis(labels, probs, save_dir, threshold=None,
                            name="threshold_analysis.png"):
    """Accuracy / precision / recall / F1 vs threshold with the selected
    operating point (ref :611-646)."""
    plt = _plt()
    grid = np.linspace(0.02, 0.98, 97)
    curves = {"accuracy": [], "precision": [], "recall": [], "f1": []}
    for t in grid:
        m = binary_metrics(labels, probs, thr=float(t))
        for k in curves:
            curves[k].append(m[k])
    if threshold is None:
        threshold, _ = optimal_threshold(labels, probs, metric="f1")
    fig, ax = plt.subplots(figsize=(5.6, 4))
    for k, v in curves.items():
        ax.plot(grid, v, lw=1.6, label=k)
    ax.axvline(threshold, color="black", ls="--", lw=1.2,
               label=f"selected {threshold:.3f}")
    ax.set_xlabel("decision threshold")
    ax.set_ylabel("metric")
    ax.set_title("Metrics vs decision threshold")
    ax.legend(fontsize=8)
    return _save(fig, save_dir, name)


def plot_calibration(labels, probs_uncal, save_dir, probs_cal=None,
                     n_bins=10, name="calibration_curve.png"):
    """Reliability diagram, before/after calibration (ref :652-678)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.plot([0, 1], [0, 1], "--", color="gray", lw=1, label="perfect")
    for tag, probs in (("uncalibrated", probs_uncal),
                       ("calibrated", probs_cal)):
        if probs is None:
            continue
        _, mean_pred, frac_pos, _ = reliability_curve(labels, probs, n_bins)
        ok = ~(np.isnan(mean_pred) | np.isnan(frac_pos))
        ax.plot(mean_pred[ok], frac_pos[ok], "o-", lw=1.6, label=tag)
    ax.set_xlabel("mean predicted p(fake)")
    ax.set_ylabel("observed fake fraction")
    ax.set_title("Probability calibration")
    ax.legend(loc="upper left", fontsize=8)
    return _save(fig, save_dir, name)


def plot_method_comparison(methods: dict, save_dir,
                           name="method_comparison.png"):
    """Grouped accuracy/F1 bars over named methods (base vs TTA vs
    calibrated vs few-shot — ref :684-711). methods: name → metrics dict."""
    plt = _plt()
    names = list(methods)
    acc = [methods[m]["accuracy"] for m in names]
    f1 = [methods[m]["f1"] for m in names]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(1.4 + 1.3 * len(names), 4))
    ax.bar(x - 0.18, acc, width=0.36, label="accuracy", color="#47a")
    ax.bar(x + 0.18, f1, width=0.36, label="F1", color="#e84")
    for xi, (a, f) in enumerate(zip(acc, f1)):
        ax.text(xi - 0.18, a + 0.005, f"{a:.3f}", ha="center", fontsize=7)
        ax.text(xi + 0.18, f + 0.005, f"{f:.3f}", ha="center", fontsize=7)
    ax.set_xticks(x, names, rotation=20, ha="right", fontsize=8)
    ax.set_ylim(0, 1.08)
    ax.set_title("Method comparison")
    ax.legend(fontsize=8)
    return _save(fig, save_dir, name)


def plot_combined_curves(labels, probs, save_dir,
                         name="combined_curves.png"):
    """ROC + PR side by side (ref :717-753)."""
    plt = _plt()
    fpr, tpr = roc_points(labels, probs)
    rec, prec = pr_points(labels, probs)
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    axes[0].plot(fpr, tpr, lw=2,
                 label=f"AUC = {roc_auc(labels, probs):.4f}")
    axes[0].plot([0, 1], [0, 1], "--", color="gray", lw=1)
    axes[0].set_title("ROC")
    axes[0].set_xlabel("FPR")
    axes[0].set_ylabel("TPR")
    axes[0].legend(loc="lower right", fontsize=8)
    axes[1].plot(rec, prec, lw=2,
                 label=f"AP = {average_precision(labels, probs):.4f}")
    axes[1].set_title("Precision-recall")
    axes[1].set_xlabel("recall")
    axes[1].set_ylabel("precision")
    axes[1].legend(loc="lower left", fontsize=8)
    return _save(fig, save_dir, name)


def plot_class_comparison(labels, preds, save_dir,
                          class_names=CLASS_NAMES,
                          name="class_comparison.png"):
    """Per-class precision/recall/F1 bars (ref :759-790)."""
    plt = _plt()
    y = np.asarray(labels).astype(int)
    p = np.asarray(preds).astype(int)
    rows = []
    for c in range(len(class_names)):
        tp = np.sum((p == c) & (y == c))
        prec = tp / max(np.sum(p == c), 1e-12)
        rec = tp / max(np.sum(y == c), 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        rows.append((prec, rec, f1))
    x = np.arange(len(class_names))
    fig, ax = plt.subplots(figsize=(5.2, 4))
    for i, (metric, off) in enumerate(
            (("precision", -0.25), ("recall", 0.0), ("F1", 0.25))):
        vals = [r[i] for r in rows]
        ax.bar(x + off, vals, width=0.24, label=metric)
        for xi, v in zip(x + off, vals):
            ax.text(xi, v + 0.005, f"{v:.3f}", ha="center", fontsize=7)
    ax.set_xticks(x, class_names)
    ax.set_ylim(0, 1.08)
    ax.set_title("Per-class metrics")
    ax.legend(fontsize=8)
    return _save(fig, save_dir, name)


def plot_metrics_bars(metrics: dict, save_dir,
                      name="metrics_comparison.png"):
    """Headline-metric bar chart (ref :796-827)."""
    plt = _plt()
    keys = [k for k in ("accuracy", "precision", "recall", "f1", "auc",
                        "ap", "mcc") if k in metrics]
    vals = [float(metrics[k]) for k in keys]
    fig, ax = plt.subplots(figsize=(1.2 + 0.9 * len(keys), 4))
    bars = ax.bar(keys, vals, color="#47a")
    for b, v in zip(bars, vals):
        ax.text(b.get_x() + b.get_width() / 2, v + 0.005, f"{v:.4f}",
                ha="center", fontsize=8)
    ax.set_ylim(0, 1.1)
    ax.set_title("Evaluation metrics")
    return _save(fig, save_dir, name)


# --------------------------------------------------------- orchestrator

def render_inference_report(labels, probs, save_dir, *, probs_cal=None,
                            threshold=None, methods=None,
                            class_names=CLASS_NAMES):
    """Emit the full inference figure suite from one (labels, probs) pair —
    the tpudf analogue of the reference's main() plot block
    (inference_deepfakeface_complete.py:1057-1375). Returns
    {figure_name: path}. `methods` optionally adds the base-vs-enhanced
    comparison bars; `probs_cal` adds the calibrated reliability curve."""
    labels = np.asarray(labels, np.float64)
    probs = np.asarray(probs, np.float64)
    if threshold is None:
        threshold, _ = optimal_threshold(labels, probs, metric="f1")
    preds = (probs >= threshold).astype(int)
    out = {
        "confusion": plot_confusion(labels, preds, save_dir,
                                    class_names=class_names),
        "confusion_normalized": plot_confusion(
            labels, preds, save_dir, normalized=True,
            class_names=class_names),
        "roc": plot_roc(labels, probs, save_dir),
        "pr": plot_precision_recall(labels, probs, save_dir),
        "probability_distribution": plot_probability_distribution(
            labels, probs, save_dir, threshold=threshold),
        "threshold_analysis": plot_threshold_analysis(
            labels, probs, save_dir, threshold=threshold),
        "calibration": plot_calibration(labels, probs, save_dir,
                                        probs_cal=probs_cal),
        "combined": plot_combined_curves(labels, probs, save_dir),
        "class_comparison": plot_class_comparison(
            labels, preds, save_dir, class_names=class_names),
    }
    # metrics bars use the SAME (probs, threshold) pair as the confusion
    # figures — evaluating calibrated probs at an uncalibrated-optimal
    # threshold made the report's own figures disagree (r3 review);
    # probs_cal only drives the reliability curve
    m = binary_metrics(labels, probs, thr=float(threshold))
    m["auc"] = roc_auc(labels, probs)
    m["ap"] = average_precision(labels, probs)
    out["metrics"] = plot_metrics_bars(m, save_dir)
    if methods:
        out["method_comparison"] = plot_method_comparison(methods, save_dir)
    return out
