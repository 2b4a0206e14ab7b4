"""Training-analysis suite (tpudf/eval/analysis.py): overfitting
diagnostics, MC-dropout uncertainty, learning-vs-memorization probes,
publication plots.

Host numpy and matplotlib (Agg), copied from the JAX package so that this
package imports nothing of `tpudf`:
  * overfitting 0-10 score dashboard      (hidf_video_classifier.py:1563-2033)
  * RealTimeTrainingMonitor trend detector (cifake_binary_classifier.py:286-573)
  * MC-dropout uncertainty (train-mode, N passes) (hidf :1012-1141): pass i
    draws its dropout from torch.Generator(device).manual_seed(seed * 1000
    + i), JAX's key schedule with torch's draws
  * per-frame-position temporal analysis  (hidf :1142-1230)
  * learning-vs-memorization probes: data-efficiency curve + shuffled-label
    memorization check                    (hidf :2034-2804)
  * activation capture for the classifier heads through their `acts`
    hooks (models/heads.py), the reference's forward hooks (hidf
    :2152-2212), on the heads' own device
  * the learning-vs-memorization metric battery + 0-10 score and the
    16-panel dashboard figure              (hidf :2034-2804)
  * training-curve / confusion-matrix plots (matplotlib, saved to disk)

The inference figure suite (ROC/PR/calibration/threshold/confusion/...)
lives in eval/plots.py.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch


def _f64(a) -> np.ndarray:
    """A tensor (any device) or an array as float64 numpy."""
    if torch.is_tensor(a):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


# ----------------------------------------------------------- overfitting

def overfitting_score(history: Sequence[dict],
                      train_key="train_loss", val_key="val_loss",
                      train_acc_key="train_acc", val_acc_key="val_f1"):
    """0-10 overfitting severity from the epoch history (0 = healthy).

    Components (hidf dashboard semantics): generalization gap size & growth,
    val-loss divergence (val rising while train falls), and val-metric
    stagnation vs train improvement.
    """
    tr = [h[train_key] for h in history if train_key in h]
    va = [h[val_key] for h in history if val_key in h]
    score = 0.0
    detail = {}
    if len(tr) >= 3 and len(va) >= 3:
        gap = np.asarray(va[-3:]).mean() - np.asarray(tr[-3:]).mean()
        rel_gap = gap / (abs(np.asarray(tr[-3:]).mean()) + 1e-8)
        detail["loss_gap"] = float(gap)
        score += float(np.clip(rel_gap * 4.0, 0, 3))
        # divergence: val slope up, train slope down
        v_slope = np.polyfit(np.arange(len(va)), va, 1)[0]
        t_slope = np.polyfit(np.arange(len(tr)), tr, 1)[0]
        detail["val_slope"] = float(v_slope)
        detail["train_slope"] = float(t_slope)
        if v_slope > 0 and t_slope < 0:
            score += float(np.clip(v_slope / (abs(t_slope) + 1e-8), 0, 4))
    ta = [h[train_acc_key] for h in history if train_acc_key in h]
    vf = [h[val_acc_key] for h in history if val_acc_key in h]
    if len(ta) >= 3 and len(vf) >= 3:
        acc_gap = np.asarray(ta[-3:]).mean() - np.asarray(vf[-3:]).mean()
        detail["metric_gap"] = float(acc_gap)
        score += float(np.clip(acc_gap * 10.0, 0, 3))
    return float(np.clip(score, 0.0, 10.0)), detail


class TrainingMonitor:
    """Live trend-based overfitting detector
    (cifake RealTimeTrainingMonitor :286-573): keeps the history, flags when
    val loss has risen for `patience` consecutive epochs while train falls,
    and renders live curves."""

    def __init__(self, save_dir=None, patience=3):
        self.history: list[dict] = []
        self.save_dir = save_dir
        self.patience = patience

    def update(self, epoch_metrics: dict) -> dict:
        self.history.append(dict(epoch_metrics))
        score, detail = overfitting_score(self.history)
        flags = {"overfitting_score": score, **detail}
        va = [h.get("val_loss") for h in self.history
              if h.get("val_loss") is not None]
        if len(va) > self.patience:
            rising = all(va[-i] > va[-i - 1]
                         for i in range(1, self.patience + 1))
            flags["val_loss_rising"] = bool(rising)
        if self.save_dir:
            plot_training_curves(self.history, self.save_dir)
        return flags


# ------------------------------------------------------------ mc dropout

def mc_dropout_uncertainty(forward_with_generator: Callable, inputs,
                           n_passes=10, seed=0):
    """Run a dropout-active forward N times and report per-sample mean
    prob, std, and predictive entropy (hidf :1012-1141). Pass i draws from
    torch.Generator(device=inputs.device).manual_seed(seed * 1000 + i),
    the JAX package's key schedule (jax.random.key(seed * 1000 + i)).

    forward_with_generator(inputs, generator) must return logits (B,)."""
    probs = []
    for i in range(n_passes):
        gen = torch.Generator(device=inputs.device).manual_seed(
            seed * 1000 + i)
        z = forward_with_generator(inputs, gen)
        probs.append(1.0 / (1.0 + np.exp(-_f64(z))))
    p = np.stack(probs)                       # (N, B)
    mean = p.mean(0)
    std = p.std(0)
    eps = 1e-9
    entropy = -(mean * np.log(mean + eps)
                + (1 - mean) * np.log(1 - mean + eps))
    return {"mean_prob": mean, "std_prob": std, "entropy": entropy,
            "n_passes": n_passes}


# -------------------------------------------------- temporal position

def temporal_position_analysis(per_frame_probs, labels, thr=0.5):
    """Per-frame-position accuracy/confidence (hidf :1142-1230).
    per_frame_probs: (N, T) per-video per-position fake probs."""
    p = np.asarray(per_frame_probs)
    y = np.asarray(labels)[:, None]
    correct = ((p >= thr) == (y > 0.5)).astype(np.float64)
    return {"position_accuracy": correct.mean(0).tolist(),
            "position_mean_prob": p.mean(0).tolist(),
            "position_std_prob": p.std(0).tolist()}


# --------------------------------------------- learning vs memorization

def data_efficiency_probe(train_eval_fn: Callable[[np.ndarray], float],
                          n_train: int, fractions=(0.1, 0.25, 0.5, 1.0),
                          seed=0):
    """AUC as a function of training-set size. A memorizing model is flat or
    degrades; a learning model improves with data (hidf learning-vs-
    memorization 16-panel core). train_eval_fn(indices) → val AUC."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_train)
    out = []
    for f in fractions:
        k = max(int(n_train * f), 2)
        out.append({"fraction": f, "n": k,
                    "auc": float(train_eval_fn(perm[:k]))})
    aucs = [o["auc"] for o in out]
    verdict = "learning" if aucs[-1] > aucs[0] + 0.02 else (
        "flat" if abs(aucs[-1] - aucs[0]) <= 0.02 else "memorizing")
    return {"curve": out, "verdict": verdict}


def label_shuffle_probe(train_eval_fn: Callable[[np.ndarray], float],
                        labels: np.ndarray, seed=0):
    """Fit with shuffled labels: val AUC should collapse to ~0.5 for a
    generalizing pipeline; far above 0.5 implies leakage/memorization."""
    rng = np.random.default_rng(seed)
    shuffled = labels.copy()
    rng.shuffle(shuffled)
    auc = float(train_eval_fn(shuffled))
    return {"shuffled_label_auc": auc,
            "leak_suspected": bool(auc > 0.65)}


# --------------------------------------------- activation statistics

def _head_input(params, features):
    """The features on the head's device, in their own dtype (the bf16
    tower's features stay bf16, as the train and eval steps pass them)."""
    return torch.as_tensor(features, device=params["ln"]["scale"].device)


@torch.no_grad()
def binary_head_activations(params, features):
    """Per-layer activation capture for the v5 binary head, the
    reference's forward hooks on the classifier's Linear layers
    (hidf_video_classifier.py:2152-2199): models/heads.apply_binary_head's
    acts hook (eval mode), so there is one copy of the head math."""
    from tpudf_torch.models.heads import apply_binary_head

    acts = {}
    apply_binary_head(params, _head_input(params, features), acts=acts)
    return acts


@torch.no_grad()
def video_head_activations(params, frame_features):
    """Activation capture for the HiDF video head through
    models/heads.apply_video_head's acts hook (eval mode), so the
    statistics describe the head being trained."""
    from tpudf_torch.models.heads import apply_video_head

    acts = {}
    apply_video_head(params, _head_input(params, frame_features), acts=acts)
    return acts


def activation_statistics(acts: dict):
    """Aggregate mean/std/sparsity per captured layer plus the reference's
    feature-learning summary: activation_diversity (mean std),
    activation_sparsity (mean zero-fraction) and
    feature_learning_score = diversity * (1 - sparsity)
    (hidf :2203-2212)."""
    per_layer = {}
    stds, sparsities = [], []
    for name, a in acts.items():
        a = _f64(a)
        st = float(a.std())
        sp = float((np.abs(a) < 1e-8).mean())
        per_layer[name] = {"mean": float(a.mean()), "std": st,
                           "sparsity": sp}
        stds.append(st)
        sparsities.append(sp)
    diversity = float(np.mean(stds)) if stds else 0.0
    sparsity = float(np.mean(sparsities)) if sparsities else 0.0
    return {"per_layer": per_layer,
            "activation_diversity": diversity,
            "activation_sparsity": sparsity,
            "feature_learning_score": diversity * (1.0 - sparsity)}


# ------------------------------------ memorization score + dashboard

def _smooth(xs, window):
    return np.convolve(xs, np.ones(window) / window, mode="valid")


def learning_memorization_metrics(history, train_probs=None, val_probs=None,
                                  activation_stats=None,
                                  data_efficiency=None,
                                  train_key="train_loss",
                                  val_key="val_loss"):
    """The six-part learning-vs-memorization analysis
    (hidf_video_classifier.py:2034-2330), from already-collected evidence:

      history            epoch dicts with train/val losses
      train_probs/val_probs  sampled sigmoid outputs on each split
      activation_stats   output of `activation_statistics`
      data_efficiency    output of `data_efficiency_probe`

    Returns the reference's metric dict: generalization gap/ratio, learning
    curve slopes + consistency, confidence gap/overconfidence ratio,
    memorization_score (0-10), learning_score, learning_type and
    confidence label."""
    m: dict = {}
    tr = np.asarray([h[train_key] for h in history if train_key in h],
                    np.float64)
    va = np.asarray([h[val_key] for h in history if val_key in h],
                    np.float64)

    # 1. generalization gap (ref :2044-2050)
    if len(tr) and len(va):
        m["generalization_gap"] = float(va[-1] - tr[-1])
        m["generalization_ratio"] = float(va[-1] / max(tr[-1], 1e-8))

    # 2. learning-curve shape (ref :2052-2076)
    if len(tr) >= 6 and len(va) >= 6:
        window = max(2, min(5, len(tr) // 3))
        ts, vs = _smooth(tr, window), _smooth(va, window)
        mid = len(ts) // 2
        sl = lambda y, a, b: float(
            np.polyfit(np.arange(a, b), y[a:b], 1)[0])
        m["early_train_slope"] = sl(ts, 0, mid)
        m["late_train_slope"] = sl(ts, mid, len(ts))
        m["early_val_slope"] = sl(vs, 0, min(mid, len(vs)))
        m["late_val_slope"] = sl(vs, min(mid, len(vs)), len(vs))
        m["learning_consistency"] = abs(m["early_train_slope"]) / max(
            abs(m["late_train_slope"]), 1e-8)
        m["val_follows_train"] = bool(
            m["early_train_slope"] < 0 and m["early_val_slope"] < 0
            and m["late_val_slope"] <= 0)
        if len(tr) == len(va):
            m["train_val_correlation"] = float(np.corrcoef(tr, va)[0, 1])

    # 3. data efficiency (ref :2079-2144 — probe result passed in)
    if data_efficiency:
        aucs = [c["auc"] for c in data_efficiency["curve"]]
        m["data_efficiency_curve"] = aucs
        m["quick_learner"] = bool(
            data_efficiency["verdict"] == "learning"
            or (len(aucs) >= 2 and aucs[0] > 0.7))

    # 4. feature learning (ref :2146-2212)
    if activation_stats:
        m["activation_diversity"] = activation_stats["activation_diversity"]
        m["activation_sparsity"] = activation_stats["activation_sparsity"]
        m["feature_learning_score"] = \
            activation_stats["feature_learning_score"]

    # 5. prediction confidence (ref :2214-2279)
    if train_probs is not None and val_probs is not None:
        tc = np.abs(np.asarray(train_probs, np.float64) - 0.5)
        vc = np.abs(np.asarray(val_probs, np.float64) - 0.5)
        m["train_confidence"] = float(tc.mean())
        m["val_confidence"] = float(vc.mean())
        m["confidence_gap"] = float(tc.mean() - vc.mean())
        m["overconfidence_ratio"] = float(tc.mean() / max(vc.mean(), 1e-8))

    # 6. 0-10 memorization score (ref :2283-2330 weights)
    score = 0.0
    if m.get("generalization_gap", 0.0) > 0.2:
        score += min(m["generalization_gap"] * 10, 3)
    if not m.get("quick_learner", True):
        score += 2
    if m.get("feature_learning_score", 1.0) < 0.1:
        score += 2
    if m.get("overconfidence_ratio", 1.0) > 1.5:
        score += min((m["overconfidence_ratio"] - 1) * 2, 2)
    if not m.get("val_follows_train", True):
        score += 1
    m["memorization_score"] = float(min(score, 10))
    m["learning_score"] = 10 - m["memorization_score"]
    if score < 3:
        m["learning_type"], m["confidence"] = "LEARNING", "HIGH"
    elif score < 5:
        m["learning_type"], m["confidence"] = "MIXED", "MODERATE"
    elif score < 7:
        m["learning_type"], m["confidence"] = "MEMORIZING", "MODERATE"
    else:
        m["learning_type"], m["confidence"] = "MEMORIZING", "HIGH"
    return m


def plot_memorization_dashboard(metrics, history, save_dir,
                                train_probs=None, val_probs=None,
                                n_params=None,
                                train_key="train_loss", val_key="val_loss",
                                name="learning_vs_memorization.png"):
    """The 16-panel learning-vs-memorization dashboard
    (hidf_video_classifier.py:2330-2804): gap evolution, curve shape,
    confidence bars, score bars, data efficiency, feature quality, slope
    consistency, diagnostic text, generalization-ratio trajectory,
    instantaneous learning rates, indicator bars, recommendations, loss
    curvature, val-follows-train scatter, complexity factors, and the final
    assessment."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tr = np.asarray([h[train_key] for h in history if train_key in h],
                    np.float64)
    va = np.asarray([h[val_key] for h in history if val_key in h],
                    np.float64)
    n = min(len(tr), len(va))
    tr, va = tr[:n], va[:n]
    xs = np.arange(n)
    mtype = metrics.get("learning_type", "?")
    lscore = metrics.get("learning_score", 0.0)

    fig = plt.figure(figsize=(22, 18))
    gs = fig.add_gridspec(4, 4, hspace=0.45, wspace=0.3)
    fig.suptitle(f"Learning vs Memorization Analysis — {mtype} "
                 f"(Score: {lscore:.1f}/10)", fontsize=16)

    def _text_panel(ax, title, lines):
        ax.axis("off")
        ax.text(0.03, 0.95, "\n".join(lines), transform=ax.transAxes,
                fontsize=9, va="top", family="monospace")
        ax.set_title(title)

    # 1 generalization gap evolution
    ax = fig.add_subplot(gs[0, 0])
    if n:
        ax.plot(xs, va - tr, color="#d43", lw=1.8)
        ax.axhline(0.2, ls="--", color="gray", lw=1)
    ax.set_title("Generalization Gap Evolution")
    ax.set_xlabel("epoch")

    # 2 learning curve shape
    ax = fig.add_subplot(gs[0, 1])
    ax.plot(xs, tr, label="train", lw=1.6)
    ax.plot(xs, va, label="val", lw=1.6)
    ax.legend(fontsize=8)
    ax.set_title("Learning Curve Shape")

    # 3 confidence comparison
    ax = fig.add_subplot(gs[0, 2])
    if "train_confidence" in metrics:
        bars = ax.bar(["train", "val"],
                      [metrics["train_confidence"],
                       metrics["val_confidence"]],
                      color=["#47a", "#e84"])
        for b in bars:
            ax.text(b.get_x() + b.get_width() / 2, b.get_height() + 0.01,
                    f"{b.get_height():.3f}", ha="center", fontsize=8)
        if metrics.get("overconfidence_ratio", 1) > 1.5:
            ax.text(0.5, 0.85, "OVERCONFIDENT", transform=ax.transAxes,
                    ha="center", color="red", fontsize=11)
    ax.set_title("Prediction Confidence Comparison")

    # 4 learning vs memorization scores
    ax = fig.add_subplot(gs[0, 3])
    ax.bar(["learning", "memorization"],
           [metrics.get("learning_score", 0),
            metrics.get("memorization_score", 0)],
           color=["#2a7", "#d43"])
    ax.set_ylim(0, 10)
    ax.set_title("Learning vs Memorization Scores")

    # 5 data efficiency
    ax = fig.add_subplot(gs[1, 0])
    curve = metrics.get("data_efficiency_curve")
    if curve:
        ax.plot(np.arange(len(curve)), curve, "o-", lw=1.6)
        ax.set_ylabel("val AUC")
        ax.set_xlabel("train-fraction index")
    _q = metrics.get("quick_learner")
    ax.text(0.05, 0.08, f"quick_learner: {_q}", transform=ax.transAxes,
            fontsize=9,
            bbox=dict(boxstyle="round", fc="#eef", alpha=0.8))
    ax.set_title("Data Efficiency Analysis")

    # 6 feature learning quality
    ax = fig.add_subplot(gs[1, 1])
    keys = ("activation_diversity", "activation_sparsity",
            "feature_learning_score")
    if any(k in metrics for k in keys):
        vals = [metrics.get(k, 0.0) for k in keys]
        ax.bar(["diversity", "sparsity", "score"], vals,
               color=["#47a", "#aaa", "#2a7"])
    ax.set_title("Feature Learning Quality")

    # 7 learning consistency
    ax = fig.add_subplot(gs[1, 2])
    sk = ("early_train_slope", "late_train_slope",
          "early_val_slope", "late_val_slope")
    if all(k in metrics for k in sk):
        ax.bar(["tr early", "tr late", "va early", "va late"],
               [metrics[k] for k in sk], color="#47a")
        ok = metrics.get("val_follows_train", False)
        ax.text(0.5, 0.85, "CONSISTENT" if ok else "INCONSISTENT",
                transform=ax.transAxes, ha="center",
                color="green" if ok else "red", fontsize=11)
    ax.set_title("Learning Consistency "
                 f"(Ratio: {metrics.get('learning_consistency', 0):.2f})")

    # 8 diagnostic summary
    _text_panel(fig.add_subplot(gs[1, 3]), "Diagnostic Summary", [
        f"type           : {mtype} ({metrics.get('confidence', '?')})",
        f"gen gap        : {metrics.get('generalization_gap', 0):+.4f}",
        f"gen ratio      : {metrics.get('generalization_ratio', 0):.3f}",
        f"overconfidence : {metrics.get('overconfidence_ratio', 0):.3f}",
        f"feature score  : {metrics.get('feature_learning_score', 0):.4f}",
        f"val follows tr : {metrics.get('val_follows_train', '?')}",
    ])

    # 9 generalization ratio trajectory
    ax = fig.add_subplot(gs[2, 0])
    if n:
        ax.plot(xs, va / np.maximum(tr, 1e-8), lw=1.6, color="#84c")
        ax.axhline(1.0, ls="--", color="gray", lw=1)
    ax.set_title("Generalization Ratio Trajectory")

    # 10 instantaneous learning rates
    ax = fig.add_subplot(gs[2, 1])
    if n >= 2:
        ax.plot(xs[1:], np.diff(tr), label="d train", lw=1.4)
        ax.plot(xs[1:], np.diff(va), label="d val", lw=1.4)
        ax.axhline(0, color="gray", lw=0.8)
        ax.legend(fontsize=8)
    ax.set_title("Instantaneous Learning Rates")

    # 11 individual memorization indicators
    ax = fig.add_subplot(gs[2, 2])
    ind = {
        "gap>0.2": metrics.get("generalization_gap", 0) > 0.2,
        "slow learner": not metrics.get("quick_learner", True),
        "weak features": metrics.get("feature_learning_score", 1) < 0.1,
        "overconfident": metrics.get("overconfidence_ratio", 1) > 1.5,
        "val diverges": not metrics.get("val_follows_train", True),
    }
    ax.barh(list(ind), [1 if v else 0 for v in ind.values()],
            color=["#d43" if v else "#2a7" for v in ind.values()])
    ax.set_xlim(0, 1.2)
    ax.set_xticks([])
    ax.set_title("Individual Memorization Indicators")

    # 12 recommendations
    recs = []
    if ind["gap>0.2"]:
        recs += ["- increase regularization / augmentation",
                 "- reduce epochs or add early stopping"]
    if ind["overconfident"]:
        recs += ["- calibrate probabilities (temperature)",
                 "- add label smoothing / mixup"]
    if ind["weak features"]:
        recs += ["- unfreeze more backbone layers",
                 "- increase head capacity"]
    if not recs:
        recs = ["- model is learning generalizable features",
                "- safe to train longer or scale data"]
    _text_panel(fig.add_subplot(gs[2, 3]), "Recommendations", recs)

    # 13 loss landscape curvature (2nd difference)
    ax = fig.add_subplot(gs[3, 0])
    if n >= 3:
        ax.plot(xs[2:], np.diff(tr, 2), lw=1.4, label="train")
        ax.plot(xs[2:], np.diff(va, 2), lw=1.4, label="val")
        ax.axhline(0, color="gray", lw=0.8)
        ax.legend(fontsize=8)
    ax.set_title("Loss Landscape Curvature")

    # 14 val following train scatter
    ax = fig.add_subplot(gs[3, 1])
    if n >= 2:
        ax.scatter(tr, va, s=14, c=xs, cmap="viridis")
        r = metrics.get("train_val_correlation",
                        float(np.corrcoef(tr, va)[0, 1]))
        lab = ("STRONG" if r > 0.8 else
               "MODERATE" if r > 0.5 else "POOR")
        ax.text(0.05, 0.92, f"{lab} FOLLOWING", transform=ax.transAxes,
                fontsize=10,
                color={"STRONG": "green", "MODERATE": "orange",
                       "POOR": "red"}[lab])
        ax.set_title(f"Val Following Train (r={r:.3f})")
        ax.set_xlabel("train loss")
        ax.set_ylabel("val loss")
    else:
        ax.set_title("Val Following Train")

    # 15 model complexity factors
    ax = fig.add_subplot(gs[3, 2])
    if n_params:
        names = list(n_params)
        ax.bar(names, [n_params[k] for k in names], color="#47a")
        ax.set_yscale("log")
        ax.tick_params(axis="x", labelsize=8)
    ax.set_title("Model Complexity Factors")

    # 16 final assessment
    _text_panel(fig.add_subplot(gs[3, 3]), "Final Assessment", [
        f"VERDICT: {mtype}",
        f"confidence    : {metrics.get('confidence', '?')}",
        f"learning score: {lscore:.1f}/10",
        "",
        "score factors:",
        *(f"  [{'x' if v else ' '}] {k}" for k, v in ind.items()),
    ])

    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


# ------------------------------------------------------------------ plots

def plot_training_curves(history, save_dir, name="training_curves.png"):
    """Loss/metric curves (siglip2siddataset.py:396-480 analogue)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(save_dir, exist_ok=True)
    keys = sorted({k for h in history for k in h
                   if isinstance(h.get(k), (int, float))
                   and k not in ("epoch",)})
    loss_keys = [k for k in keys if "loss" in k]
    met_keys = [k for k in keys if "loss" not in k and "time" not in k]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    xs = np.arange(len(history))
    for k in loss_keys:
        ys = [h.get(k, np.nan) for h in history]
        axes[0].plot(xs, ys, label=k)
    axes[0].set_title("losses")
    axes[0].legend(fontsize=7)
    for k in met_keys:
        ys = [h.get(k, np.nan) for h in history]
        axes[1].plot(xs, ys, label=k)
    axes[1].set_title("metrics")
    axes[1].legend(fontsize=7)
    path = os.path.join(save_dir, name)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_confusion_matrix(cm, class_names, save_dir, name="confusion.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(save_dir, exist_ok=True)
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(cm, cmap="Blues")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    fontsize=9)
    ax.set_xticks(range(len(class_names)), class_names, fontsize=8)
    ax.set_yticks(range(len(class_names)), class_names, fontsize=8)
    ax.set_xlabel("pred")
    ax.set_ylabel("true")
    path = os.path.join(save_dir, name)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
