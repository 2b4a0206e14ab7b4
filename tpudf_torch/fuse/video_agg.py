"""Per-frame → per-video aggregation and label voting
(tpudf/fuse/video_agg.py, a copy: the module is numpy only).

Host-side decision logic (numpy; ≤ dozens of frames per clip) mirroring
appv3.py:789-926: strictness-dependent thresholds, top-k-mean /
weighted-median / max aggregation, min-agree label votes, the >0.75
max-frame escalation, and display-frame choice.
"""

from __future__ import annotations

import numpy as np

STRICTNESS_THRESH = {
    "conservative": (0.65, 0.35),
    "balanced": (0.60, 0.40),
    "aggressive": (0.55, 0.45),
}


def temporal_frame_weights(frame_diffs):
    """Motion-aware frame weights: 0.6 + 1.0 * normalized motion score
    (appv3.py:4181-4189). frame_diffs: per-frame mean abs difference to the
    previous frame (first frame gets the mean)."""
    d = np.asarray(frame_diffs, np.float32)
    if d.size == 0:
        return d
    dmax = float(d.max())
    norm = d / dmax if dmax > 0 else np.zeros_like(d)
    return 0.6 + 1.0 * norm


def aggregate_video_probs(probs, frame_preds=None, agg_mode="topk_mean",
                          topk_frac=0.30, strictness="balanced", min_agree=2,
                          weights=None, disable_tampered=False,
                          disable_inconclusive=False):
    """Returns (video_prob, video_label, chosen_frame_index, metrics)."""
    probs = np.asarray(probs, np.float32)
    n = int(probs.size)
    if n == 0:
        return 0.5, "INCONCLUSIVE", 0, {"n": 0}
    frame_preds = list(frame_preds) if frame_preds is not None else [""] * n

    w = None
    if weights is not None:
        w = np.asarray(weights, np.float32)
        w = np.clip(w, 0.05, None) if w.size == n else None

    th_fake, th_real = STRICTNESS_THRESH.get(strictness,
                                             STRICTNESS_THRESH["balanced"])
    topk_frac = float(np.clip(topk_frac, 0.05, 1.0))
    k = max(1, int(np.ceil(topk_frac * n)))
    srt = np.sort(probs)
    weighted_median_idx = None

    if w is None:
        if agg_mode == "max":
            video_prob = float(srt[-1])
        elif agg_mode == "median":
            video_prob = float(np.median(probs))
        else:
            video_prob = float(np.mean(srt[-k:]))
    else:
        scores = probs * w
        if agg_mode == "max":
            video_prob = float(probs[int(np.argmax(scores))])
        elif agg_mode == "median":
            order = np.argsort(probs)
            cumw = np.cumsum(w[order])
            pos = int(np.searchsorted(cumw, 0.5 * float(cumw[-1])))
            weighted_median_idx = int(order[min(pos, n - 1)])
            video_prob = float(probs[weighted_median_idx])
        else:
            top = np.argsort(scores)[-k:]
            video_prob = float(np.average(probs[top], weights=w[top]))

    n_fake = int(np.sum(probs >= th_fake))
    n_real = int(np.sum(probs <= th_real))
    counts = {"REAL": 0, "TAMPERED": 0, "FAKE": 0, "INCONCLUSIVE": 0,
              "UNCERTAIN": 0}
    for p in frame_preds:
        counts[p if p in counts else "INCONCLUSIVE"] += 1

    if (video_prob >= th_fake and n_fake >= min_agree) \
            or counts["FAKE"] >= min_agree:
        label = "FAKE"
    elif counts["TAMPERED"] >= min_agree and counts["FAKE"] == 0:
        label = "TAMPERED"
    elif video_prob <= th_real and n_real >= min_agree \
            and counts["FAKE"] == 0:
        label = "REAL"
    else:
        label = "INCONCLUSIVE"

    if disable_tampered and label == "TAMPERED":
        label = "FAKE" if video_prob >= th_fake else "REAL"
    if disable_inconclusive and label in ("INCONCLUSIVE", "UNCERTAIN"):
        label = "FAKE" if video_prob >= th_fake else "REAL"

    # max-frame escalation (appv3.py:881-884)
    p_max = float(np.max(probs))
    if p_max > 0.75:
        label = "FAKE"
        video_prob = max(video_prob, p_max * 0.9)

    pick_score = probs if w is None else probs * w
    if label == "FAKE":
        chosen = int(np.argmax(pick_score))
    elif label == "REAL":
        chosen = (weighted_median_idx if weighted_median_idx is not None
                  else int(np.argmin(np.abs(probs - np.median(probs)))))
    elif label == "TAMPERED":
        idxs = [i for i, lab in enumerate(frame_preds) if lab == "TAMPERED"]
        chosen = (int(idxs[int(np.argmax(pick_score[idxs]))]) if idxs
                  else int(np.argmin(np.abs(probs - video_prob))))
    else:
        chosen = int(np.argmin(np.abs(probs - video_prob)))

    metrics = {"n": n, "k": k, "agg_mode": agg_mode,
               "video_prob": float(video_prob),
               "video_std": float(np.std(probs)),
               "th_fake": th_fake, "th_real": th_real,
               "n_fake_frames": n_fake, "n_real_frames": n_real,
               "label_counts": counts}
    return float(video_prob), label, chosen, metrics
