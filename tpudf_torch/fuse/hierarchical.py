"""Hierarchical Bayesian final decision (likelihood-ratio mixture)
(tpudf/fuse/hierarchical.py), on tensors.

Re-implements the v2 app's clean decision engine (appv3.py:4932-5103):
  L1: core fake posterior from (visual, freq, coral) likelihood ratios
  L2: generator-type posterior P(diffusion | evidence)
  L3: mode-specific fake posteriors (camera / diffusion pipelines)
  L4: mixture P(fake) = P(diff)·P(fake|diff) + (1−P(diff))·P(fake|cam),
      then CFA real-tilt, face odds bump, head-disagreement damping.

Vectorized over (B,) signal tensors; `final_probability` runs on the
signals' device (the report's fusion tail calls it on the card).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-6


def _t(x, like=None):
    """x as an f32 tensor; a Python scalar filled into `like`'s shape on
    its device (a fill, not a copy from the host)."""
    if torch.is_tensor(x):
        return x.float()
    if like is None:
        return torch.tensor(float(x), dtype=torch.float32)
    return torch.full_like(like, float(x), dtype=torch.float32)


def _c(p, like=None):
    return torch.clamp(_t(p, like), _EPS, 1 - _EPS)


def _odds(p, like=None):
    p = _c(p, like)
    return p / (1 - p)


def _from_odds(o):
    return o / (1 + o)


def bayes_combine(probs, weights, prior=0.5):
    """Weighted product of likelihood ratios (appv3.py:4932-4949).
    probs: list of (B,) tensors or None; missing signals are skipped."""
    like = next((p for p in probs if torch.is_tensor(p)), None)
    odds = _odds(prior, like)
    for p, w in zip(probs, weights):
        if p is None:
            continue
        odds = odds * _odds(p, like) ** float(w)
    return _from_odds(odds)


def final_probability(visual_prob, freq_prob, fusion_prob, coral_prob,
                      forensic_score, diff_score, max_patch, patch_mean,
                      head_delta, spectral_score=0.0, color_score=0.0,
                      face_boost=0.0, cfa_fake_score=None, real_prior=None):
    """The L1-L4 mixture → p_final (B,), on the inputs' device
    (final_decision adds the host-side FAKE/REAL labels)."""
    like = _t(visual_prob)
    p_vis = _c(visual_prob)
    p_freq = _c(freq_prob, like)
    p_coral = _c(coral_prob, like)
    p_forensic = _c(forensic_score, like)
    p_diff_raw = _c(diff_score, like)
    p_spec = _c(spectral_score, like)
    p_color = _c(color_score, like)
    p_pm = _c(patch_mean if patch_mean is not None else 0.5, like)
    p_px = _c(max_patch if max_patch is not None else 0.5, like)
    p_real_prior = (_c(1.0 - _c(real_prior, like))
                    if real_prior is not None else None)

    # L1 core (priors per reference: wild fake rate conservative)
    p_core = bayes_combine([p_vis, p_freq, p_coral], [1.20, 1.00, 0.40],
                           prior=0.30)
    # L2 generator type
    p_gen_diff = bayes_combine([p_diff_raw, p_spec, p_color],
                               [1.30, 0.80, 0.80], prior=0.30)
    p_gen_diff = torch.clamp(0.9 * p_gen_diff + 0.1 * p_pm, 0.0, 1.0)
    # L3 mode-specific
    p_fake_cam = bayes_combine([p_core, p_forensic, p_pm, p_real_prior],
                               [1.00, 0.40, 0.25, 0.60], prior=0.20)
    p_fake_diff = bayes_combine([p_core, p_diff_raw, p_spec, p_color, p_px],
                                [1.00, 0.70, 0.55, 0.55, 0.50], prior=0.60)
    # L4 mixture
    p_final = p_gen_diff * p_fake_diff + (1 - p_gen_diff) * p_fake_cam

    if cfa_fake_score is not None:
        cfa = _t(cfa_fake_score, like)
        p_final = torch.where(cfa < 0.45,
                              _from_odds(_odds(p_final) * 0.65), p_final)
    fb = _t(face_boost, like)
    p_final = torch.where(
        fb > 0, _from_odds(_odds(p_final) * (1.0 + torch.clamp(fb, max=0.10))),
        p_final)
    hd = _t(head_delta, like)
    damp = (hd >= 0.35) & (p_freq < 0.40) & (p_vis >= 0.40)
    p_final = torch.where(damp, _from_odds(_odds(p_final) * 0.80), p_final)

    return torch.clamp(p_final, 0.0, 1.0)


def final_decision(visual_prob, freq_prob, fusion_prob, coral_prob,
                   forensic_score, diff_score, max_patch, patch_mean,
                   head_delta, spectral_score=0.0, color_score=0.0,
                   face_boost=0.0, cfa_fake_score=None, real_prior=None,
                   fake_thresh=0.75):
    """Returns (p_final (B,), label array of 'FAKE'/'REAL')."""
    p_final = final_probability(
        visual_prob, freq_prob, fusion_prob, coral_prob, forensic_score,
        diff_score, max_patch, patch_mean, head_delta, spectral_score,
        color_score, face_boost, cfa_fake_score, real_prior)
    labels = np.where(p_final.cpu().numpy() >= fake_thresh, "FAKE", "REAL")
    return p_final, labels
