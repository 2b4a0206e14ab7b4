"""Bayesian evidence fusion over the multi-cue expert signals
(tpudf/fuse/bayesian.py), on tensors.

Batched re-implementations of the reference fusers (appv3.py:932-1094):
  * bayesian_fuse_v2 — reliability-weighted clipped log-odds sum over the 7
    cue probabilities (visual/freq/forensic/cfa/jpeg/prnu/patch) + prior,
    with the PRNU<0.4 real-tilt and agreement-based certainty
  * dirichlet_fuse — per-cue Dirichlet pseudo-counts → posterior + epistemic/
    aleatoric uncertainty + conflict

Missing-cue semantics are the JAX module's: bayesian_fuse_v2 fills
missing / non-finite cues with 0.5, dirichlet_fuse skips absent cues.

Calibration (appv3.py:948-975): `fit_bayes_calibration` fits per-feature
isotonic maps (applied inside bayesian_fuse_v2 by `interp`, jnp.interp's
arithmetic) or a logistic model over the 7-feature vector. A calibration
used on the card is first moved there once (`BayesCalibration.to`), so a
fusion call copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FEATURES = ("visual", "freq", "forensic", "cfa", "jpeg", "prnu", "patch")

RELIABILITY = {
    "visual": 0.6, "freq": 0.6, "forensic": 1.0, "cfa": 0.9,
    "jpeg": 0.7, "prnu": 0.7, "patch": 0.8,
}

DIRICHLET_WEIGHTS = {
    "visual": 1.0, "freq": 1.0, "forensic": 1.2, "cfa": 0.9,
    "jpeg": 0.8, "prnu": 0.7, "patch": 0.9,
}

_EPS = 1e-6


def _first(features):
    """The first present cue (a leading None is a valid missing cue); a
    0-d tensor when none is present (JAX's batch shape ())."""
    for v in features.values():
        if v is not None:
            return v
    return torch.zeros(())


def _gather(features, like):
    """dict → (B, 7) with 0.5 fill for missing/non-finite cues."""
    cols = []
    for name in FEATURES:
        v = features.get(name)
        v = (torch.full_like(like, 0.5, dtype=torch.float32) if v is None
             else v.float())
        cols.append(torch.where(torch.isfinite(v), v, 0.5))
    return torch.stack(cols, dim=-1)


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for sorted 1-D xp (constant ends, the left of
    two equal xp kept), in f32 on x's device."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass
class BayesCalibration:
    """Fitted recalibration for bayesian_fuse_v2 (appv3.py:948-975).

    iso:      {feature: (x_fit, y_fit)} isotonic maps, applied per feature
              before the log-odds sum
    logistic: (w (7,), b) over the 7-feature vector; optional extra output
    """
    iso: dict | None = None
    logistic: tuple | None = None

    def to(self, device):
        """The same maps as f32 tensors on `device` (one copy each)."""
        iso = None if not self.iso else {
            k: tuple(torch.as_tensor(np.asarray(a, np.float32)).to(device)
                     for a in xy) for k, xy in self.iso.items()}
        logistic = None
        if self.logistic is not None:
            w, b = self.logistic
            logistic = (torch.as_tensor(np.asarray(w, np.float32)).to(device),
                        float(b))
        return BayesCalibration(iso=iso, logistic=logistic)

    def to_json(self):
        out = {}
        if self.iso:
            out["iso"] = {k: [_np(x).tolist(), _np(y).tolist()]
                          for k, (x, y) in self.iso.items()}
        if self.logistic:
            w, b = self.logistic
            out["logistic"] = {"w": _np(w).tolist(), "b": float(b)}
        return out

    @classmethod
    def from_json(cls, d):
        iso = {k: (np.asarray(x), np.asarray(y))
               for k, (x, y) in d.get("iso", {}).items()} or None
        lg = d.get("logistic")
        logistic = (np.asarray(lg["w"]), float(lg["b"])) if lg else None
        return cls(iso=iso, logistic=logistic)


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def fit_bayes_calibration(features: dict, labels, mode="isotonic",
                          iters=1500, lr=2.0) -> BayesCalibration:
    """Fit the optional recalibration from held-out cue probabilities
    (host numpy, as the JAX module).

    features: dict of (N,) arrays (any subset of FEATURES), labels: (N,)
    0=real / 1=fake. mode: "isotonic" (per-feature, the reference's
    calibrate=True) or "logistic" (joint 7-feature model)."""
    from tpudf_torch.eval.stats import isotonic_fit
    y = np.asarray(labels, np.float64)
    if mode == "isotonic":
        iso = {}
        for name in FEATURES:
            if name in features and features[name] is not None:
                iso[name] = isotonic_fit(
                    np.asarray(features[name], np.float64), y)
        return BayesCalibration(iso=iso)
    if mode == "logistic":
        # None-valued cues count as missing (= 0.5), matching _gather and
        # the isotonic branch's feature-dict contract
        x = np.column_stack([
            np.asarray(features[name], np.float64)
            if features.get(name) is not None else np.full_like(y, 0.5)
            for name in FEATURES])
        w = np.zeros(len(FEATURES))
        b = 0.0
        for _ in range(iters):
            p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
            g = p - y
            w -= lr * (x.T @ g) / len(y)
            b -= lr * float(np.mean(g))
        return BayesCalibration(logistic=(w, b))
    raise ValueError(f"unknown calibration mode {mode!r}")


def _on(a, like):
    """An f32 tensor on like's device (a no-op for one already there)."""
    if torch.is_tensor(a) and a.device == like.device:
        return a.float()
    return torch.as_tensor(np.asarray(a, np.float32)).to(like.device)


def bayesian_fuse_v2(features: dict, prior_fake=0.5,
                     calibration: BayesCalibration | None = None):
    """features: dict of (B,) probability tensors → dict of (B,) outputs."""
    like = _first(features)
    p = torch.clamp(_gather(features, like), _EPS, 1 - _EPS)
    if calibration is not None and calibration.iso:
        cols = []
        for i, name in enumerate(FEATURES):
            col = p[..., i]
            if name in calibration.iso:
                xf, yf = calibration.iso[name]
                col = interp(col, _on(xf, like), _on(yf, like))
            cols.append(col)
        p = torch.clamp(torch.stack(cols, dim=-1), _EPS, 1 - _EPS)
    # each cue's weight as an f32 scalar (no weight tensor to copy)
    w = torch.stack([torch.full_like(like, RELIABILITY[k],
                                     dtype=torch.float32) for k in FEATURES],
                    dim=-1)
    log_terms = torch.clamp(w * torch.log(p / (1 - p)), -2.0, 2.0)
    log_odds = torch.sum(log_terms, dim=-1)

    prnu = p[..., FEATURES.index("prnu")]
    log_odds = log_odds + torch.where(prnu < 0.4, math.log(0.5), 0.0)

    prior = np.clip(np.float32(prior_fake), np.float32(_EPS),
                    np.float32(1 - _EPS))
    log_post = log_odds + float(np.log(prior / (np.float32(1) - prior)))
    posterior = torch.sigmoid(log_post)

    mean_p = torch.mean(p, dim=-1)
    std_p = torch.std(p, dim=-1, correction=0)
    agreement = 1.0 - torch.tanh(std_p * 2.0)
    certainty = torch.clamp(
        agreement * (0.5 + torch.abs(0.5 - posterior) * 2.0), 0.0, 1.0)

    out = {
        "posterior_fake": posterior,
        "posterior_real": 1.0 - posterior,
        "certainty": certainty,
        "log_odds": log_post,
        "mean_prob": mean_p,
        "std_prob": std_p,
        # per-cue (clipped, possibly isotonic-recalibrated) probabilities;
        # the verdict's benign-JPEG penalty reads the jpeg entry
        "calibrated": {name: p[..., i] for i, name in enumerate(FEATURES)},
    }
    if calibration is not None and calibration.logistic is not None:
        lw, lb = calibration.logistic
        out["logistic_posterior"] = torch.sigmoid(p @ _on(lw, like)
                                                  + float(lb))
    return out


def dirichlet_fuse(features: dict, base_strength=3.0):
    """Absent/None cues are SKIPPED (no pseudo-counts); an all-missing dict
    returns the neutral Dirichlet(1,1) posterior."""
    like = _first(features)
    alpha_real = torch.zeros_like(like, dtype=torch.float32)
    alpha_fake = torch.zeros_like(like, dtype=torch.float32)
    present = 0
    for k, w in DIRICHLET_WEIGHTS.items():
        if k not in features or features[k] is None:
            continue
        present += 1
        p = torch.clamp(features[k].float(), _EPS, 1 - _EPS)
        p = torch.where(torch.isfinite(p), p, 0.5)
        alpha_fake = alpha_fake + w * p * base_strength + 1.0
        alpha_real = alpha_real + w * (1 - p) * base_strength + 1.0
    if present == 0:
        alpha_real = alpha_fake = torch.ones_like(alpha_real)

    s = alpha_real + alpha_fake
    mean_fake = alpha_fake / s
    epistemic = 2.0 / s
    aleatoric = mean_fake * (1 - mean_fake)
    return {
        "posterior_fake": mean_fake,
        "posterior_real": alpha_real / s,
        "alpha_real": alpha_real,
        "alpha_fake": alpha_fake,
        "total_strength": s,
        "uncertainty": torch.clamp(epistemic + aleatoric, 0.0, 1.0),
        "conflict": torch.abs(alpha_real - alpha_fake) / s,
    }
