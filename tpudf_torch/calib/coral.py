"""CORAL ordinal risk calibration (tpudf/calib/coral.py): four logit
cutpoints give a 5-band distribution over [REAL, LEAN_REAL, BORDERLINE,
LEAN_FAKE, FAKE], a smoothed "gaussian" fake probability, and the 0.70/0.30
blend with the raw sigmoid; plus the head-less MoE fallback blend, the
artifacts' loader (`CoralCutpoints.from_json`), and the fits that make
them: the quantile cutpoints and the temperature (host numpy)."""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import torch

RISK_NAMES = ["REAL", "LEAN_REAL", "BORDERLINE", "LEAN_FAKE", "FAKE"]


def _logit(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


@dataclasses.dataclass(frozen=True)
class CoralCutpoints:
    """Cutpoints in logit space + fused-logit temperature."""
    cuts: tuple  # 4 floats, ascending
    temperature: float = 1.0

    @classmethod
    def from_prob_cuts(cls, q25, q50, q75, qmax, temperature=1.0):
        return cls(tuple(_logit(np.array([q25, q50, q75, qmax]))), temperature)

    @classmethod
    def from_json(cls, cut_path, temp_path=None):
        """The shipped artifacts: coral_cutpoints.json ({"q25", "q50",
        "q75", "max"} or a list of four probabilities) and, optionally,
        coral_temp.json ({"temperature": t})."""
        with open(cut_path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            cuts = [raw["q25"], raw["q50"], raw["q75"], raw["max"]]
        else:
            cuts = list(raw)
        t = 1.0
        if temp_path is not None:
            with open(temp_path) as f:
                t = float(json.load(f).get("temperature", 1.0))
        return cls.from_prob_cuts(*cuts, temperature=t)

    @classmethod
    def default(cls):
        return cls.from_prob_cuts(0.32, 0.47, 0.61, 0.75)


@functools.lru_cache(maxsize=16)
def _cuts_on(cuts: tuple, device):
    """The cutpoints on `device`, copied there once (a copy from the host
    per call would wait for the card's queue)."""
    return torch.tensor(np.asarray(cuts, np.float32), device=device)


def coral_probs(z_scaled, cuts: CoralCutpoints):
    """(…,) scaled fused logits → (…, 5) ordinal distribution."""
    c = _cuts_on(tuple(float(v) for v in cuts.cuts), z_scaled.device)
    g = torch.sigmoid(z_scaled[..., None] - c)                 # (…, 4)
    p = torch.cat([1.0 - g[..., :1], g[..., :-1] - g[..., 1:], g[..., -1:]],
                  dim=-1)
    return p / (torch.sum(p, dim=-1, keepdim=True) + 1e-8)


def coral_gauss_prob(risk_probs):
    """clip(mu/4 + 0.5·var) of the ordinal distribution, and its entropy."""
    k = torch.arange(5, dtype=torch.float32, device=risk_probs.device)
    mu = torch.sum(k * risk_probs, dim=-1)
    var = torch.sum(risk_probs * (k - mu[..., None]) ** 2, dim=-1)
    p = torch.clamp(mu / 4.0 + 0.5 * var, 0.0, 1.0)
    ent = -torch.sum(risk_probs * torch.log(risk_probs + 1e-8), dim=-1)
    return p, ent


def coral_blend(z_fused, cuts: CoralCutpoints):
    """Temperature-scale the fused logit, ordinal probs, gaussian smoothing,
    0.70/0.30 blend. Returns a dict of (…,)-shaped signals."""
    z_scaled = z_fused / max(cuts.temperature, 1e-3)
    p_raw = torch.sigmoid(z_scaled)
    rp = coral_probs(z_scaled, cuts)
    p_gauss, ent = coral_gauss_prob(rp)
    p_blend = torch.clamp(0.70 * p_raw + 0.30 * p_gauss, 0.0, 1.0)
    return {
        "z_scaled": z_scaled,
        "p_fake_raw": p_raw,
        "risk_probs": rp,
        "risk_idx": torch.argmax(rp, dim=-1),
        "p_fake_coral": p_gauss,
        "entropy": ent,
        "p_blend": p_blend,
    }


def moe_fallback_blend(p_sig, p_freq, p_gauss):
    """Head-less "MoE" probability-space fusion, used when no 2→1 fusion
    head is given: noisy-OR of the two experts + confidence-weighted expert
    mixture, with the CORAL gaussian prob capped at a 25 % share."""
    p_or = 1.0 - (1.0 - p_sig) * (1.0 - p_freq)
    alpha = torch.clamp(p_sig * (1.0 - p_freq), 0.05, 0.95)
    beta = torch.clamp(p_freq * (1.0 - p_sig), 0.05, 0.95)
    p_moe = (alpha * p_sig + beta * p_freq) / (alpha + beta + 1e-6)
    return torch.clamp(0.4 * p_or + 0.35 * p_moe + 0.25 * p_gauss, 0.0, 1.0)


def fit_coral_cutpoints(fused_logits, quantiles=(0.15, 0.35, 0.55, 0.75)):
    """Quantile scan over calibration-set fused logits (coral.py:300-322):
    the sorted logit at int(q · n) for each q, in the logits' own space."""
    z = np.sort(np.asarray(fused_logits))
    return [float(z[int(q * len(z))]) for q in quantiles]


def fit_temperature(logits, labels, grid=None):
    """1-D temperature search minimizing NLL over a grid (numpy; the
    reference's temperature scaling, inference_deepfakeface_complete.py
    :450-478)."""
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels, np.float64)
    if grid is None:
        grid = np.linspace(0.25, 5.0, 96)
    best_t, best_nll = 1.0, np.inf
    for t in grid:
        p = 1.0 / (1.0 + np.exp(-logits / t))
        p = np.clip(p, 1e-7, 1 - 1e-7)
        nll = -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))
        if nll < best_nll:
            best_t, best_nll = float(t), float(nll)
    return best_t
