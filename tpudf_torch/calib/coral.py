"""CORAL ordinal risk calibration (tpudf/calib/coral.py): four logit
cutpoints give a 5-band distribution over [REAL, LEAN_REAL, BORDERLINE,
LEAN_FAKE, FAKE], a smoothed "gaussian" fake probability, and the 0.70/0.30
blend with the raw sigmoid."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    def default(cls):
        return cls.from_prob_cuts(0.32, 0.47, 0.61, 0.75)


def coral_probs(z_scaled, cuts: CoralCutpoints):
    """(…,) scaled fused logits → (…, 5) ordinal distribution."""
    c = torch.tensor(np.asarray(cuts.cuts, np.float32), device=z_scaled.device)
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
