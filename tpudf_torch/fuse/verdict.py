"""v2 verdict engine: SYNTHETIC / EDITED / LIKELY_REAL / UNCERTAIN.

A copy of tpudf/fuse/verdict.py (host numpy), kept here so that this
package imports nothing of `tpudf`.

Pure re-implementation of the reference verdict path
(appv3.py:4345-4530): certainty-aware bands, the benign-JPEG penalty that
softens posteriors under heavy recompression, and the synthetic-vs-edited
evidence split.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Verdict:
    label: str
    band: str
    risk_level: str
    prob_fake: float
    certainty: float
    reason: str


def _c01(x, default=0.0):
    if x is None:
        return float(default)
    try:
        x = float(x)
    except Exception:
        return float(default)
    if not np.isfinite(x):
        return float(default)
    return float(np.clip(x, 0.0, 1.0))


def choose_band(prob_fake, certainty):
    """(band, risk) from probability x certainty (appv3.py:4379-4401)."""
    p, c = _c01(prob_fake), _c01(certainty)
    if p <= 0.20 and c >= 0.65:
        return "GREEN", "LEAN_REAL"
    if 0.20 < p < 0.50 and c >= 0.65:
        return "YELLOW", "LEAN_REAL"
    if 0.50 <= p < 0.75 and c >= 0.70:
        return "ORANGE", "NEUTRAL"
    if p >= 0.75 and c >= 0.75:
        return "RED", "LEAN_FAKE"
    if p <= 0.35:
        return "YELLOW", "LEAN_REAL"
    if p <= 0.60:
        return "YELLOW", "NEUTRAL"
    return "ORANGE", "NEUTRAL"


def apply_benign_jpeg_penalty(metrics, prob_fake, certainty):
    """Heavy recompression lowers confidence and shrinks the posterior
    toward 0.5 (appv3.py:4404-4424)."""
    jpeg = _c01(metrics.get("jpeg"))
    jpeg_q = _c01(metrics.get("jpeg_q_mismatch_score"))
    sat = _c01(metrics.get("saturation_peak_score"))
    benign = _c01(0.45 * jpeg + 0.35 * jpeg_q + 0.20 * sat)
    if benign < 0.80:
        return prob_fake, certainty, ""
    new_c = _c01(certainty * (1.0 - 0.35 * benign))
    shrink = 0.20 * benign
    new_p = _c01(prob_fake * (1.0 - shrink) + 0.5 * shrink)
    return new_p, new_c, f"benign_jpeg_penalty={benign:.3f}"


def decide_verdict(result: dict) -> Verdict:
    """result: the per-image signal dict (serve/report.py). Mirrors
    appv3.py:4427-4530."""
    p = result.get("bayesian_fusion_posterior")
    if p is None:
        p = result.get("final_prob", 0.5)
    p = _c01(p, 0.5)

    c = result.get("bayesian_fusion_certainty")
    if c is None:
        c = result.get("certainty", 0.5)
    c = _c01(c, 0.5)

    du = _c01(result.get("dirichlet_uncertainty"))
    dc = _c01(result.get("dirichlet_conflict"))
    c = _c01(c * (1.0 - 0.35 * du) * (1.0 - 0.50 * dc))

    p2, c2, jpeg_note = apply_benign_jpeg_penalty(result, p, c)

    cal = result.get("bayesian_fusion_calibrated") or {}
    if not isinstance(cal, dict):
        cal = {}
    visual = _c01(cal.get("visual", result.get("visual_head")))
    freq = _c01(cal.get("freq", result.get("freq_head")))
    forensic = _c01(cal.get("forensic", result.get("forensic_score")))
    cfa = _c01(cal.get("cfa", result.get("cfa_fake_score")))
    patch = _c01(cal.get("patch", result.get("patch_mean")))
    jpeg = _c01(cal.get("jpeg", result.get("jpeg_q_mismatch_score")))

    benign_jpeg = _c01(0.45 * jpeg
                       + 0.25 * _c01(result.get("jpeg_q_mismatch_score"))
                       + 0.30 * _c01(result.get("saturation_peak_score")))
    synth = _c01(0.35 * visual + 0.25 * freq + 0.20 * cfa + 0.20 * patch)
    edit = _c01(0.55 * forensic + 0.25 * patch + 0.20 * benign_jpeg)

    band, risk = choose_band(p2, c2)

    if c2 < 0.55 and 0.35 < p2 < 0.65:
        return Verdict("UNCERTAIN", band, risk, p2, c2,
                       f"low_confidence p={p2:.3f} c={c2:.3f} {jpeg_note}".strip())

    if p2 >= 0.75 and c2 >= 0.75:
        if synth > edit and benign_jpeg < 0.85:
            why = f"high_p_high_c synth={synth:.3f} edit={edit:.3f}"
            lab = "SYNTHETIC"
        else:
            why = f"high_p_high_c edit={edit:.3f} jpeg={benign_jpeg:.3f}"
            lab = "EDITED"
        return Verdict(lab, band, risk, p2, c2,
                       (why + (" " + jpeg_note if jpeg_note else "")).strip())

    if p2 >= 0.50:
        if synth >= 0.70 and synth > edit + 0.10 and benign_jpeg < 0.85:
            return Verdict("SYNTHETIC", band, risk, p2, c2,
                           f"moderate_p synth={synth:.3f} edit={edit:.3f}")
        return Verdict("EDITED", band, risk, p2, c2,
                       f"moderate_p edit={edit:.3f} jpeg={benign_jpeg:.3f}")

    return Verdict("LIKELY_REAL", band, risk, p2, c2,
                   f"low_p p={p2:.3f} c={c2:.3f} {jpeg_note}".strip())
