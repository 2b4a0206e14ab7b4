"""Label-policy decision engine.

A copy of tpudf/fuse/decision.py (host numpy), kept here so that this
package imports nothing of `tpudf`.

The reference's label policy is a cascade of stateful overrides spread over
appv3.py:4305-5103 and :5654-5964. Per SURVEY.md §7 ("hard parts") it is
re-implemented here as pure, ordered rule functions over a frozen threshold
config — behaviourally equivalent, unit-testable, no global state.

Components (reference anchors):
  * band_and_risk / traffic_light_label       appv3.py:4316-4342
  * real_gate / tamper_votes / real_pass      appv3.py:4578-4620
  * finalize_label_and_risk                   appv3.py:4623-4668
  * is_uncertain / is_inconclusive            appv3.py:4670-4683
  * classify_rbr (retouched-but-real, >=4/8)  appv3.py:4689-4767
  * classify_three_way (REAL/TAMPERED/FAKE)   appv3.py:4770-4846
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    """Env-tunable thresholds (appv3.py:142-230 defaults)."""
    final_fake_thresh: float = 0.75
    final_real_thresh: float = 0.45
    disable_tampered: bool = False
    disable_inconclusive: bool = False
    # false-positive shield (stabilized_fusion, appv3.py:3191-3208): the
    # reference defines it in every app revision but never invokes it; we
    # expose it as an opt-in safer blend on the REAL-looking path.
    use_stabilized_fusion: bool = False


DEFAULT_DECISION = DecisionConfig()

BAND_COLORS = {"GREEN": "#6ef3a5", "YELLOW": "#ffd666",
               "ORANGE": "#f59e0b", "RED": "#ff6b6b"}

LABEL_CODES = {"REAL": 0.0, "TAMPERED": 0.5, "FAKE": 1.0}


def _clamp(x, default=0.5):
    if x is None:
        return float(default)
    try:
        x = float(x)
    except Exception:
        return float(default)
    if not np.isfinite(x):
        return float(default)
    return float(np.clip(x, 0.0, 1.0))


def stabilized_fusion(raw, coral, v, f, max_patch, patch_mean):
    """False-positive shield: safer blend for REAL-looking images
    (appv3.py:3191-3208): attenuate coral/raw when the freq & visual heads
    are quiet and the patch grid is flat; soften isolated patch spikes."""
    raw = float(raw)
    coral = float(coral)
    spread = max_patch - patch_mean
    if f < 0.55 and v < 0.55 and spread < 0.18:
        coral *= 0.40
        raw *= 0.80
    if max_patch > 0.90 and f < 0.55:
        raw *= 0.90
        coral *= 0.60
    final = 0.55 * raw + 0.45 * coral
    if f < 0.45 and v < 0.50:
        final *= 0.65
    return float(np.clip(final, 0.0, 1.0))


def band_and_risk(label, p_final, forensic_score):
    # parity note (appv3.py:4316-4326): the reference has only FAKE vs
    # everything-else branches, so TAMPERED/INCONCLUSIVE labels carry
    # real-side GREEN/YELLOW bands and the ORANGE color is only reachable
    # through the verdict-v2 choose_band path — reproduced as-is
    if label == "FAKE":
        if forensic_score >= 0.75 or p_final >= 0.65:
            return "RED", "HIGH_FAKE"
        return "YELLOW", "LEAN_FAKE"
    if p_final <= 0.35 and forensic_score <= 0.55:
        return "GREEN", "LOW_REAL"
    return "YELLOW", "LEAN_REAL"


def traffic_light_label(label, p_final, forensic_score):
    band, risk = band_and_risk(label, p_final, forensic_score)
    text = {("GREEN", "LOW_REAL"): "GREEN - low real",
            ("YELLOW", "LEAN_REAL"): "YELLOW - lean real",
            ("YELLOW", "LEAN_FAKE"): "YELLOW - lean fake"}.get(
        (band, risk), "RED - high fake")
    return text, BAND_COLORS[band], band, risk


def real_gate(p_final, forensic, jpeg_q, hist, prnu_scaled, patch_spread):
    """Confident-REAL gate: all anomaly channels must be quiet."""
    if p_final > 0.35:
        return False
    if forensic is not None and forensic > 0.65:
        return False
    if jpeg_q is not None and jpeg_q > 0.70:
        return False
    if hist is not None and hist > 0.75:
        return False
    if prnu_scaled is not None and prnu_scaled < 0.30:
        return False
    if patch_spread is not None and patch_spread > 0.15:
        return False
    return True


def tamper_votes(forensic, jpeg_q, hist):
    votes = 0
    votes += bool(forensic is not None and forensic > 0.70)
    votes += bool(jpeg_q is not None and jpeg_q > 0.80)
    votes += bool(hist is not None and hist > 0.85)
    return votes


def real_pass(cfa_fake, prnu_scaled, real_prior_v3):
    if cfa_fake is not None and cfa_fake < 0.25 \
            and prnu_scaled is not None and prnu_scaled > 0.45:
        return True
    return real_prior_v3 is not None and real_prior_v3 > 0.65


def is_uncertain(p, risk, patch_mean, head_delta):
    return (0.45 <= p <= 0.55) and risk <= 2 and patch_mean < 0.6 \
        and head_delta >= 0.25


def is_inconclusive(p, pg, patch_mean, risk, entropy, head_delta):
    return (0.40 <= p <= 0.60 and 0.40 <= pg <= 0.60 and patch_mean < 0.75
            and risk in (1, 2) and entropy > 1.0 and head_delta >= 0.15)


def classify_rbr(fake_score, real_prior, forensic, cfa_fake, perlin, grain,
                 fft_conf, patch_mean, patch_spread):
    """REAL / RBR (retouched-but-real) / FAKE with the 8-condition vote."""
    s = _clamp(fake_score, 0.0)
    r = _clamp(real_prior, 0.0)
    f = _clamp(forensic, 0.0)
    c = _clamp(cfa_fake, 0.0)
    p = _clamp(perlin, 0.0)
    g = _clamp(grain, 0.0)
    fft = _clamp(fft_conf, 0.0)
    m = _clamp(patch_mean, 0.0)
    ps = _clamp(patch_spread, 0.0)

    if r > 0.75 and s < 0.35:
        return "REAL", 0.0
    if s > 0.75 and r < 0.30:
        return "FAKE", 1.0

    votes = sum([
        0.35 <= r <= 0.75,
        0.30 <= s <= 0.70,
        0.40 <= f <= 0.75,
        0.35 <= c <= 0.70,
        p < 0.40,
        g > 0.80,
        fft < 0.25,
        m < 0.60 and ps < 0.05,
    ])
    if votes >= 4:
        return "RBR", 0.5
    return ("FAKE", 1.0) if s >= 0.60 else ("REAL", 0.0)


def classify_three_way(fake_score, real_prior_v3, forensic_score, cfa_fake,
                       perlin, grain, fft_conf, patch_mean, patch_spread,
                       jpeg_resid, hist_consistency, texture_noise):
    """REAL / TAMPERED / FAKE rule table (appv3.py:4770-4846)."""
    s = _clamp(fake_score, 0.0)
    r = _clamp(real_prior_v3, 0.0)
    f = _clamp(forensic_score, 0.0)
    c = _clamp(cfa_fake, 0.0)
    p = _clamp(perlin, 0.0)
    g = _clamp(grain, 0.0)
    fft = bool(fft_conf)
    m = _clamp(patch_mean, 0.0)
    ps = _clamp(patch_spread, 0.0)
    j = _clamp(jpeg_resid, 0.0)
    hc = _clamp(hist_consistency, 0.0)
    t = _clamp(texture_noise, 0.0)

    # definite fake
    if s > 0.75 and r < 0.30:
        return "FAKE"
    if p > 0.80 and f > 0.60:
        return "FAKE"
    if c > 0.85:
        return "FAKE"
    # definite real
    if r > 0.70 and c < 0.25 and p < 0.40:
        return "REAL"
    if g > 0.80 and c < 0.20:
        return "REAL"
    if fft and f < 0.50:
        return "REAL"
    # tampered: moderately broken CFA + one other anomaly
    if 0.35 < c < 0.80 and (f > 0.60 or p > 0.55 or hc > 0.75 or j > 0.80
                            or ps < 0.04 or t > 0.65):
        return "TAMPERED"
    return "REAL"


def full_label_cascade(s: dict, cfg: DecisionConfig = DEFAULT_DECISION):
    """The complete ordered label-policy cascade of the v5 app
    (appv3.py:5654-5911), as one pure function over a signal dict.

    Expected keys (missing → sensible neutral): p_final, p_global,
    patch_mean, patch_spread, head_delta, risk_idx, entropy, forensic,
    cfa_fake, perlin, grain, fft_conf, real_prior_v3, jpeg_resid_v3,
    esrgan, sat_peak, jpeg_q, face_retouch, exposure, render, hc,
    texture_noise, image_gen, face_p_fake, prnu_scaled, visual_prob,
    freq_prob.

    Returns dict: label, code, band, band_text, band_color, risk_level,
    p_final (possibly escalated), trace (ordered list of fired rules).
    """
    g = lambda k, d=None: s.get(k, d)
    p_final = _clamp(g("p_final", 0.5))
    forensic = _clamp(g("forensic", 0.5))
    trace = []

    # base thresholds (appv3.py:5660-5666)
    if p_final >= cfg.final_fake_thresh:
        label = "FAKE"
    elif p_final <= cfg.final_real_thresh:
        label = "REAL"
    else:
        label = "TAMPERED"

    # uncertain / inconclusive (:5668-5695). risk_idx 0 is a legitimate
    # lowest-risk value — `or 2` would coerce it to 2 and wrongly open the
    # INCONCLUSIVE gate (is_inconclusive requires risk in (1, 2))
    _risk = g("risk_idx", 2)
    risk_idx = 2 if _risk is None else int(_risk)
    if is_inconclusive(p_final, _clamp(g("p_global", p_final)),
                       _clamp(g("patch_mean", 0.5)),
                       risk_idx,
                       float(g("entropy", 0.0) or 0.0),
                       float(g("head_delta", 0.0) or 0.0)) \
            and not cfg.disable_inconclusive:
        label = "INCONCLUSIVE"
        trace.append("inconclusive")
    elif is_uncertain(p_final, risk_idx,
                      _clamp(g("patch_mean", 0.5)),
                      float(g("head_delta", 0.0) or 0.0)) \
            and not cfg.disable_inconclusive:
        label = "UNCERTAIN"
        trace.append("uncertain")

    # RBR → TAMPERED when base REAL-ish (:5698-5737)
    rbr_label, _ = classify_rbr(
        p_final, g("real_prior_v3", 0.0), forensic, g("cfa_fake", 0.5),
        g("perlin", 0.0), g("grain", 0.0), g("fft_conf", 0.5),
        g("patch_mean", 0.5), g("patch_spread", 0.0))
    if rbr_label == "RBR" and label not in ("INCONCLUSIVE", "UNCERTAIN",
                                            "FAKE"):
        label = "TAMPERED"
        trace.append("rbr")

    cfa = g("cfa_fake")
    # CFA overrides (:5740-5760)
    if cfa is not None and cfa < 0.20:
        label = "REAL"
        trace.append("cfa_real_override")
    if cfa is not None and cfa >= 0.85 and p_final >= 0.70 \
            and forensic >= 0.60:
        label = "FAKE"
        trace.append("cfa_fake_override")

    # improvements 1-7 (:5766-5800)
    if g("cfa_fake") is not None and g("grain") is not None \
            and g("jpeg_resid_v3") is not None \
            and g("cfa_fake") < 0.18 and g("grain") > 0.80 \
            and g("jpeg_resid_v3") < 0.002:
        label = "REAL"
        trace.append("real_hard_override")
    if g("esrgan") is not None and g("esrgan") > 0.45 and label != "FAKE":
        label = "TAMPERED"
        trace.append("esrgan")
    if g("sat_peak") is not None and g("sat_peak") > 0.50 and label == "REAL":
        label = "TAMPERED"
        trace.append("saturation")
    if g("jpeg_q") is not None and g("jpeg_q") > 0.60 and label != "FAKE":
        label = "TAMPERED"
        trace.append("jpeg_q")
    if g("face_retouch") is not None and g("face_retouch") > 0.55 \
            and label == "REAL":
        label = "TAMPERED"
        trace.append("face_retouch")
    if g("exposure") is not None and g("exposure") < 0.30 \
            and g("real_prior_v3") is not None \
            and g("real_prior_v3") > 0.30 and label != "FAKE":
        label = "TAMPERED"
        trace.append("exposure")
    if float(g("render", 0.0) or 0.0) > 0.70 and label == "REAL":
        label = "TAMPERED"
        trace.append("render")

    # three-way classifier override (:5803-5820). Parity note: like the
    # reference, this overwrite is unconditional on the label value, so
    # the improvement rules above shape only the trace (the reference
    # keeps their label writes solely for its classify_three_way
    # exception fallback); the rules' signals re-enter through
    # classify_three_way's own conditions and the gates below
    if label not in ("INCONCLUSIVE", "UNCERTAIN"):
        label = classify_three_way(
            p_final, g("real_prior_v3"), forensic, g("cfa_fake"),
            g("perlin"), g("grain"), g("fft_conf"), g("patch_mean"),
            g("patch_spread"), g("jpeg_q"), g("hc"), g("texture_noise"))
        trace.append(f"three_way={label}")

    # image-only generator attribution (:5822-5826; env defaults 187-197)
    ig = float(g("image_gen", 0.0) or 0.0)
    if ig >= 0.70 and p_final >= 0.50:
        label = "FAKE"
        trace.append("image_gen_fake")
    elif ig >= 0.45 and label in ("REAL", "INCONCLUSIVE", "UNCERTAIN"):
        label = "TAMPERED"
        trace.append("image_gen_tampered")

    # face escalation (:5828-5832)
    override_label = None
    fpf = g("face_p_fake")
    if fpf is not None and fpf > 0.65:
        label = "FAKE"
        override_label = "FAKE"
        p_final = max(p_final, float(fpf) * 0.9)
        trace.append("face_escalation")

    # real gate + model escalation (:5836-5876)
    gate_ok = real_gate(p_final, forensic, g("jpeg_q"), g("hc"),
                        g("prnu_scaled"), g("patch_spread"))
    if label == "REAL" and not gate_ok:
        label = "TAMPERED"
        trace.append("real_gate_block")
    vp = float(g("visual_prob", 0.0) or 0.0)
    fp = float(g("freq_prob", 0.0) or 0.0)
    pm = _clamp(g("patch_mean", 0.0))
    if label == "REAL" and (vp > 0.65 or fp > 0.65) and pm > 0.60:
        label = "FAKE" if p_final > 0.60 else "TAMPERED"
        override_label = label
        trace.append("model_escalation")
    votes = tamper_votes(forensic, g("jpeg_q"), g("hc"))
    # (the reference's separate `TAMPERED and real_pass(...) and votes<2`
    # demotion, appv3.py:5869-5872, is subsumed by the votes<2 rule below,
    # which demotes regardless of real_pass)
    if label == "TAMPERED" and votes >= 2 and forensic > 0.70 \
            and (vp > 0.65 or fp > 0.65):
        label = "FAKE"
        override_label = "FAKE"
        p_final = max(p_final, 0.70)
        trace.append("tamper_to_fake")
    if label == "TAMPERED" and votes < 2:
        label = "REAL"
        if override_label in (None, "TAMPERED"):
            override_label = "REAL"
        trace.append("tamper_votes_low")
    if label == "REAL" and votes < 2 and override_label is None:
        override_label = "REAL"

    # final consistency pass (:5890-5911). Parity note: when an
    # override_label is set (face/model/vote escalations and demotions),
    # finalize skips the p_fake↔label consistency check exactly like the
    # reference (appv3.py:4631-4648) — the policy trusts its vote-based
    # overrides over the fused probability, so e.g. a quiet-forensics
    # high-p_final image demoted by tamper_votes_low ships as REAL
    label, code, band_text, band_color, band, risk = finalize_label_and_risk(
        label, p_final, forensic, allow_real=gate_ok,
        override_label=override_label, cfg=cfg)
    if label == "TAMPERED" and votes < 2:
        label = "REAL"
        code = 0.0
        band_text, band_color, band, risk = traffic_light_label(
            label, p_final, forensic)
        trace.append("final_tamper_votes_low")
    if (cfg.disable_inconclusive and label in ("INCONCLUSIVE", "UNCERTAIN")) \
            or (cfg.disable_tampered and label in ("TAMPERED",)):
        label = "FAKE" if p_final >= cfg.final_fake_thresh else "REAL"
        code = LABEL_CODES[label]
        band_text, band_color, band, risk = traffic_light_label(
            label, p_final, forensic)
        trace.append("binary_guard")

    return {"label": label, "code": code, "band": band,
            "band_text": band_text, "band_color": band_color,
            "risk_level": risk, "p_final": p_final, "trace": trace,
            "tamper_votes": votes, "real_gate": gate_ok}


def finalize_label_and_risk(label, p_fake, forensic_val, allow_real=True,
                            override_label=None,
                            cfg: DecisionConfig = DEFAULT_DECISION):
    """Consistency pass: probability↔label agreement, TAMPERED/INCONCLUSIVE
    gating, numeric code, traffic-light band (appv3.py:4623-4668).

    Returns (label, code, band_text, band_color, band, risk_level)."""
    p_fake = _clamp(p_fake)
    f = _clamp(forensic_val, 0.5)

    if override_label is not None:
        label = override_label
    elif label == "INCONCLUSIVE":
        if not cfg.disable_inconclusive:
            return label, None, "INCONCLUSIVE", "#9ca3af", "GRAY", "INCONCLUSIVE"
        label = "FAKE" if p_fake >= cfg.final_fake_thresh else "REAL"
    elif label == "UNCERTAIN":
        if not cfg.disable_inconclusive:
            return (label, None, "UNCERTAIN - low confidence", "#9ca3af",
                    "GRAY", "UNCERTAIN")
        label = "FAKE" if p_fake >= cfg.final_fake_thresh else "REAL"

    if override_label is None:
        if p_fake >= cfg.final_fake_thresh:
            label = "FAKE"
        elif p_fake <= cfg.final_real_thresh:
            label = "REAL" if allow_real else "TAMPERED"
        else:
            label = "TAMPERED"

    if cfg.disable_tampered and label in ("TAMPERED", "RBR", "RETOUCHED_REAL"):
        label = "FAKE" if p_fake >= cfg.final_fake_thresh else "REAL"
    if cfg.disable_inconclusive and label in ("INCONCLUSIVE", "UNCERTAIN"):
        label = "FAKE" if p_fake >= cfg.final_fake_thresh else "REAL"

    if label in ("TAMPERED", "RBR", "RETOUCHED_REAL"):
        label = "TAMPERED"
    code = LABEL_CODES.get(label)

    band_text, band_color, band, risk = traffic_light_label(label, p_fake, f)
    return label, code, band_text, band_color, band, risk
