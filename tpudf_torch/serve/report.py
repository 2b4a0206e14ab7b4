"""End-to-end image report: experts → forensics → fusion → labels → JSON
(tpudf/serve/report.py, the image half).

The batched equivalent of the reference `_predict_single_image`
(appv3.py:5117-6227): the detection engine (multicrop / TTA / patch grid),
the forensic battery, the rendering score, the generator-likelihood vote,
the optional GBDT override, Bayesian-V2 + Dirichlet fusion and the
hierarchical final probability run on the engine's device; the label
cascade and the verdict run per image on the host, and each image gets the
~50-signal report (appv3.py:6112-6164).

Device work of a batch (`dispatch_images`) is launched without waiting:
the engine's core, then the fusion tail, which packs every per-image
scalar into ONE (B, K) f32 tensor in JAX's column order (core names, then
fb_* battery keys, then TAIL_SCALARS), then the face escalation.
`predict_images` makes ONE device→host copy of all of it, and the rest is
numpy. The tail runs inside `forensics.f32_math()`: its convolutions and
products stay f32 on the card (cuDNN's TF32 default off).

`predict_video` (the video report) launches the fast batch of the clip's
frames, then the temporal / SORA battery (`_video_temporal_for`: the
tower's frame embeddings and every temporal signal packed into ONE (K,)
tensor), before its first fetch; then the host's face trio, the SORA vote,
the escalation cascade and the chosen frame's full report.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.core.config import _env_float as _envf
from tpudf_torch.data.pipeline import resize
from tpudf_torch.fuse.bayesian import bayesian_fuse_v2, dirichlet_fuse
from tpudf_torch.fuse.decision import (DEFAULT_DECISION, DecisionConfig,
                                       classify_rbr, classify_three_way,
                                       full_label_cascade)
from tpudf_torch.fuse.hierarchical import final_probability
from tpudf_torch.fuse.temporal import (aggregate_sora,
                                       compute_temporal_signals,
                                       host_flow_signals,
                                       render_scores_graph)
from tpudf_torch.fuse.video_agg import (aggregate_video_probs,
                                        temporal_frame_weights)
from tpudf_torch.fuse.verdict import decide_verdict
from tpudf_torch.ops.flow import exposure_blur_regularity
from tpudf_torch.ops.forensics import (BATTERY_KEYS, _gray, f32_math,
                                       forensic_battery,
                                       image_generator_likelihood)
from tpudf_torch.serve.engine import (_LAYOUT_KEY, _PACK_KEY, FAST_SCALARS,
                                      FULL_SCALARS, DetectEngine,
                                      pad_to_bucket, to_device)

# per-image scalars the fusion tail computes on device, in pack order
TAIL_SCALARS = ("bayes_cal_jpeg", "bayes_certainty", "bayes_posterior",
                "diri_conflict", "diri_uncertainty", "embed_cos_dev",
                "embed_score", "gen_likelihood", "hb_prob", "render_score",
                "xgb_prob")


def _pad_stack(rows, bucket_of):
    """Stack same-shaped device tensors and zero-pad the leading dim to a
    pow2 bucket (the JAX package's bucket, kept for the same batch sizes)."""
    n = len(rows)
    stack = torch.stack(rows)
    pad = bucket_of - n
    if pad:
        stack = torch.cat([stack, stack.new_zeros((pad,) + stack.shape[1:])])
    return stack


def _crop_to(crop, size, device):
    """A host uint8 crop resized on `device` to (size, size, 3): bilinear
    (antialiased, jax.image.resize's), clipped, then truncated to uint8 as
    the JAX package does."""
    cj = to_device(crop, device).float()
    return torch.clamp(resize(cj, (size, size, 3), "bilinear"),
                       0, 255).to(torch.uint8)


def _dispatch_face(engine, pixels_uint8):
    """Face-crop expert escalation + retouch score (appv3.py:5429-5452),
    dispatch phase: host Haar detection, then every device step (per-crop
    bilinear resize, the batched retouch score, the full expert stack on
    qualifying crops: face >= 8% of the frame and >= 96px a side) launched
    un-fetched, so predict_images' one copy covers the face payload too."""
    from tpudf_torch.serve.face import face_crop, retouch_scores
    dev = engine.device
    b = pixels_uint8.shape[0]
    det_idx, esc_idx = [], []
    retouch_crops, esc_crops = [], []
    s = int(pixels_uint8.shape[1])
    for i in range(b):
        img = pixels_uint8[i]
        c = face_crop(img)
        if c is None:
            continue
        fh, fw = c.shape[:2]
        retouch_crops.append(_crop_to(c, 256, dev))
        det_idx.append(i)
        area_ratio = (fh * fw) / float(img.shape[0] * img.shape[1])
        if area_ratio >= 0.08 and min(fh, fw) >= 96:
            esc_idx.append(i)
            esc_crops.append(_crop_to(c, s, dev))
    out = {"det_idx": det_idx, "esc_idx": esc_idx}
    with torch.no_grad():
        if det_idx:
            bucket = 1 << (len(det_idx) - 1).bit_length()
            out["retouch"] = retouch_scores(_pad_stack(retouch_crops, bucket))
        if esc_idx:
            bucket = 1 << (len(esc_idx) - 1).bit_length()
            core = engine.dispatch_batch(_pad_stack(esc_crops, bucket))
            out["esc_p"] = core[_PACK_KEY][:, FULL_SCALARS.index(
                "p_fake_raw")]
    return out


def _face_signals_from_fetched(face, b):
    """(face_p_fake, face_retouch) lists from the fetched _dispatch_face
    payload."""
    p_fake = [None] * b
    retouch = [None] * b
    if not face:
        return p_fake, retouch
    ret = np.asarray(face.get("retouch", ()), np.float64)
    for j, i in enumerate(face["det_idx"]):
        retouch[i] = float(ret[j])
    esc = np.asarray(face.get("esc_p", ()), np.float64)
    for j, i in enumerate(face["esc_idx"]):
        p_fake[i] = float(esc[j])
    return p_fake, retouch


def _core_part(core, names, key):
    """One non-scalar output of the engine's packed core, (B, ...)."""
    col = len(names)
    for k, shape in core[_LAYOUT_KEY]:
        n = int(np.prod(shape))
        if k == key:
            packed = core[_PACK_KEY]
            return packed[:, col:col + n].reshape(packed.shape[0], *shape)
        col += n
    raise KeyError(key)


def _build_fusion_tail(engine: DetectEngine, fast: bool):
    """The device graph for everything predict_images needs beyond the
    detect core: forensic battery, rendering score, embedding anomaly,
    generator-likelihood vote, optional GBDT override, Bayesian-V2 +
    Dirichlet fusion and the hierarchical final probability — the fusion
    math of appv3.py:5117-6227, batched, on the engine's device. Every
    per-image scalar packs into ONE (B, K) tensor.

    Returns (fn(core, pixels_uint8) -> (packed (B, K), aux), names), where
    pixels_uint8 is the batch on the engine's device and names maps packed
    columns back to signal names host-side. The artifacts are moved to the
    device here, once."""
    dev = engine.device
    core_names = FAST_SCALARS if fast else FULL_SCALARS
    fb_keys = BATTERY_KEYS
    names = core_names + tuple(f"fb_{k}" for k in fb_keys) + TAIL_SCALARS
    assert len(set(names)) == len(names), "packed-name collision"

    mean_real = (None if engine.mean_real is None else
                 to_device(np.asarray(engine.mean_real, np.float32), dev))
    gbdt = None if engine.gbdt is None else engine.gbdt.to(dev)
    calib = (None if engine.bayes_calibration is None
             else engine.bayes_calibration.to(dev))

    @torch.no_grad()
    def tail(core, pixels_uint8):
        with f32_math():
            return _tail(core, pixels_uint8)

    def _tail(core, pixels_uint8):
        b = pixels_uint8.shape[0]
        x = pixels_uint8.float() / 255.0
        if x.shape[1] != 256:
            x = resize(x, (b, 256, 256, 3), "bilinear")
        fb = forensic_battery(x)
        packed_core = core[_PACK_KEY].float()
        cs = {k: packed_core[:, i] for i, k in enumerate(core_names)}
        visual, freq = cs["visual_prob"], cs["freq_prob"]
        zeros = torch.zeros_like(visual)
        if fast:
            patch_mean = torch.full_like(visual, 0.5)
            max_patch = torch.full_like(visual, 0.5)
        else:
            patch_mean, max_patch = cs["patch_mean"], cs["max_patch"]
        patch_spread = max_patch - patch_mean
        head_delta = torch.abs(visual - freq)

        # embedding anomaly (appv3.py:3494-3516) + rendering score
        # (:5385-5394) — full path only, same gates as the reference
        if fast:
            embed_score, cos_dev, render = zeros, zeros, zeros
        else:
            l2n = torch.clamp(cs["embed_l2"] / 28.0, max=1.0)
            cos_dev = zeros
            if mean_real is not None:
                feat = _core_part(core, core_names, "embed_feat").float()
                denom = (torch.linalg.vector_norm(feat, dim=1)
                         * torch.linalg.vector_norm(mean_real) + 1e-6)
                cos = feat @ mean_real / denom
                cos_dev = torch.clamp((1.0 - cos) * 3.0, 0.0, 1.0)
            embed_score = 0.6 * l2n + 0.4 * cos_dev
            render = render_scores_graph(pixels_uint8)

        prnu_scaled = torch.clamp(fb["prnu_strength"] / 0.8, 0.0, 1.0)
        # generator-likelihood vote (appv3.py:2569-2645 via :5472-5496)
        gen = image_generator_likelihood({
            "diffusion": fb["diffusion_v2"],
            "perlin": fb["perlin"],
            "texture_noise": fb["texture_noise"],
            "render": render,
            "jpeg_q": fb["jpeg_q_mismatch"],
            "sat_peak": fb["saturation_peak"],
            "spectral": fb["spectral_flatness"],
            "cfa_fake": fb["cfa_fake"],
            "esrgan": fb["esrgan_grid"],
            "embedding_anomaly": embed_score,
            "patch_spread": patch_spread,
            "head_delta": head_delta,
            "prnu_scaled": prnu_scaled,
            "grain_real": fb["grain"],
            "real_prior_v4": fb["real_prior_agg"],
            "hc_score": 1.0 - fb["histogram_consistency"],
        })
        forensic_score = fb["forensic_v2"]

        # XGBoost/GBDT fusion override (appv3.py:5507-5578): the booster
        # probability replaces the core fusion probability; 19-d feature
        # order matches the reference exactly
        if gbdt is not None and not fast:
            diff_v2, cfa = fb["diffusion_v2"], fb["cfa_fake"]
            feats19 = torch.stack([
                cs["z_sig"], cs["z_freq"],
                torch.abs(cs["z_sig"] - cs["z_freq"]),
                visual, freq,
                torch.clamp(0.4 * diff_v2 + 0.6 * cfa, 0.0, 1.0),
                diff_v2,
                fb["spectral_flatness"],
                zeros,                         # edge continuity (disabled)
                fb["color_correlation"],
                fb["jpeg_residual"],
                embed_score,
                max_patch, patch_mean, patch_spread,
                cfa,
                fb["texture_noise"],
                fb["perlin"],
                head_delta,
            ], dim=1).float()
            xgb = gbdt.predict_proba(feats19)
            p_blend_eff = xgb
        else:
            xgb = torch.full_like(visual, float("nan"))
            p_blend_eff = cs["p_blend"]

        bayes = bayesian_fuse_v2({
            "visual": visual, "freq": freq, "forensic": forensic_score,
            "cfa": fb["cfa_fake"], "jpeg": fb["jpeg_q_mismatch"],
            "prnu": 1.0 - prnu_scaled, "patch": patch_mean,
        }, calibration=calib)
        diri = dirichlet_fuse({
            "visual": visual, "freq": freq, "forensic": forensic_score,
            "cfa": fb["cfa_fake"], "jpeg": fb["jpeg_q_mismatch"],
            "patch": patch_mean,
        })
        # hierarchical bayesian final probability (appv3.py:4956-5103);
        # like the reference's final_decision, its L1 core comes from
        # visual/freq/coral only — the booster override reaches the label
        # cascade through p_blend (predict_images), not hb
        hb = final_probability(
            visual, freq, p_blend_eff, cs["p_fake_coral"], forensic_score,
            fb["diffusion"], max_patch, patch_mean, head_delta,
            spectral_score=fb["spectral_flatness"],
            color_score=fb["color_correlation"],
            cfa_fake_score=fb["cfa_fake"], real_prior=fb["real_prior_v3"])

        tail_vals = {
            # the (possibly isotonic-recalibrated) jpeg cue — the verdict's
            # benign-JPEG penalty reads it as "jpeg" (appv3.py:5936-5937)
            "bayes_cal_jpeg": bayes["calibrated"]["jpeg"],
            "bayes_certainty": bayes["certainty"],
            "bayes_posterior": bayes["posterior_fake"],
            "diri_conflict": diri["conflict"],
            "diri_uncertainty": diri["uncertainty"],
            "embed_cos_dev": cos_dev,
            "embed_score": embed_score,
            "gen_likelihood": gen,
            "hb_prob": hb,
            "render_score": render,
            "xgb_prob": xgb,
        }
        cols = ([cs[k] for k in core_names]
                + [fb[k] for k in fb_keys]
                + [tail_vals[k] for k in TAIL_SCALARS])
        packed = torch.stack([c.float() for c in cols], dim=1)
        aux = {"risk_probs": _core_part(core, core_names, "risk_probs")}
        if not fast:
            aux["patch_probs"] = _core_part(core, core_names, "patch_probs")
        return packed, aux

    return tail, names


def _fusion_tail_for(engine: DetectEngine, fast: bool):
    """Per-engine tail cache, keyed on the optional artifacts the tail
    closes over (mean_real / gbdt / bayes_calibration). The cache value
    pins the keyed objects so their ids cannot be recycled under us."""
    cache = engine.__dict__.setdefault("_report_tail_cache", {})
    key = (bool(fast), id(engine.mean_real), id(engine.gbdt),
           id(engine.bayes_calibration))
    hit = cache.get(key)
    if hit is None:
        fn, names = _build_fusion_tail(engine, fast)
        hit = cache[key] = (fn, names, (engine.mean_real, engine.gbdt,
                                        engine.bayes_calibration))
    return hit[0], hit[1]


def dispatch_images(engine: DetectEngine, pixels_uint8: np.ndarray,
                    fast: bool = False, pad_batch: bool = False,
                    max_batch: int | None = None):
    """Phase 1 of predict_images: launch the device work and return the
    un-fetched tensors (packed, aux, names, face). CUDA launches are
    asynchronous, so the caller can do host work (decode / drain the next
    batch) while the card runs, then pass them to predict_images(...,
    _dispatched=...) to finalize; serve/service.DetectService does so.

    pad_batch=True pads the device batch to a power-of-2 bucket
    (pad_to_bucket, capped at max_batch) — predict_images slices every
    per-image array back to the true batch size."""
    orig = np.asarray(pixels_uint8)
    pixels = pad_to_bucket(orig, max_batch) if pad_batch else orig
    px = to_device(pixels, engine.device)
    core = engine.dispatch_batch(px, fast=fast)        # un-fetched
    fn, names = _fusion_tail_for(engine, fast)
    packed, aux = fn(core, px)
    # the face trio launches AFTER the main work (host Haar detection runs
    # while the card is busy) and stays un-fetched until predict_images'
    # single copy
    face = None if fast else _dispatch_face(engine, orig)
    return packed, aux, names, face


def _fetch(packed, aux, face):
    """ONE device→host copy of everything a batch launched: the packed
    tensor, the aux outputs and the face payload, concatenated on the
    device first. Returns numpy (packed, aux, face)."""
    aux_keys = sorted(aux)
    face = dict(face or {})
    face_keys = [k for k in ("retouch", "esc_p") if k in face]
    parts = ([packed] + [aux[k] for k in aux_keys]
             + [face[k] for k in face_keys])
    host = torch.cat([p.float().reshape(-1) for p in parts]).cpu().numpy()
    out, col = [], 0
    for p in parts:
        out.append(host[col:col + p.numel()].reshape(p.shape))
        col += p.numel()
    aux = dict(zip(aux_keys, out[1:1 + len(aux_keys)]))
    face.update(zip(face_keys, out[1 + len(aux_keys):]))
    return out[0], aux, face


def predict_images(engine: DetectEngine, pixels_uint8: np.ndarray,
                   decision: DecisionConfig = DEFAULT_DECISION,
                   fast: bool = False, _dispatched=None) -> list[dict]:
    """pixels_uint8: (B, S, S, 3) → list of per-image report dicts."""
    packed, aux, names, face = (
        _dispatched if _dispatched is not None
        else dispatch_images(engine, pixels_uint8, fast))
    # ONE blocking copy for everything dispatch launched; everything below
    # is numpy. Slice back to the true batch in case dispatch padded.
    b = pixels_uint8.shape[0]
    packed, aux, face = _fetch(packed, aux, face)
    packed = np.asarray(packed, np.float64)[:b]
    vals = {k: packed[:, i] for i, k in enumerate(names)}
    aux = {k: np.asarray(v)[:b] for k, v in aux.items()}
    fb = {k[3:]: v for k, v in vals.items() if k.startswith("fb_")}
    core = {k: v for k, v in vals.items() if not k.startswith("fb_")}

    p_blend = core["p_blend"]
    visual = core["visual_prob"]
    freq = core["freq_prob"]
    if fast:
        patch_mean = np.full(b, 0.5)
        max_patch = np.full(b, 0.5)
    else:
        patch_mean = core["patch_mean"]
        max_patch = core["max_patch"]
    patch_spread = max_patch - patch_mean

    # full-path-only signals (appv3.py gates these on `not fast_mode` too:
    # embed :5240-5242, render :5385-5394, face :5429); the tail emits
    # zeros for embed/render in fast mode, matching the reference defaults
    embed_score = core["embed_score"]
    embed_l2 = core.get("embed_l2", np.zeros(b))
    embed_cos = core["embed_cos_dev"]
    render = core["render_score"]
    if fast:
        face_p_fake = [None] * b
        face_retouch = [None] * b
    else:
        face_p_fake, face_retouch = _face_signals_from_fetched(face, b)

    gen = core["gen_likelihood"]
    # v3 forensic fusion (appv3.py:2934-2951 via :5455 forensic_v2)
    forensic_score = fb["forensic_v2"]

    # GBDT fusion override: probability computed in-tail; NaN marks "no
    # booster attached" (the tail is cached per engine-artifact identity)
    xgb_prob = None
    if engine.gbdt is not None and not fast:
        xgb_prob = core["xgb_prob"]
        p_blend = xgb_prob.copy()

    bayes = {"posterior_fake": core["bayes_posterior"],
             "certainty": core["bayes_certainty"]}
    diri = {"uncertainty": core["diri_uncertainty"],
            "conflict": core["diri_conflict"]}
    # hierarchical bayesian final decision (v2 engine, appv3.py:4956-5103):
    # probability from the in-tail final_probability; label threshold here
    hb_prob = core["hb_prob"]
    hb_label = np.where(hb_prob >= decision.final_fake_thresh,
                        "FAKE", "REAL")

    reports = []
    for i in range(b):
        p_final = float(p_blend[i])
        head_delta = abs(visual[i] - freq[i])
        prnu_scaled = float(np.clip(fb["prnu_strength"][i] / 0.8, 0, 1))

        # opt-in false-positive shield (appv3.py:3191-3208)
        if decision.use_stabilized_fusion and not fast and xgb_prob is None:
            from tpudf_torch.fuse.decision import stabilized_fusion
            p_final = stabilized_fusion(
                float(np.asarray(core["p_fake_raw"])[i]),
                float(np.asarray(core["p_fake_coral"])[i]),
                float(visual[i]), float(freq[i]),
                float(max_patch[i]), float(patch_mean[i]))

        # diagnostics: three-way + RBR rule-table outputs (also applied
        # inside the cascade). jpeg_resid takes the Q-mismatch score like
        # the cascade and the reference (appv3.py:5812)
        three_way = classify_three_way(
            p_final, fb["real_prior_v3"][i], forensic_score[i],
            fb["cfa_fake"][i], fb["perlin"][i], fb["grain"][i],
            fb["multiscale_fft"][i], patch_mean[i], patch_spread[i],
            fb["jpeg_q_mismatch"][i], fb["histogram_consistency"][i],
            fb["texture_noise"][i])
        rbr_label, rbr_code = classify_rbr(
            p_final, fb["real_prior_v3"][i], forensic_score[i],
            fb["cfa_fake"][i], fb["perlin"][i], fb["grain"][i],
            fb["multiscale_fft"][i], patch_mean[i], patch_spread[i])

        # XGB override keeps p_global in sync (appv3.py:5576-5578)
        p_global = (float(xgb_prob[i]) if xgb_prob is not None
                    else float(np.asarray(core["p_fake_coral"])[i]))
        cascade = full_label_cascade({
            "p_final": p_final,
            "p_global": p_global,
            "patch_mean": float(patch_mean[i]),
            "patch_spread": float(patch_spread[i]),
            "head_delta": float(head_delta),
            "risk_idx": int(np.asarray(core["risk_idx"])[i]),
            "entropy": float(np.asarray(core["entropy"])[i]),
            "forensic": float(forensic_score[i]),
            "cfa_fake": float(fb["cfa_fake"][i]),
            "perlin": float(fb["perlin"][i]),
            "grain": float(fb["grain"][i]),
            "fft_conf": float(fb["multiscale_fft"][i]),
            "real_prior_v3": float(fb["real_prior_v3"][i]),
            "jpeg_resid_v3": float(fb["jpeg_residual"][i]),
            "esrgan": float(fb["esrgan_grid"][i]),
            "sat_peak": float(fb["saturation_peak"][i]),
            "jpeg_q": float(fb["jpeg_q_mismatch"][i]),
            "exposure": float(fb["exposure_variation"][i]),
            "hc": float(fb["histogram_consistency"][i]),
            "texture_noise": float(fb["texture_noise"][i]),
            "image_gen": float(gen[i]),
            "prnu_scaled": prnu_scaled,
            "visual_prob": float(visual[i]),
            "freq_prob": float(freq[i]),
            "render": float(render[i]),
            "face_p_fake": face_p_fake[i],
            "face_retouch": face_retouch[i],
        }, decision)
        final_label = cascade["label"]
        p_final = cascade["p_final"]

        report = {
            "final_label": final_label,
            "prediction_code": cascade["code"],
            "final_prob": p_final,
            "band": cascade["band"], "band_text": cascade["band_text"],
            "band_color": cascade["band_color"],
            "risk_level": cascade["risk_level"],
            "label_trace": cascade["trace"],
            "tamper_votes": cascade["tamper_votes"],
            "real_gate": cascade["real_gate"],
            "risk_idx": int(np.asarray(core["risk_idx"])[i]),
            "risk_probs": np.asarray(aux["risk_probs"])[i].tolist(),
            "entropy": float(np.asarray(core["entropy"])[i]),
            "visual_head": float(visual[i]),
            "freq_head": float(freq[i]),
            "head_delta": float(head_delta),
            "z_sig": float(np.asarray(core["z_sig"])[i]),
            "z_freq": float(np.asarray(core["z_freq"])[i]),
            "p_fake_raw": float(np.asarray(core["p_fake_raw"])[i]),
            "p_fake_coral": float(np.asarray(core["p_fake_coral"])[i]),
            "patch_mean": float(patch_mean[i]),
            "max_patch": float(max_patch[i]),
            "patch_spread": float(patch_spread[i]),
            "forensic_score": float(forensic_score[i]),
            "generator_likelihood": float(gen[i]),
            "three_way": three_way,
            "rbr": rbr_label,
            "bayes_final_prob": float(hb_prob[i]),
            "bayes_final_label": str(hb_label[i]),
            "bayesian_fusion_posterior": float(bayes["posterior_fake"][i]),
            "bayesian_fusion_certainty": float(bayes["certainty"][i]),
            "dirichlet_uncertainty": float(diri["uncertainty"][i]),
            "dirichlet_conflict": float(diri["conflict"][i]),
            "jpeg_q_mismatch_score": float(fb["jpeg_q_mismatch"][i]),
            # calibrated jpeg cue for decide_verdict's benign-JPEG penalty
            # (appv3.py:5936-5937 → apply_benign_jpeg_penalty :4412)
            "jpeg": float(np.asarray(core["bayes_cal_jpeg"])[i]),
            "saturation_peak_score": float(fb["saturation_peak"][i]),
            "cfa_fake_score": float(fb["cfa_fake"][i]),
            "prnu_strength_raw": float(fb["prnu_strength"][i]),
            "embedding_anomaly": float(embed_score[i]),
            "embedding_l2": float(embed_l2[i]),
            "embedding_cos_dev": float(embed_cos[i]),
            "rendering_pipeline_score": float(render[i]),
            "face_p_fake": face_p_fake[i],
            "face_retouch_score": face_retouch[i],
            "xgb_fusion_prob": (float(xgb_prob[i]) if xgb_prob is not None
                                else None),
        }
        # per-cue forensic signals
        for k, v in fb.items():
            report[f"forensic_{k}"] = float(v[i])
        if not fast:
            report["patch_probs"] = np.asarray(aux["patch_probs"])[i].tolist()
        verdict = decide_verdict(report)
        report["verdict"] = {
            "label": verdict.label, "band": verdict.band,
            "risk_level": verdict.risk_level,
            "prob_fake": verdict.prob_fake,
            "certainty": verdict.certainty, "reason": verdict.reason,
        }
        reports.append(report)
    return reports


# the battery's signals besides the flow family and id_drift
_TEMPORAL_BASE = ("background_inconsistency", "color_drift", "edge_flicker",
                  "jpeg_block_drift", "noise_incoherence", "prnu_drift",
                  "prnu_flat_drift", "render_regularity", "spectral_drift",
                  "texture_flicker")
_FLOW = ("affine_inconsistency", "flow_dir_incoherence",
         "flow_fb_inconsistency", "flow_reprojection", "klt_instability",
         "parallax_err")


@torch.no_grad()
def temporal_battery(x256, embeds=None):
    """compute_temporal_signals of (T, 256, 256, 3) [0,1] frames (with the
    identity drift of `embeds` when given) and the render-regularity score
    across them (the video counterpart of appv3.py:2525-2566), under
    f32_math(): {name: 0-d tensor} on the frames' device."""
    with f32_math():
        sig = compute_temporal_signals(x256, embeds)
        exposure, blur = exposure_blur_regularity(_gray(x256))
        sig["render_regularity"] = torch.clamp(
            0.55 * exposure + 0.45 * blur, 0.0, 1.0)
    return sig


def _video_temporal_for(engine: DetectEngine, frames_uint8,
                        with_embeds: bool):
    """The per-clip temporal / SORA battery: compute_temporal_signals on
    the frames resized to 256 px (the dense-LK flow family included), the
    identity drift of the tower's own frame embeddings
    (`DetectEngine.embed_frames` at the tower's input size, no ToMe) and
    the render-regularity score, packed into ONE (K,) f32 tensor on the
    engine's device: one launch stream, one later copy (the eager form
    paid a copy per signal). The battery runs under f32_math(); it
    synchronises nothing. Cached per (t, s, with_embeds, backbone).
    Returns (fn(frames uint8 on the device) -> (K,), sorted names)."""
    t, s = int(frames_uint8.shape[0]), int(frames_uint8.shape[1])
    cache = engine.__dict__.setdefault("_video_temporal_cache", {})
    key = (t, s, bool(with_embeds), id(engine.backbone))
    hit = cache.get(key)
    if hit is not None:
        return hit[0], hit[1]

    names = _TEMPORAL_BASE + (_FLOW if t >= 3 else ()) \
        + (("id_drift",) if with_embeds else ())
    names = tuple(sorted(names))

    @torch.no_grad()
    def packed(frames):
        x = frames.float() / 255.0
        embeds = engine.embed_frames(x) if with_embeds else None
        with f32_math():
            x256 = (x if s == 256 else
                    resize(x, (t, 256, 256, 3), "bilinear"))
        sig = temporal_battery(x256, embeds)
        if set(sig) != set(names):
            raise ValueError(f"battery signals {sorted(sig)} != {names}")
        return torch.stack([sig[k].float() for k in names])

    # pin the keyed backbone so its id cannot be recycled under the cache
    cache[key] = (packed, names, engine.backbone)
    return packed, names


# sora escalation thresholds, env-tunable with the reference's variable
# names (appv3.py:163-185). At the defaults the "med" odds tier (sl >=
# tampered + 0.15) is shadowed by the "high" branch (sl >= fake), exactly
# as in the reference; it becomes live when SORA_FAKE_THRESH is raised
# above SORA_TAMPERED_THRESH + 0.15
SORA_TAMPERED_THRESH = _envf("SORA_TAMPERED_THRESH", 0.15, 0.01, 0.99)
SORA_FAKE_THRESH = _envf("SORA_FAKE_THRESH", 0.20, 0.01, 0.99)
SORA_ODDS = {"low": _envf("SORA_ODDS_LOW", 1.12, 1.0, 5.0),
             "med": _envf("SORA_ODDS_MED", 1.25, 1.0, 5.0),
             "high": _envf("SORA_ODDS_HIGH", 1.45, 1.0, 5.0)}


def _odds(p, eps=1e-6):
    p = float(np.clip(p, eps, 1 - eps))
    return p / (1 - p)


def _from_odds(o):
    return float(o / (1 + o))


def predict_video(engine: DetectEngine, frames_uint8: np.ndarray,
                  decision: DecisionConfig = DEFAULT_DECISION,
                  agg_mode="topk_mean", strictness="balanced",
                  temporal_signals=True, flow_signals=False) -> dict:
    """frames_uint8: (T, S, S, 3) sampled frames → video-level report.
    Mirrors the video branch (appv3.py:6254-6630): fast per-frame scoring,
    aggregation, temporal / SORA battery, odds-multiplier escalation, full
    analysis on the chosen frame."""
    from tpudf_torch.serve import face as face_mod
    frames_uint8 = np.asarray(frames_uint8)
    t = len(frames_uint8)
    # launch every device step before the first fetch: the frames' fast
    # batch, then the temporal / SORA battery
    disp = dispatch_images(engine, frames_uint8, fast=True)
    temporal_fut, temporal_names = None, ()
    if temporal_signals and t >= 3:
        fn, temporal_names = _video_temporal_for(engine, frames_uint8,
                                                 with_embeds=True)
        temporal_fut = fn(to_device(frames_uint8, engine.device))

    frame_reports = predict_images(engine, frames_uint8, decision, fast=True,
                                   _dispatched=disp)
    probs = np.asarray([r["final_prob"] for r in frame_reports])
    preds = [r["final_label"] for r in frame_reports]
    diffs = np.abs(np.diff(frames_uint8.astype(np.float32), axis=0)).mean(
        axis=(1, 2, 3))
    weights = temporal_frame_weights(np.concatenate(
        [[diffs.mean() if len(diffs) else 0.0], diffs]))
    video_prob, video_label, chosen, metrics = aggregate_video_probs(
        probs, preds, agg_mode=agg_mode, strictness=strictness,
        weights=weights)

    sora = {"sora_likelihood": 0.0, "temporal_consistency_score": 0.0,
            "sora_flag": False}
    signals = {}
    if temporal_fut is not None:
        # ONE copy of the packed battery; NaN marks a gated signal
        # (parallax on a static clip), dropped here
        packed = temporal_fut.cpu().numpy().astype(np.float64)
        signals = {k: float(v) for k, v in zip(temporal_names, packed)
                   if float(v) == float(v)}
        if flow_signals:
            # the optional host cv2 flow battery (overrides the device
            # values where it gives a signal)
            signals.update(host_flow_signals(list(frames_uint8)))

        # face temporal drift family (appv3.py:3557-3755): one shared
        # detection / alignment / embedding pass; the landmark net if its
        # weights resolve, else Haar box geometry; the tower's embeddings
        # (engine.embed_batch) where the identity net is off
        face_sigs = face_mod.face_temporal_signals(
            list(frames_uint8), engine.embed_batch,
            lm_params=face_mod.get_landmark_params(engine.device),
            device=engine.device)
        signals.update({k: float(v) for k, v in face_sigs.items()
                        if v is not None})
        sora = aggregate_sora(signals)

    # escalation cascade (appv3.py:6507-6534)
    tc = sora["temporal_consistency_score"]
    sl = sora["sora_likelihood"]
    if tc > 0.75:
        video_prob = _from_odds(_odds(video_prob) * 1.18)
    elif tc > 0.60:
        video_prob = _from_odds(_odds(video_prob) * 1.12)
    if tc > 0.70 and video_label in ("REAL", "TAMPERED", "INCONCLUSIVE"):
        video_label = "TAMPERED"
    if sl >= SORA_TAMPERED_THRESH:
        if sl >= SORA_FAKE_THRESH:
            video_prob = _from_odds(_odds(video_prob) * SORA_ODDS["high"])
        elif sl >= SORA_TAMPERED_THRESH + 0.15:
            video_prob = _from_odds(_odds(video_prob) * SORA_ODDS["med"])
        else:
            video_prob = _from_odds(_odds(video_prob) * SORA_ODDS["low"])
    if sl > SORA_FAKE_THRESH:
        video_label = "FAKE"
    elif sl >= SORA_TAMPERED_THRESH and video_label in (
            "REAL", "INCONCLUSIVE", "UNCERTAIN"):
        video_label = "TAMPERED"
    elif sora["sora_flag"] and video_label in ("REAL", "INCONCLUSIVE",
                                               "UNCERTAIN"):
        video_label = "TAMPERED"

    chosen_report = predict_images(engine, frames_uint8[chosen:chosen + 1],
                                   decision, fast=False)[0]
    # chosen-frame escalation (appv3.py:6495-6505)
    if video_label == "REAL" and chosen_report["final_label"] in (
            "TAMPERED", "FAKE"):
        video_label = chosen_report["final_label"]
        video_prob = max(video_prob, chosen_report["final_prob"])

    return {
        "video_label": video_label,
        "video_prob": float(video_prob),
        "chosen_frame": int(chosen),
        "frame_probs": probs.tolist(),
        "frame_labels": preds,
        "aggregation": metrics,
        "temporal_signals": signals,
        "sora_likelihood": sl,
        "temporal_consistency_score": tc,
        "sora_flag": sora["sora_flag"],
        "chosen_frame_report": chosen_report,
    }
