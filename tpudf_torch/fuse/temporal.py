"""Temporal (anti-Sora) signal battery over sampled video frames, and the
image path's rendering score (tpudf/fuse/temporal.py), on tensors.

The device battery (`compute_temporal_signals`) is batched PyTorch over a
(T, H, W, 3) frame stack on its device, every signal a 0-d tensor, no
host round trip (appv3.py:3522-4304):
  * SigLIP embedding identity drift            (appv3.py:3522-3551)
  * PRNU cross-frame incoherence (+flat)       (:1810-1895; ops/forensics.py)
  * JPEG block-grid drift                      (:1928-1963)
  * background border-histogram inconsistency  (:3798-3834)
  * texture flicker (Laplacian-variance CV)    (:3836-3860)
  * edge flicker (gradient-density CV; Canny → Sobel-threshold proxy)
                                               (:3901-3926)
  * color drift (RGB-mean steps; Lab proxy)    (:3928-3952)
  * noise residual incoherence in flat regions (:3954-4009)
  * spectral radial-profile Bhattacharyya drift (:4011-4053)
  * the dense-LK flow family (ops/flow.py `flow_signals`)
Callers on the card run it inside `forensics.f32_math()`.

`host_flow_signals` is the reference's host cv2 flow battery, numpy and
cv2 only: an optional cross-check, not a second device battery.

Aggregation mirrors appv3.py:6326-6402: sora_likelihood +
temporal_consistency_score weighted votes and the core/motion-hits flag.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudf_torch.data.pipeline import resize
from tpudf_torch.ops.fft_features import fft2_mag
from tpudf_torch.ops.flow import (exposure_blur_regularity,
                                  exposure_blur_regularity_batched,
                                  flow_signals)
from tpudf_torch.ops.forensics import (_block_stats, _gray, _std, _var,
                                       gaussian_blur, laplacian,
                                       prnu_temporal_incoherence, sobel_mag)


def _step_corr(maps):
    """Mean Pearson correlation between consecutive (T, …) maps."""
    t = maps.shape[0]
    a = maps[:-1].reshape(t - 1, -1)
    b = maps[1:].reshape(t - 1, -1)
    am = a - a.mean(1, keepdim=True)
    bm = b - b.mean(1, keepdim=True)
    corr = torch.sum(am * bm, 1) / (
        torch.linalg.vector_norm(am, dim=1)
        * torch.linalg.vector_norm(bm, dim=1) + 1e-6)
    return torch.mean(corr)


def identity_drift_from_embeddings(embeds):
    """(T, D) L2-normalized SigLIP embeddings → drift score
    (appv3.py:3522-3551)."""
    sims = torch.sum(embeds[:-1] * embeds[1:], dim=-1)
    drift = 1.0 - torch.mean(sims)
    return torch.clamp((drift - 0.08) / 0.35, 0.0, 1.0)


def jpeg_block_drift(gray):
    """(T, 256, 256) grayscale [0,1] → block-variance-map decorrelation
    (appv3.py:1928-1963)."""
    var_map = _block_stats(gray * 255.0, 8, "var")
    mu = torch.mean(var_map, dim=(1, 2), keepdim=True)
    sd = _std(var_map, (1, 2), keepdim=True)
    maps = (var_map - mu) / (sd + 1e-6)
    return torch.clamp((0.40 - _step_corr(maps)) / 0.40, 0.0, 1.0)


@functools.lru_cache(maxsize=8)
def _border_mask(h: int, w: int, device):
    """(H*W,) f32: 1 on the border band of 12 % of the short side."""
    b = int(min(h, w) * 0.12)
    m = np.zeros((h, w), np.float32)
    m[:b, :] = 1
    m[-b:, :] = 1
    m[:, :b] = 1
    m[:, -b:] = 1
    return torch.from_numpy(m.ravel()).to(device)


def background_inconsistency(gray):
    """Border-region 32-bin histogram Bhattacharyya drift
    (appv3.py:3798-3834)."""
    t, h, w = gray.shape
    m = _border_mask(h, w, gray.device)
    g = torch.clamp(gray * 255.0, 0, 255).reshape(t, -1)
    idx = (g / 8.0).to(torch.int64)
    # a border pixel adds 1 to its bin, an inner one 0 (JAX's masked sums);
    # g = 255 bins to 31
    hist = torch.zeros((t, 32), device=gray.device).scatter_add_(
        1, idx, m.expand(t, -1).contiguous())
    # cv2.normalize default = L2 normalization before compareHist
    hist = hist / (torch.linalg.vector_norm(hist, dim=1, keepdim=True) + 1e-6)
    p, q = hist[:-1], hist[1:]
    pn = p / (torch.sum(p, 1, keepdim=True) + 1e-6)
    qn = q / (torch.sum(q, 1, keepdim=True) + 1e-6)
    bc = torch.sum(torch.sqrt(pn * qn + 1e-12), dim=1)
    diffs = torch.sqrt(torch.clamp(1.0 - bc, 0.0, 1.0))
    return torch.clamp(torch.mean(diffs) / 0.35, 0.0, 1.0)


def texture_flicker(gray):
    """Laplacian-variance coefficient of variation (appv3.py:3836-3860)."""
    vals = _var(laplacian(gray * 255.0), (1, 2))
    cv = _std(vals, 0) / (torch.mean(vals) + 1e-6)
    return torch.clamp((cv - 0.15) / 0.60, 0.0, 1.0)


def edge_flicker(gray, thresh=0.35):
    """Edge-density CV; Canny replaced by a Sobel-magnitude threshold
    (appv3.py:3901-3926)."""
    mag = sobel_mag(gray * 255.0)
    dens = torch.mean((mag > thresh * 255.0).float(), dim=(1, 2))
    cv = _std(dens, 0) / (torch.mean(dens) + 1e-6)
    return torch.clamp((cv - 0.15) / 0.50, 0.0, 1.0)


def color_drift(frames):
    """(T, H, W, 3) [0,1] mean-color step distance (appv3.py:3928-3952;
    RGB-mean proxy for Lab, 0-255 scale)."""
    means = torch.mean(frames * 255.0, dim=(1, 2))
    diffs = torch.linalg.vector_norm(means[1:] - means[:-1], dim=1)
    return torch.clamp((torch.mean(diffs) - 4.0) / 16.0, 0.0, 1.0)


def noise_incoherence(gray):
    """Flat-region noise-residual decorrelation (appv3.py:3954-4009)."""
    g255 = gray * 255.0
    resid = g255 - gaussian_blur(g255, 1.5)
    flat = (sobel_mag(g255) < 10.0).float()
    # joint flat mask per consecutive pair; weighted correlation
    t = gray.shape[0]
    a = resid[:-1].reshape(t - 1, -1)
    b = resid[1:].reshape(t - 1, -1)
    m = (flat[:-1] * flat[1:]).reshape(t - 1, -1)
    msum = torch.sum(m, dim=1) + 1e-6
    am = a - torch.sum(a * m, 1, keepdim=True) / msum[:, None]
    bm = b - torch.sum(b * m, 1, keepdim=True) / msum[:, None]
    num = torch.sum(am * bm * m, dim=1)
    den = torch.sqrt(torch.sum(am * am * m, 1)
                     * torch.sum(bm * bm * m, 1)) + 1e-6
    return torch.clamp((0.15 - torch.mean(num / den)) / 0.15, 0.0, 1.0)


@functools.lru_cache(maxsize=4)
def _radial_hist_matrix(h, w, bins=20):
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    rn = r / (r.max() + 1e-6)
    m = np.zeros((h * w, bins), np.float32)
    idx = np.clip((rn * bins).astype(int), 0, bins - 1)
    m[np.arange(h * w), idx.ravel()] = 1.0
    return m, np.maximum(m.sum(0), 1.0)


@functools.lru_cache(maxsize=4)
def _radial_on(h: int, w: int, device):
    m, counts = _radial_hist_matrix(h, w)
    return (torch.from_numpy(m).to(device),
            torch.from_numpy(counts.astype(np.float32)).to(device))


def spectral_drift(gray):
    """Radial log-FFT profile Bhattacharyya drift (appv3.py:4011-4053).
    gray: (T, H, W) — resized to 128 internally like the reference."""
    t = gray.shape[0]
    g = resize(gray, (t, 128, 128), "bilinear") * 255.0
    mag = torch.log1p(fft2_mag(g, shifted=True))
    m, counts = _radial_on(128, 128, gray.device)
    prof = (mag.reshape(t, -1) @ m) / counts
    prof = prof / (torch.sum(prof, 1, keepdim=True) + 1e-6)
    bc = torch.sum(torch.sqrt(prof[:-1] * prof[1:] + 1e-12), dim=1)
    return torch.clamp(torch.mean(1.0 - bc) / 0.25, 0.0, 1.0)


def compute_temporal_signals(frames, embeds=None, include_flow=True):
    """frames: (T, H, W, 3) [0,1] → dict of 0-d signals on frames' device.

    include_flow adds the dense-LK flow family (ops/flow.py) when T >= 3
    and H, W are pyramid-friendly. A NaN value marks a signal the reference
    would gate out (parallax on a static scene): callers drop NaNs like
    missing signals (aggregate_sora does)."""
    gray = _gray(frames)
    sig = {
        "prnu_drift": prnu_temporal_incoherence(gray),
        "prnu_flat_drift": prnu_temporal_incoherence(
            gray - gaussian_blur(gray, 1.0)),   # denoised variant proxy
        "jpeg_block_drift": jpeg_block_drift(gray),
        "background_inconsistency": background_inconsistency(gray),
        "texture_flicker": texture_flicker(gray),
        "edge_flicker": edge_flicker(gray),
        "color_drift": color_drift(frames),
        "noise_incoherence": noise_incoherence(gray),
        "spectral_drift": spectral_drift(gray),
    }
    t, h, wd = gray.shape
    if include_flow and t >= 3 and h % 16 == 0 and wd % 16 == 0:
        sig.update(flow_signals(gray))
    if embeds is not None:
        sig["id_drift"] = identity_drift_from_embeddings(embeds)
    return sig


SORA_WEIGHTS = [
    ("id_drift", 0.18), ("prnu_drift", 0.14), ("prnu_flat_drift", 0.10),
    ("parallax_err", 0.09), ("face_topology_drift", 0.07),
    ("face_embedding_drift", 0.07), ("face_track_drift", 0.08),
    ("object_inconsistency", 0.08), ("background_inconsistency", 0.06),
    ("texture_flicker", 0.04), ("flow_fb_inconsistency", 0.05),
    ("flow_dir_incoherence", 0.03), ("klt_instability", 0.04),
    ("affine_inconsistency", 0.02), ("jpeg_block_drift", 0.06),
]

CONSISTENCY_WEIGHTS = [
    ("flow_reprojection", 0.12), ("flow_fb_inconsistency", 0.10),
    ("flow_dir_incoherence", 0.08), ("parallax_err", 0.10),
    ("object_inconsistency", 0.09), ("background_inconsistency", 0.07),
    ("edge_flicker", 0.07), ("texture_flicker", 0.07),
    ("color_drift", 0.05), ("noise_incoherence", 0.04),
    ("spectral_drift", 0.04), ("klt_instability", 0.08),
    ("affine_inconsistency", 0.06), ("prnu_flat_drift", 0.06),
    ("jpeg_block_drift", 0.07),
]


def aggregate_sora(signals: dict):
    """Weighted sora_likelihood + temporal_consistency_score + flag
    (appv3.py:6326-6402), on host floats. Missing signals are skipped with
    weight renormalization, as in the reference."""
    def vote(weights):
        num = den = 0.0
        for k, w in weights:
            v = signals.get(k)
            if v is None or float(v) != float(v):    # None/NaN = missing
                continue
            num += w * float(v)
            den += w
        return num / den if den > 0 else 0.0

    sora = vote(SORA_WEIGHTS)
    consistency = vote(CONSISTENCY_WEIGHTS)

    def g(k):
        v = signals.get(k)
        if v is None or float(v) != float(v):
            return 0.0
        return float(v)

    core_hits = sum([g("id_drift") > 0.55, g("prnu_drift") > 0.50,
                     g("prnu_flat_drift") > 0.50,
                     g("face_topology_drift") > 0.50,
                     g("face_embedding_drift") > 0.50,
                     g("face_track_drift") > 0.50])
    motion_hits = sum([g("parallax_err") > 0.50,
                       g("object_inconsistency") > 0.60,
                       g("background_inconsistency") > 0.60,
                       g("texture_flicker") > 0.60,
                       g("flow_fb_inconsistency") > 0.55,
                       g("flow_dir_incoherence") > 0.55,
                       g("klt_instability") > 0.55,
                       g("affine_inconsistency") > 0.55])
    flag = bool((sora > 0.60 and core_hits >= 2)
                or (sora > 0.75 and core_hits >= 1 and motion_hits >= 1))
    return {"sora_likelihood": sora,
            "temporal_consistency_score": consistency,
            "sora_flag": flag,
            "core_hits": core_hits, "motion_hits": motion_hits}


def _render_gray(pixels_uint8):
    """(N, H, W, 3) uint8 → (N, H, W) grey in [0, 1], resized to 256 px
    where the flow pyramid needs it (H or W not a multiple of 16, or
    under 32)."""
    gray = _gray(pixels_uint8.float() / 255.0)
    n, h, wd = gray.shape
    if h % 16 or wd % 16 or h < 32 or wd < 32:
        gray = resize(gray, (n, 256, 256), "bilinear")
    return gray


def rendering_pipeline_score(frames_uint8) -> float:
    """Over-regular camera-simulation score of a clip (appv3.py:2525-2566
    re-derived): exposure continuity (64-bin grey histogram Bhattacharyya
    between consecutive frames) blended 55/45 with motion-blur regularity
    (exp(-var) of dense-LK flow magnitude at edge pixels,
    ops/flow.exposure_blur_regularity). Higher = suspiciously 'too
    perfect'. frames_uint8: (T, H, W, 3) uint8 frames, a tensor (scored
    on its device) or a sequence of numpy arrays or tensors. 0.0 for fewer
    than 2 frames."""
    if frames_uint8 is None or len(frames_uint8) < 2:
        return 0.0
    frames = (frames_uint8 if torch.is_tensor(frames_uint8) else
              torch.stack([f if torch.is_tensor(f)
                           else torch.from_numpy(np.asarray(f))
                           for f in frames_uint8]))
    exposure, blur = exposure_blur_regularity(_render_gray(frames))
    score = 0.55 * float(exposure) + 0.45 * float(blur)
    return float(np.clip(score, 0.0, 1.0))


def render_scores_graph(pixels_uint8):
    """Batched image-path rendering score: each image and its horizontal
    flip as a two-frame clip (appv3.py:5128-5195), exposure continuity
    blended 55/45 with motion-blur regularity, batched over the images as
    JAX's vmap is. (B, H, W, 3) uint8 → (B,) in [0, 1], on the pixels'
    device."""
    gray = _render_gray(pixels_uint8)                     # (B, H, W)
    pair = torch.stack([gray, torch.flip(gray, dims=(2,))], dim=1)
    exposure, blur = exposure_blur_regularity_batched(pair)
    return torch.clamp(0.55 * exposure + 0.45 * blur, 0.0, 1.0)


def host_flow_signals(frames_uint8):
    """Optical-flow-family signals via host cv2 (Farneback forward/backward,
    flow direction coherence, KLT track instability, RANSAC affine
    inconsistency — appv3.py:3862-4304; ORB object persistence :3758).
    numpy + cv2 only. Returns {} if cv2 is unavailable or T < 3."""
    try:
        import cv2
    except ImportError:
        return {}
    t = len(frames_uint8)
    if t < 3:
        return {}
    grays = [cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2GRAY)
             for f in frames_uint8]
    fb_err, dir_inc, klt, affine = [], [], [], []
    reproj, par = [], []
    hgt, wid = grays[0].shape
    gy, gx = np.mgrid[0:hgt, 0:wid].astype(np.float32)
    # one forward Farneback solve per pair feeds the fb / direction,
    # reprojection and parallax families
    for i in range(t - 1):
        a, b = grays[i], grays[i + 1]
        fwd = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5,
                                           1.2, 0)
        bwd = cv2.calcOpticalFlowFarneback(b, a, None, 0.5, 3, 15, 3, 5,
                                           1.2, 0)
        err = np.linalg.norm(fwd + bwd, axis=-1)
        fb_err.append(float(np.mean(err)))
        ang = np.arctan2(fwd[..., 1], fwd[..., 0])
        mag = np.linalg.norm(fwd, axis=-1)
        sel = mag > 0.5
        if sel.mean() > 0.01:
            dir_inc.append(float(np.std(np.sin(ang[sel])) +
                                 np.std(np.cos(ang[sel]))) / 2.0)

        # reprojection: content at x in `b` came from x - flow(x) in `a`
        warped = cv2.remap(a, gx - fwd[..., 0], gy - fwd[..., 1],
                           cv2.INTER_LINEAR)
        reproj.append(float(np.mean(np.abs(
            warped.astype(np.float32) - b.astype(np.float32)))))

        # parallax: flow-magnitude roughness across depth layers
        if mag.mean() > 0.2:
            local_std = cv2.blur((mag - cv2.blur(mag, (15, 15))) ** 2,
                                 (15, 15)) ** 0.5
            par.append(float(np.mean(local_std) / (mag.mean() + 1e-6)))

        pts = cv2.goodFeaturesToTrack(a, 200, 0.01, 8)
        if pts is not None and len(pts) >= 8:
            nxt, st, _ = cv2.calcOpticalFlowPyrLK(a, b, pts, None)
            good = st.ravel() == 1
            if good.sum() >= 8:
                klt.append(1.0 - float(good.mean()))
                _, inl = cv2.estimateAffinePartial2D(pts[good], nxt[good],
                                                     method=cv2.RANSAC)
                if inl is not None:
                    affine.append(1.0 - float(inl.mean()))
    out = {}
    if fb_err:
        out["flow_fb_inconsistency"] = float(np.clip(np.mean(fb_err) / 4.0,
                                                     0, 1))
    if dir_inc:
        out["flow_dir_incoherence"] = float(np.clip(np.mean(dir_inc), 0, 1))
    if klt:
        out["klt_instability"] = float(np.clip(np.mean(klt) / 0.5, 0, 1))
    if affine:
        out["affine_inconsistency"] = float(np.clip(np.mean(affine) / 0.6,
                                                    0, 1))
    if reproj:
        out["flow_reprojection"] = float(np.clip(np.mean(reproj) / 20.0,
                                                 0, 1))
    if par:
        out["parallax_err"] = float(np.clip(np.mean(par) / 1.5, 0, 1))

    # ORB object persistence: descriptor match survival across frames
    orb = cv2.ORB_create(200)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    surv = []
    prev = orb.detectAndCompute(grays[0], None)
    for i in range(1, t):
        cur = orb.detectAndCompute(grays[i], None)
        if prev[1] is not None and cur[1] is not None \
                and len(prev[1]) >= 8 and len(cur[1]) >= 8:
            matches = bf.match(prev[1], cur[1])
            surv.append(len(matches) / max(len(prev[1]), 1))
        prev = cur
    if surv:
        out["object_inconsistency"] = float(
            np.clip(1.0 - np.mean(surv), 0, 1))
    return out
