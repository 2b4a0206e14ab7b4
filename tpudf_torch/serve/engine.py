"""Batched multi-expert detection engine (tpudf/serve/engine.py).

Every view of every image in a request is assembled on the card into one
batch, the SigLIP tower runs once over it (twice with a separate patch
ToMe schedule) beside one frequency-expert pass, and the per-view logits
are fused and calibrated on the card.

View inventory per image (data/pipeline.py):
  0..8     9 multicrops (center, halves, quadrants)
  9        rot90 dual view of the full image
  10..18   h-flip multicrops (TTA)
  19       rot90 of the flipped image
  20       plain full image (embedding-anomaly reference view)
  21..36   4x4 patch-grid tiles
  37..52   rot90 duals of the patch tiles
53 views in all. The frequency expert runs on the 34 views whose logits are
used (crops, flipped crops, patch tiles), at 256 px whatever the view size.

The tower follows the engine's backbone: float blocks run kernels K13, K9
and K14 in bf16 (cast once, at build); `quantize()` switches to the static
W8A8 blocks (K1, K2). `kernels=TWINS` runs the same composition through
the plain twins (a reference run on the card).

`embed_frames` / `embed_batch` give the tower's L2-normalized pooled
features without ToMe (the video path's identity drift and face crops).

A call returns its per-image outputs with ONE device→host copy: every
output is packed on the card into one (B, K) f32 array (`_pack`; risk_idx
comes back as f32) and split on the host (`_unpack`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from tpudf_torch.calib.coral import (CoralCutpoints, coral_blend,
                                     moe_fallback_blend)
from tpudf_torch.core.precision import DEFAULT_POLICY, Policy
from tpudf_torch.data.pipeline import (make_multicrops, make_patch_grid,
                                       normalize_siglip, resize,
                                       rgb_to_gray, rot90_view)
from tpudf_torch.models.freq_mlp import apply_freq_mlp
from tpudf_torch.models.fusion import apply_fusion_linear
from tpudf_torch.models.heads import apply_binary_head
from tpudf_torch.models.siglip import (SigLIPConfig, siglip_forward,
                                       tower_params)
from tpudf_torch.ops.fft_features import extract_freq_vector
from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                   quantize_siglip_static)
from tpudf_torch.ops.routes import KERNELS, KernelSet

FREQ_TEMP = 1.25        # softens freq-MLP spikes
N_CROPS = 9
PATCH_GRID = 4
FREQ_SIZE = 256         # the frequency features' fixed resolution

# static contracts: the sorted (B,)-shaped keys of each detect fn's output
FULL_SCALARS = ("embed_l2", "entropy", "freq_prob", "max_patch", "p_blend",
                "p_fake_coral", "p_fake_raw", "patch_mean", "risk_idx",
                "visual_prob", "z_freq", "z_sig")
FAST_SCALARS = ("entropy", "freq_prob", "p_blend", "p_fake_coral",
                "p_fake_raw", "risk_idx", "visual_prob", "z_freq",
                "z_scaled", "z_sig")
_PACK_KEY = "_packed"
_LAYOUT_KEY = "_layout"


def _logit(p, eps=1e-6):
    p = torch.clamp(p, eps, 1 - eps)
    return torch.log(p / (1 - p))


def _pack(out: dict, names) -> dict:
    """Every output as columns of one (B, K) f32 array on the card: the
    (B,) scalars in the order of `names` (the static contract `_unpack`
    reads), then each other output flattened, in sorted key order."""
    scalars = sorted(k for k, v in out.items() if v.ndim == 1)
    if tuple(scalars) != tuple(names):
        raise ValueError(f"scalar outputs {scalars} != contract {names}")
    rest = sorted(k for k in out if k not in scalars)
    b = out[names[0]].shape[0]
    cols = [torch.stack([out[k].float() for k in names], dim=1)]
    cols += [out[k].float().reshape(b, -1) for k in rest]
    return {_PACK_KEY: torch.cat(cols, dim=1),
            _LAYOUT_KEY: tuple((k, tuple(out[k].shape[1:])) for k in rest)}


def _unpack(packed: dict, names) -> dict:
    """The one device→host copy, then numpy views per output."""
    host = packed[_PACK_KEY].cpu().numpy()
    out = {k: host[:, i] for i, k in enumerate(names)}
    col = len(names)
    for k, shape in packed[_LAYOUT_KEY]:
        n = math.prod(shape)
        out[k] = host[:, col:col + n].reshape((-1, *shape))
        col += n
    return out


@dataclasses.dataclass
class DetectEngine:
    """Holds the parameters and runs the batched detect paths.

    backbone: the f32 tower tree (float, or static W8A8 after `quantize`);
    head, freq: the binary head and frequency MLP; fusion: the Linear(2→1)
    head or None (head-less MoE fallback). tome_r / tome_floor: ToMe merges
    between tower blocks (0 → off; floor 0 → S/4); patch_tome_r /
    patch_tome_floor: a deeper schedule for the 32 patch-grid views of the
    full analysis only (0 → follow the main schedule).

    The report's optional artifacts (serve/report.py reads them; each None
    by default): mean_real, the (D,) mean embedding of real images for the
    cosine term of the embedding anomaly; gbdt, a models.fusion
    TreeEnsemble whose probability overrides the core fusion; and
    bayes_calibration, a fuse.bayesian.BayesCalibration for
    bayesian_fuse_v2."""
    cfg: SigLIPConfig
    backbone: Any
    head: Any
    freq: Any
    fusion: Any
    cuts: CoralCutpoints
    policy: Policy = DEFAULT_POLICY
    tome_r: int = 0
    tome_floor: int = 0
    patch_tome_r: int = 0
    patch_tome_floor: int = 0
    kernels: KernelSet = KERNELS
    mean_real: Any = None
    gbdt: Any = None
    bayes_calibration: Any = None

    def __post_init__(self):
        self.tower = tower_params(self.backbone, self.policy.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.backbone["embed"]["kernel"].device

    def quantize(self, calib_uint8: np.ndarray | None = None):
        """Switch the tower to static W8A8: calibrate per-tensor activation
        scales on representative images (or, if none are given, on
        np.random.default_rng(0) noise, as the JAX engine does) and replace
        the float projection weights with int8."""
        if "act_scales" in self.backbone.get("blocks", {}):
            return self
        if calib_uint8 is None:
            s = self.cfg.image_size
            calib = np.random.default_rng(0).random((16, s, s, 3))
        else:
            calib = np.asarray(calib_uint8, np.float32) / 255.0
        norm = normalize_siglip(torch.as_tensor(calib, dtype=torch.float32,
                                                device=self.device))
        scales = calibrate_siglip_act_scales(self.backbone, self.cfg, norm,
                                             self.policy)
        self.backbone = quantize_siglip_static(self.backbone, scales,
                                               self.cfg)
        self.tower = tower_params(self.backbone, self.policy.compute_dtype)
        return self

    @torch.no_grad()
    def dispatch_batch(self, pixels_uint8, fast: bool = False) -> dict:
        """Enqueue the detect path on the card without waiting: returns
        the packed on-card output. fetch_batch() finalizes it."""
        px = to_device(pixels_uint8, self.device)
        kw = dict(cfg=self.cfg, policy=self.policy, cuts=self.cuts,
                  kernels=self.kernels, tome_r=self.tome_r,
                  tome_floor=self.tome_floor)
        if fast:
            return _detect_batch_fast(self.tower, self.head, self.freq,
                                      self.fusion, px, **kw)
        return _detect_batch(self.tower, self.head, self.freq, self.fusion,
                             px, patch_tome_r=self.patch_tome_r,
                             patch_tome_floor=self.patch_tome_floor, **kw)

    @torch.no_grad()
    def pooled_features(self, pixels_uint8, fast: bool = False) -> dict:
        """The tower's pooled features of every view of a request, as the
        detect path computes them: {"views": (B, 2, W)} in fast mode, else
        {"main": (B, 21, W), "patch": (B, 32, W)}."""
        x = torch.as_tensor(np.asarray(pixels_uint8)).to(
            self.device).float() / 255.0
        b, s = x.shape[:2]
        kw = dict(cfg=self.cfg, policy=self.policy, kernels=self.kernels)
        if fast:
            feats = _pooled(self.tower, _fast_views(x).reshape(-1, s, s, 3),
                            tome_r=self.tome_r, tome_floor=self.tome_floor,
                            **kw)
            return {"views": feats.reshape(b, 2, -1)}
        *_, main_views, patch_views = _full_views(x)
        fm, fp = _full_features(
            self.tower, main_views, patch_views, tome_r=self.tome_r,
            tome_floor=self.tome_floor, patch_tome_r=self.patch_tome_r,
            patch_tome_floor=self.patch_tome_floor, **kw)
        return {"main": fm.reshape(b, main_views.shape[1], -1),
                "patch": fp.reshape(b, patch_views.shape[1], -1)}

    @staticmethod
    def fetch_batch(dispatched, fast: bool = False) -> dict:
        """Blocking fetch + unpack of a dispatch_batch() result."""
        return _unpack(dispatched, FAST_SCALARS if fast else FULL_SCALARS)

    def predict_batch(self, pixels_uint8) -> dict:
        """Full analysis: multicrop + rot + flip TTA + patch grid.
        pixels_uint8: (B, S, S, 3) uint8 → dict of per-image numpy outputs
        (+ per-patch probabilities for the localization heatmap)."""
        return self.fetch_batch(self.dispatch_batch(pixels_uint8))

    def predict_batch_fast(self, pixels_uint8) -> dict:
        """Fast mode (video frames): the full view + its rot dual only."""
        return self.fetch_batch(self.dispatch_batch(pixels_uint8, fast=True),
                                fast=True)

    @torch.no_grad()
    def embed_frames(self, x01):
        """L2-normalized pooled tower features (N, W) f32 of (N, h, w, 3)
        [0,1] frames on the engine's device, resized to the tower's input
        inside: one tower forward without ToMe (JAX's siglip_forward with
        no schedule, on engine B too), nothing fetched."""
        s = self.cfg.image_size
        if x01.shape[1] != s or x01.shape[2] != s:
            x01 = resize(x01, (x01.shape[0], s, s, 3), "bilinear")
        feats = _pooled(self.tower, x01, self.cfg, self.policy,
                        self.kernels).float()
        return _unit_rows(feats)

    def embed_batch(self, pixels_uint8, pad: bool = True) -> np.ndarray:
        """`embed_frames` of (B, h, w, 3) uint8 frames as numpy (B, W): the
        batch padded to a power-of-2 bucket (pad_to_bucket), one tower
        forward, one copy back. Used by the video path's face signals
        (appv3.py:3650-3755)."""
        px = np.asarray(pixels_uint8)
        b = px.shape[0]
        if pad:
            px = pad_to_bucket(px)
        x = to_device(px, self.device).float() / 255.0
        return self.embed_frames(x).cpu().numpy()[:b]


def to_device(pixels, device: torch.device):
    """Pixels (a numpy array or a tensor) on `device`. A host array goes to
    the card from pinned memory without waiting for the card's queue."""
    x = pixels if torch.is_tensor(pixels) else torch.as_tensor(
        np.ascontiguousarray(pixels))
    if x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _unit_rows(feats):
    """Rows divided by their L2 norm + 1e-6."""
    return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
                    + 1e-6)


def pad_to_bucket(pixels_uint8: np.ndarray, max_batch: int | None = None
                  ) -> np.ndarray:
    """Pad the batch dim up to the next power of two (capped at max_batch)
    by repeating the last image."""
    b = pixels_uint8.shape[0]
    bucket = 1 << max(0, (b - 1).bit_length())
    if max_batch is not None:
        bucket = min(bucket, max(max_batch, b))
    if bucket == b:
        return pixels_uint8
    pad = np.repeat(pixels_uint8[-1:], bucket - b, axis=0)
    return np.concatenate([pixels_uint8, pad], axis=0)


def _freq_gray(views_flat):
    """Grayscale at the frequency features' fixed 256 px resolution."""
    gray = rgb_to_gray(views_flat)
    n, s, _ = gray.shape
    if s != FREQ_SIZE:
        gray = resize(gray, (n, FREQ_SIZE, FREQ_SIZE), "bilinear")
    return gray


def _pooled(tower, views_flat, cfg, policy, kernels, tome_r=0, tome_floor=0):
    """The tower's pooled features of (N, S, S, 3) [0,1] views."""
    return siglip_forward(tower, normalize_siglip(views_flat), cfg, policy,
                          tome_r=tome_r, tome_floor=tome_floor,
                          kernels=kernels)["pooled"]


def _experts(tower, head, freq, views_flat, cfg, policy, kernels, tome_r=0,
             tome_floor=0):
    """One forward of both experts over (N, S, S, 3) [0,1] views."""
    feats = _pooled(tower, views_flat, cfg, policy, kernels, tome_r,
                    tome_floor)
    z_sig = apply_binary_head(head, feats)
    fv = extract_freq_vector(_freq_gray(views_flat), kernels)
    return z_sig, apply_freq_mlp(freq, fv)


def _fast_views(x):
    """(B, 2, S, S, 3): the full view and its rot90 dual."""
    return torch.stack([x, rot90_view(x)], dim=1)


def _full_views(x):
    """The full analysis' views of (B, S, S, 3) [0,1] images: the
    multicrops, their weights, the flipped multicrops, the patch tiles,
    and the (B, 21, ...) main and (B, 32, ...) patch views in the order of
    the module docstring's inventory."""
    crops, weights = make_multicrops(x)                 # (B, 9, S, S, 3)
    flip = torch.flip(x, dims=(2,))
    crops_f, _ = make_multicrops(flip)
    patches = make_patch_grid(x, PATCH_GRID)            # (B, 16, S, S, 3)
    main_views = torch.cat([
        crops,                                  # 0..8
        rot90_view(x)[:, None],                 # 9
        crops_f,                                # 10..18
        rot90_view(flip)[:, None],              # 19
        x[:, None],                             # 20 full image (embed view)
    ], dim=1)
    patch_views = torch.cat([
        patches,                                # 0..15
        torch.rot90(patches, 1, dims=(2, 3)),   # 16..31 patch rot duals
    ], dim=1)
    return crops, weights, crops_f, patches, main_views, patch_views


def _full_features(tower, main_views, patch_views, *, cfg, policy, kernels,
                   tome_r, tome_floor, patch_tome_r, patch_tome_floor):
    """Pooled features (B*21, W) and (B*32, W) of the main and patch views:
    one tower forward over all 53, or two when the patch views have a
    ToMe schedule of their own."""
    b, nm, s = main_views.shape[:3]
    np_ = patch_views.shape[1]

    def fwd(v, r, fl):
        return _pooled(tower, v.reshape(-1, s, s, 3), cfg, policy, kernels,
                       r, fl)

    if patch_tome_r or patch_tome_floor:
        return (fwd(main_views, tome_r, tome_floor),
                fwd(patch_views, patch_tome_r or tome_r,
                    patch_tome_floor or tome_floor))
    fr = fwd(torch.cat([main_views, patch_views], dim=1), tome_r,
             tome_floor).reshape(b, nm + np_, -1)
    return (fr[:, :nm].reshape(b * nm, -1), fr[:, nm:].reshape(b * np_, -1))


def _fuse(p_sig, p_freq, fusion, cuts):
    """Fusion head, or the MoE fallback without one; then CORAL."""
    if fusion is None:
        # the head-less fallback has no CORAL input of its own: feed it
        # the mean expert probability's logit (only its capped 25 % term)
        out = coral_blend(_logit(0.5 * (p_sig + p_freq)), cuts)
        out["p_blend"] = moe_fallback_blend(p_sig, p_freq,
                                            out["p_fake_coral"])
        return out
    return coral_blend(apply_fusion_linear(fusion, p_sig, p_freq), cuts)


def _core_from_views(z_sig_v, z_freq_v, z_rot, weights, fusion, cuts):
    """The detect-core fusion, batched over images.
    z_sig_v, z_freq_v: (B, 9); z_rot: (B,)."""
    z_sig = torch.sum(z_sig_v * weights, dim=1)
    z_freq = torch.sum(z_freq_v * weights, dim=1)
    visual_prob = 0.6 * torch.sigmoid(z_sig) + 0.4 * torch.sigmoid(z_rot)
    p_freq = torch.sigmoid(z_freq / FREQ_TEMP)
    out = _fuse(visual_prob, p_freq, fusion, cuts)
    out.update({"z_sig": _logit(visual_prob), "z_freq": z_freq,
                "visual_prob": visual_prob, "freq_prob": p_freq})
    return out


@torch.no_grad()
def _detect_batch(tower, head, freq, fusion, pixels, *, cfg, policy, cuts,
                  kernels=KERNELS, tome_r=0, tome_floor=0, patch_tome_r=0,
                  patch_tome_floor=0):
    """53-view full analysis of (B, S, S, 3) uint8 pixels on the card.
    patch_tome_r / patch_tome_floor: a deeper ToMe schedule for the 32
    patch-grid views (4x-upscaled tiles), run as a second tower forward."""
    b, s = pixels.shape[:2]
    x = pixels.float() / 255.0

    crops, weights, crops_f, patches, main_views, patch_views = \
        _full_views(x)
    nm, np_ = main_views.shape[1], patch_views.shape[1]
    feats_main, feats_patch = _full_features(
        tower, main_views, patch_views, cfg=cfg, policy=policy,
        kernels=kernels, tome_r=tome_r, tome_floor=tome_floor,
        patch_tome_r=patch_tome_r, patch_tome_floor=patch_tome_floor)
    z_main = apply_binary_head(head, feats_main).reshape(b, nm)
    z_patchv = apply_binary_head(head, feats_patch).reshape(b, np_)

    # embedding-anomaly view: the full image's pooled features, normalized
    embed_feat = feats_main.reshape(b, nm, -1)[:, 20].float()
    embed_feat = _unit_rows(embed_feat)
    embed_l2 = torch.linalg.vector_norm(embed_feat, dim=-1)

    # frequency expert only on the views whose logits are used
    fviews = torch.cat([crops, crops_f, patches], dim=1).reshape(
        b * 34, s, s, 3)
    fv = extract_freq_vector(_freq_gray(fviews), kernels)
    z_freq_used = apply_freq_mlp(freq, fv).reshape(b, 34)
    zf_main, zf_tta, zf_patch = (z_freq_used[:, 0:9], z_freq_used[:, 9:18],
                                 z_freq_used[:, 18:34])

    main = _core_from_views(z_main[:, 0:9], zf_main, z_main[:, 9],
                            weights, fusion, cuts)
    tta = _core_from_views(z_main[:, 10:19], zf_tta, z_main[:, 19],
                           weights, fusion, cuts)

    # patch grid: single-view detect core per tile with its rot dual
    zp, zp_rot = z_patchv[:, 0:16], z_patchv[:, 16:32]
    vp = 0.6 * torch.sigmoid(zp) + 0.4 * torch.sigmoid(zp_rot)
    fp = torch.sigmoid(zf_patch / FREQ_TEMP)
    patch_probs = _fuse(vp, fp, fusion, cuts)["p_blend"]   # (B, 16)

    return _pack({
        "p_blend": 0.5 * (main["p_blend"] + tta["p_blend"]),
        "p_fake_raw": 0.5 * (main["p_fake_raw"] + tta["p_fake_raw"]),
        "p_fake_coral": 0.5 * (main["p_fake_coral"] + tta["p_fake_coral"]),
        "risk_probs": main["risk_probs"],
        "risk_idx": main["risk_idx"],
        "entropy": main["entropy"],
        "visual_prob": main["visual_prob"],
        "freq_prob": main["freq_prob"],
        "z_sig": main["z_sig"],
        "z_freq": main["z_freq"],
        "patch_probs": patch_probs,
        "max_patch": torch.amax(patch_probs, dim=1),
        "patch_mean": torch.mean(patch_probs, dim=1),
        "embed_l2": embed_l2,
        "embed_feat": embed_feat,
    }, FULL_SCALARS)


@torch.no_grad()
def _detect_batch_fast(tower, head, freq, fusion, pixels, *, cfg, policy,
                       cuts, kernels=KERNELS, tome_r=0, tome_floor=0):
    """Fast mode: the full view + its rot dual view only."""
    b, s = pixels.shape[:2]
    x = pixels.float() / 255.0
    views = _fast_views(x)
    z_sig, z_freq = _experts(tower, head, freq, views.reshape(b * 2, s, s, 3),
                             cfg, policy, kernels, tome_r, tome_floor)
    z_sig = z_sig.reshape(b, 2)
    z_freq = z_freq.reshape(b, 2)
    vprob = (0.6 * torch.sigmoid(z_sig[:, 0])
             + 0.4 * torch.sigmoid(z_sig[:, 1]))
    p_freq = torch.sigmoid(z_freq[:, 0] / FREQ_TEMP)
    out = _fuse(vprob, p_freq, fusion, cuts)
    out.update({"visual_prob": vprob, "freq_prob": p_freq,
                "z_sig": _logit(vprob), "z_freq": z_freq[:, 0]})
    return _pack(out, FAST_SCALARS)
