"""Block-wise forensic anomaly maps (localization heatmaps), as
tpudf/ops/forensic_maps.py computes them: PRNU strength / FFT-consistency
maps, CFA anomaly, JPEG recompression residual, patch variance,
multiscale FFT, perlin noise field, and the combined locator
(ultra_forensics.py:25-205; appv3.py:2252-2464). Every map is
(B, H/blk, W/blk), batched, eager PyTorch on the input's device; f32
convolutions, products and resizes run with TF32 off (`f32_math`).
Resampling goes through `data/pipeline.resize`, which is
`jax.image.resize` (antialiased when it shrinks).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.data.augment import jpeg_simulate
from tpudf_torch.data.pipeline import resize
from tpudf_torch.ops.fft_features import fft2_mag
from tpudf_torch.ops.forensics import (_block_stats, _gauss_kernel_np, _gray,
                                       _pad_symmetric, extract_prnu,
                                       f32_math, gaussian_blur)

_SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32)


def _f32(fn):
    """Run fn with TF32 off (looked up at call time)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_math():
            return fn(*args, **kwargs)
    return wrapped


@functools.lru_cache(maxsize=8)
def _scharr(device):
    """The Scharr x and y kernels (1, 1, 3, 3) on `device`."""
    kx = torch.from_numpy(_SCHARR_X).to(device)
    return kx[None, None], kx.T.contiguous()[None, None]


def _blocks(x, bs):
    b, h, w = x.shape
    t = x[:, :h - h % bs, :w - w % bs]
    return t.reshape(b, h // bs, bs, w // bs, bs)


def _tiles(x, bs):
    """(B, H, W) → ((B·gh·gw, bs, bs) tiles in row-major block order, gh,
    gw)."""
    t = _blocks(x, bs)
    b, gh, _, gw, _ = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(b * gh * gw, bs, bs), gh, gw


@_f32
def prnu_strength_map(gray, block=64):
    """Block mean |PRNU| (ultra_forensics.py:46-56)."""
    return torch.mean(torch.abs(_blocks(extract_prnu(gray), block)),
                      dim=(2, 4))


@_f32
def prnu_fft_consistency_map(gray, block=64):
    """Per-block radial FFT roughness of the PRNU field
    (ultra_forensics.py:59-73)."""
    tiles, gh, gw = _tiles(extract_prnu(gray), block)
    radial = torch.mean(fft2_mag(tiles), dim=1)           # (N, blk)
    rough = torch.mean(torch.abs(radial - _smooth1d(radial, 3.0)), dim=1)
    return rough.reshape(gray.shape[0], gh, gw)


def _smooth1d(x, sigma):
    """1-D gaussian smoothing along the last axis of (N, L): symmetric
    padding (the edge repeated), the radius clamped so the pad never
    exceeds the signal."""
    k_np, radius = _gauss_kernel_np(float(sigma))
    radius = min(radius, x.shape[-1] - 1)
    k = torch.from_numpy(np.ascontiguousarray(
        k_np[len(k_np) // 2 - radius:len(k_np) // 2 + radius + 1])).to(
            x.device)
    k = k / torch.sum(k)
    xp = _pad_symmetric(x, radius, 1)
    return F.conv1d(xp[:, None], k.reshape(1, 1, -1))[:, 0]


@_f32
def cfa_anomaly_map(gray, block=32):
    """Scharr-energy deviation per block (ultra_forensics.py:80-103)."""
    kx, ky = _scharr(gray.device)
    g = (gray * 255.0)[:, None]
    e = (torch.abs(F.conv2d(g, kx, padding=1))
         + torch.abs(F.conv2d(g, ky, padding=1)))[:, 0]
    m = torch.mean(_blocks(e, block), dim=(2, 4))
    return torch.abs(m - torch.mean(m, dim=(1, 2), keepdim=True))


@_f32
def jpeg_residual_map(img, block=8, quality=95):
    """Recompression-residual block map (ultra_forensics.py:106-128);
    recompression by the device JPEG simulator."""
    diff = torch.abs(img - jpeg_simulate(img, quality))
    return torch.mean(_blocks(_gray(diff), block), dim=(2, 4))


@_f32
def patch_anomaly_map(gray, block=64):
    """Block variance deviation (ultra_forensics.py:135-148)."""
    m = _block_stats(gray * 255.0, block, "var")
    return torch.abs(m - torch.mean(m, dim=(1, 2), keepdim=True))


@_f32
def multiscale_fft_map(gray, block=32):
    """Per-block mean FFT magnitude deviation (ultra_forensics.py:155-172)."""
    tiles, gh, gw = _tiles(gray * 255.0, block)
    m = torch.mean(fft2_mag(tiles), dim=(1, 2)).reshape(gray.shape[0], gh,
                                                         gw)
    return torch.abs(m - torch.mean(m, dim=(1, 2), keepdim=True))


@_f32
def perlin_noise_map(gray, block=32):
    """Residual-field variance deviation (ultra_forensics.py:179-194)."""
    g255 = gray * 255.0
    m = _block_stats(g255 - gaussian_blur(g255, 3.0), block, "var")
    return torch.abs(m - torch.mean(m, dim=(1, 2), keepdim=True))


def _norm01(m):
    lo = torch.amin(m, dim=(1, 2), keepdim=True)
    hi = torch.amax(m, dim=(1, 2), keepdim=True)
    return (m - lo) / (hi - lo + 1e-8)


@_f32
def combined_anomaly_map(maps, size=None):
    """Mean of min-max-normalized maps (ultra_forensics.py:200-208), each
    resampled (bilinear, `resize`) to the largest grid first."""
    if size is None:
        size = max(m.shape[1] for m in maps)
    acc = None
    for m in maps:
        mn = _norm01(m)
        if mn.shape[1] != size:
            mn = resize(mn, (mn.shape[0], size, size), "bilinear")
        acc = mn if acc is None else acc + mn
    return acc / len(maps)


@_f32
def forensic_map_battery(img, gray=None):
    """All maps + the combined locator for (B, H, W, 3) [0,1] input."""
    if gray is None:
        gray = _gray(img)
    maps = {
        "prnu_strength": prnu_strength_map(gray),
        "prnu_fft": prnu_fft_consistency_map(gray),
        "cfa_anomaly": cfa_anomaly_map(gray),
        "jpeg_residual": jpeg_residual_map(img),
        "patch_variance": patch_anomaly_map(gray),
        "multiscale_fft": multiscale_fft_map(gray),
        "perlin": perlin_noise_map(gray),
    }
    maps["combined"] = combined_anomaly_map(
        [maps["prnu_strength"], maps["cfa_anomaly"], maps["patch_variance"],
         maps["multiscale_fft"], maps["perlin"]])
    return maps


def jet_colors(m):
    """A minimal jet colormap (blue → cyan → yellow → red) of an (h, w)
    numpy map in [0, 1] → uint8 (h, w, 3), truncated as the reference's
    `* 255).astype(np.uint8)`."""
    r = np.clip(1.5 - np.abs(4 * m - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * m - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * m - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


@_f32
def heatmap_overlay(image_rgb_uint8, anomaly_map, alpha=0.45):
    """Jet-colormap overlay (appv3.py:3425-3454 / ultra_forensics
    save_heatmap equivalent) → uint8 RGB. The map (a tensor on its device,
    or a numpy array) is normalized and resized to the image there; the
    colormap and the blend run on the host in numpy."""
    m = torch.as_tensor(anomaly_map).float()
    m = (m - m.min()) / (m.max() - m.min() + 1e-8)
    h, w = image_rgb_uint8.shape[:2]
    m = resize(m[None], (1, h, w), "bilinear")[0].cpu().numpy()
    out = (image_rgb_uint8.astype(np.float32) * (1 - alpha)
           + jet_colors(m).astype(np.float32) * alpha)
    return np.clip(out, 0, 255).astype(np.uint8)
