"""The 24-d FFT + SRM + Haar frequency vector (tpudf/ops/fft_features.py).

The spectrum comes from torch.fft.fft2 + fftshift, the path the JAX package
takes off the TPU; band, sector and log-radius sums are products with the
same static numpy masks. Feature order:
  [0:3]   E_low, E_mid, E_high over E_total
  [3]     (E_high+eps)/(E_low+eps)
  [4]     log-radial spectrum slope (39 log bins, least-squares line)
  [5]     8-sector anisotropy (variance of sector means)
  [6]     phase entropy (50-bin histogram over [-pi, pi])
  [7:15]  Haar energies [cA1,cH1,cV1,cD1,cA2,cH2,cV2,cD2]
  [15:24] SRM mean/var/kurtosis x 3 kernels
followed by per-vector standardisation (ddof=1, flat vectors zeroed).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpudf_torch.ops.dwt import haar_energies_2level
from tpudf_torch.ops.routes import KERNELS
from tpudf_torch.ops.srm import srm_features

_EPS = 1e-6


@functools.lru_cache(maxsize=4)
def _static_masks(h: int, w: int):
    """Precompute the mask matrix (H*W, 3+8) for band/sector sums, the
    (H*W, 39) log-bin matrix, bin counts, and polyfit weights — numpy
    constants, copied verbatim from tpudf/ops/fft_features.py."""
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    rmax = r.max()

    r1, r2 = 0.15 * rmax, 0.45 * rmax
    band = np.stack([r <= r1, (r > r1) & (r <= r2), r > r2], -1)  # (H,W,3)

    ang = np.arctan2(yy - cy, xx - cx)
    sectors = []
    for a0 in np.linspace(-math.pi, math.pi, 8, endpoint=False):
        sectors.append((ang >= a0) & (ang < a0 + math.pi / 4))
    sect = np.stack(sectors, -1)                                   # (H,W,8)

    # log-radius bins: torch.logspace(log10 1, log10 rmax+1, 40) boundaries,
    # torch.bucketize(r+1, rb) - 1  (appv3.py:1656-1657)
    rb = np.logspace(np.log10(1.0), np.log10(rmax + 1.0), 40)
    ridx = np.searchsorted(rb, (r + 1.0).ravel(), side="left") - 1
    nbins = 39
    binm = np.zeros((h * w, nbins), np.float32)
    valid = (ridx >= 0) & (ridx < nbins)
    binm[np.arange(h * w)[valid], ridx[valid]] = 1.0
    bin_counts = binm.sum(0)                                       # (39,)

    mask = np.concatenate([band.reshape(-1, 3), sect.reshape(-1, 8)],
                          axis=1).astype(np.float32)               # (HW, 11)
    sect_counts = sect.reshape(-1, 8).sum(0).astype(np.float32)

    # least-squares slope weights over xs = arange(39)
    xs = np.arange(nbins, dtype=np.float64)
    xc = xs - xs.mean()
    slope_w = (xc / (xc ** 2).sum()).astype(np.float32)            # (39,)

    return (mask, binm.astype(np.float32),
            bin_counts.astype(np.float32), sect_counts,
            slope_w)


@functools.lru_cache(maxsize=4)
def _device_constants(h: int, w: int, device: torch.device):
    """The static masks as tensors on `device`, plus the 49 phase-histogram
    boundaries (f32, as the JAX graph compares against them)."""
    nb = 50
    bounds = ((np.arange(1, nb, dtype=np.float64) / nb) * (2 * math.pi)
              - math.pi).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*_static_masks(h, w), bounds))


def fft2_mag(x, *, shifted=False):
    """|fft2(x)| (optionally fftshifted) for (B, H, W) real input, by
    torch.fft.fft2 on x's device (the JAX package's path off the TPU; its
    matmul DFT is a TPU detail). Shared by the forensic battery."""
    f = torch.fft.fft2(x.float())
    if shifted:
        f = torch.fft.fftshift(f, dim=(-2, -1))
    return torch.abs(f)


def fft_features(gray):
    """gray: (B, H, W) float32 in [0,1] → (B, 15)."""
    b, h, w = gray.shape
    mask, binm, bin_counts, sect_counts, slope_w, bounds = _device_constants(
        h, w, gray.device)

    f = torch.fft.fftshift(torch.fft.fft2(gray.float()), dim=(-2, -1))
    mag = torch.abs(f).reshape(b, h * w)
    magsq = mag * mag
    phase = torch.angle(f).reshape(b, h * w)

    sums = mag @ mask                              # 3 bands + 8 sectors
    el, em, eh = sums[:, 0], sums[:, 1], sums[:, 2]
    et = el + em + eh + _EPS                       # the bands partition
    sect_means = sums[:, 3:] / torch.clamp(sect_counts, min=1.0)
    anis = torch.var(sect_means, dim=1, unbiased=False)

    # log(mag+eps) == 0.5*log(magsq + 2*eps*mag + eps^2)
    logmag = 0.5 * torch.log(magsq + (2 * _EPS) * mag + _EPS * _EPS)
    bin_sums = logmag @ binm                                     # (B, 39)
    mu = torch.where(bin_counts > 0,
                     bin_sums / torch.clamp(bin_counts, min=1.0),
                     torch.zeros_like(bin_sums))
    slope = mu @ slope_w

    # phase entropy: 50 bins over [-pi, pi], the top edge in the last bin;
    # bin k = #{boundaries <= phase}, the JAX graph's cumulative counts.
    # Sums of ones (exact): torch.bincount on CUDA reads its largest index
    # on the host, which waits for the card's queue
    idx = torch.bucketize(phase, bounds, right=True)
    hist = torch.zeros((b, 50), device=gray.device).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=torch.float32))
    prob = hist / (torch.sum(hist, dim=1, keepdim=True) + _EPS)
    entropy = -torch.sum(prob * torch.log(prob + _EPS), dim=1)

    wave = haar_energies_2level(gray)                            # (B, 8)
    return torch.cat([
        torch.stack([el / et, em / et, eh / et,
                     (eh + _EPS) / (el + _EPS), slope, anis, entropy],
                    dim=-1),
        wave,
    ], dim=-1)


def extract_freq_vector(gray, kernels=KERNELS):
    """(B, 256, 256) grayscale [0,1] → (B, 24) standardised frequency
    features: concat fft + srm, then (v-mean)/(std+eps) with the unbiased
    24-sample std, and flat vectors zeroed."""
    v = torch.cat([fft_features(gray),
                   srm_features(gray, kernels.srm_raw_moments)], dim=-1)
    mean = torch.mean(v, dim=-1, keepdim=True)
    std = torch.std(v, dim=-1, keepdim=True, unbiased=True)
    out = (v - mean) / (std + _EPS)
    return torch.where(std < _EPS, torch.zeros_like(v), out)
