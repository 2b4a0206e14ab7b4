"""Forensic scalar battery (tpudf/ops/forensics.py), on tensors.

~40 scalar forensic cues per image, each a batched function over
(B, H, W[, 3]) float32 [0,1] inputs on the inputs' device: on the card the
battery is a stream of launches with no host round trip.

Numerics against the JAX package:
  * convolutions are `F.conv2d` / `F.conv1d` with the padding of JAX's
    `lax.conv_general_dilated` (zero, or symmetric by concatenation);
  * `f32_math()` keeps them and every product in f32 on the card: cuDNN
    would run an f32 convolution in TF32 by default
    (`torch.backends.cudnn.allow_tf32` is True), which keeps ~3 digits.
    `forensic_battery` runs inside it; callers of the single cues on the
    card (the report's fusion tail) enter it themselves;
  * histograms are `scatter_add_` of ones (exact counts, no host sync, as
    `torch.bincount` on CUDA would make);
  * every constant (kernels, masks, weights) is built once per device
    (`_const`), so a call copies nothing from the host.

Integer bins, thresholds, `round` and the hue branches turn last-bit
differences (torch against XLA, or the card against the CPU: CUDA divides
by a scalar through its reciprocal) into steps at ties; `TIE_STEPS` splits
each such cue at its binning, so that a step can be shown to be one
(tests/test_torch_port_forensics.py, chip_smoke.py phase 3r).

The approximation notes of the JAX module hold here unchanged (NlMeans →
gaussian-residual proxy, GLCM contrast in closed form, marginal HSV
histograms).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.ops.dct import dct2_8x8
from tpudf_torch.ops.dwt import haar_dwt2
from tpudf_torch.ops.fft_features import fft2_mag

_EPS = 1e-8

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = _SOBEL_X.T
_LAPLACE = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
_DEMOSAIC = np.array([[0.25, 0.5, 0.25]], np.float32)
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)
_BENFORD = np.log10(1.0 + 1.0 / np.arange(1, 10)).astype(np.float32)


@contextlib.contextmanager
def f32_math():
    """f32 convolutions and products on the card: TF32 off for cuDNN and
    cuBLAS inside, the caller's settings restored after."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


# ------------------------------------------------------------ primitives

@functools.lru_cache(maxsize=16)
def _gauss_kernel_np(sigma: float):
    radius = int(4.0 * sigma + 0.5)          # scipy gaussian_filter truncate=4
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32), radius


@functools.lru_cache(maxsize=64)
def _const(name: str, device: torch.device):
    """A numpy constant of this module as a tensor on `device`, made once."""
    if name.startswith("gauss"):
        arr = _gauss_kernel_np(float(name[5:]))[0]
    else:
        arr = {"sobel_x": _SOBEL_X, "sobel_y": _SOBEL_Y, "laplace": _LAPLACE,
               "demosaic": _DEMOSAIC, "gray": _GRAY,
               "benford": _BENFORD}[name]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _gray(img):
    """(B, H, W, 3) → (B, H, W) with the 0.299 / 0.587 / 0.114 weights."""
    return torch.einsum("bhwc,c->bhw", img, _const("gray", img.device))


def _pad_symmetric(x, r: int, dim: int):
    """numpy's "symmetric" padding (the edge repeated) of r along dim."""
    n = x.shape[dim]
    lo = torch.flip(x.narrow(dim, 0, r), (dim,))
    hi = torch.flip(x.narrow(dim, n - r, r), (dim,))
    return torch.cat([lo, x, hi], dim=dim)


def gaussian_blur(x, sigma: float):
    """scipy.ndimage.gaussian_filter equivalent (symmetric padding),
    batched over (B, H, W): the vertical then the horizontal pass."""
    _, radius = _gauss_kernel_np(float(sigma))
    k = _const(f"gauss{float(sigma)}", x.device)
    y = F.conv2d(_pad_symmetric(x, radius, 1)[:, None], k.reshape(1, 1, -1, 1))
    z = F.conv2d(_pad_symmetric(y[:, 0], radius, 2)[:, None],
                 k.reshape(1, 1, 1, -1))
    return z[:, 0]


def _conv3x3(x, name: str):
    """(B, H, W) same-size conv with zero padding by a named kernel."""
    k = _const(name, x.device)
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    return F.conv2d(x[:, None], k[None, None], padding=(ph, pw))[:, 0]


def sobel_mag(gray):
    gx = _conv3x3(gray, "sobel_x")
    gy = _conv3x3(gray, "sobel_y")
    return torch.sqrt(gx * gx + gy * gy)


def laplacian(gray):
    return _conv3x3(gray, "laplace")


def _var(x, dim):
    return torch.var(x, dim=dim, correction=0)


def _std(x, dim, keepdim=False):
    return torch.std(x, dim=dim, correction=0, keepdim=keepdim)


def _block_stats(x, bs, stat="var"):
    """(B, H, W) → per-block stat map (B, H//bs, W//bs)."""
    b, h, w = x.shape
    t = x[:, :h - h % bs, :w - w % bs]
    t = t.reshape(b, h // bs, bs, w // bs, bs)
    if stat == "var":
        return _var(t, (2, 4))
    if stat == "std":
        return _std(t, (2, 4))
    if stat == "mean":
        return torch.mean(t, dim=(2, 4))
    raise ValueError(stat)


def _hist(idx, bins: int):
    """Counts of int64 bin indices in [0, bins) along the last dim →
    (..., bins) f32 (exact: sums of ones)."""
    out = torch.zeros((*idx.shape[:-1], bins), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.float32))


def rgb_to_hsv_sat_hue(img):
    """(B,H,W,3) [0,1] → (sat [0,255], hue [0,180]) cv2 conventions."""
    mx = torch.amax(img, dim=-1)
    mn = torch.amin(img, dim=-1)
    d = mx - mn
    sat = torch.where(mx > 0, d / (mx + _EPS), 0.0) * 255.0
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    hue = torch.where(
        d < _EPS, 0.0,
        torch.where(mx == r, torch.remainder((g - b) / (d + _EPS), 6.0),
                    torch.where(mx == g, (b - r) / (d + _EPS) + 2.0,
                                (r - g) / (d + _EPS) + 4.0)))
    return sat, hue * 30.0          # degrees/2 as cv2 (0..180)


# ------------------------------------------------------------------ PRNU

def extract_prnu(gray, sigma=3.0):
    """Gaussian-residual PRNU map, zero-mean unit-std (appv3.py:1777-1800).
    gray: (B, H, W) [0,1] → (B, H, W)."""
    noise = gray - gaussian_blur(gray, sigma)
    mu = torch.mean(noise, dim=(1, 2), keepdim=True)
    sd = _std(noise, (1, 2), keepdim=True)
    return (noise - mu) / (sd + _EPS)


def prnu_strength(noise):
    """mean |noise| (appv3.py:1905-1909)."""
    return torch.mean(torch.abs(noise), dim=(1, 2))


def prnu_consistency_score(gray):
    """var of the standardized PRNU map (appv3.py:1802-1804)."""
    return _var(extract_prnu(gray), (1, 2))


def prnu_fft_consistency(noise):
    """Column-mean radial profile roughness of |FFT(noise)|
    (appv3.py:2405-2417)."""
    mag = fft2_mag(noise)
    radial = torch.mean(mag, dim=1)                   # (B, W)
    _, radius = _gauss_kernel_np(3.0)
    k = _const("gauss3.0", noise.device)
    rp = _pad_symmetric(radial, radius, 1)
    smooth = F.conv1d(rp[:, None], k.reshape(1, 1, -1))[:, 0]
    return torch.mean(torch.abs(radial - smooth), dim=1)


def prnu_acorr(gray):
    """PRNU autocorrelation peak through the (x-0.95)*20 squash
    (appv3.py:2081-2095): the zero-lag normalized autocorrelation, 1.0 on
    any image with a residual, 0 on a flat one (see the JAX module)."""
    noise = gray * 255.0 - gaussian_blur(gray * 255.0, 1.5)
    energy = torch.sum(noise * noise, dim=(1, 2))
    ac_peak = energy / (energy + _EPS)
    return torch.clamp((ac_peak - 0.95) * 20.0, 0.0, 1.0)


def prnu_temporal_incoherence(frames_gray):
    """Cross-frame PRNU correlation → incoherence score
    (appv3.py:1810-1846). frames_gray: (T, H, W) [0,1] → 0-d tensor."""
    prnus = extract_prnu(frames_gray)
    t = prnus.shape[0]
    a = prnus[:-1].reshape(t - 1, -1)
    b = prnus[1:].reshape(t - 1, -1)
    am = a - a.mean(1, keepdim=True)
    bm = b - b.mean(1, keepdim=True)
    corr = torch.sum(am * bm, 1) / (
        torch.linalg.vector_norm(am, dim=1)
        * torch.linalg.vector_norm(bm, dim=1) + _EPS)
    return torch.clamp((0.35 - torch.mean(corr)) / 0.35, 0.0, 1.0)


# ------------------------------------------------------------------- CFA

def extract_cfa_strength(img):
    """Green-channel horizontal-difference CFA strength
    (appv3.py:2020-2033)."""
    g = img[..., 1] * 255.0
    diff = torch.abs(g[:, :, 1:] - g[:, :, :-1])
    avg = torch.mean(diff, dim=(1, 2))
    return torch.clamp(1.0 - torch.clamp(avg / 32.0, 0.0, 1.0), 0.0, 1.0)


def extract_cfa_inverse(img):
    return 1.0 - extract_cfa_strength(img)


def cfa_bayer_score(gray):
    """Diagonal-difference periodicity fake score (appv3.py:3133-3144)."""
    y = gray * 255.0
    ad = torch.abs(y[:, 2:, 2:] - y[:, :-2, :-2])
    periodicity = torch.mean(ad, dim=(1, 2))
    return torch.clamp((periodicity - 5.0) / 15.0, 0.0, 1.0)


def extract_demosaic_error(img):
    """[0.25,0.5,0.25] green-channel reconstruction error
    (appv3.py:2103-2113)."""
    g = img[..., 1] * 255.0
    recon = _conv3x3(g, "demosaic")
    err = torch.mean(torch.abs(g - recon), dim=(1, 2))
    return torch.clamp(err / 20.0, 0.0, 1.0)


# ------------------------------------------------------------------ JPEG

def jpeg_residual_dct(gray):
    """Mean |AC| of 8x8 DCT blocks / 40 (appv3.py:2036-2052, 2116-2131)."""
    y = gray * 255.0 - 128.0
    co = dct2_8x8(y)
    b, h, w = co.shape
    bl = co.reshape(b, h // 8, 8, w // 8, 8)
    # reference averages |d[1:,1:]| per block (49 entries, not all 63 AC)
    mean_ac = torch.mean(torch.abs(bl[:, :, 1:, :, 1:]), dim=(1, 2, 3, 4))
    return torch.clamp(mean_ac / 40.0, 0.0, 1.0)


def qtable_consistency(gray):
    """16x16 block std-of-std consistency (appv3.py:2134-2149)."""
    stds = _block_stats(gray * 255.0, 16, "std")
    var = _std(stds, (1, 2))
    return torch.clamp(1.0 - torch.clamp(var / 20.0, 0.0, 1.0), 0.0, 1.0)


def jpeg_block_consistency(gray):
    """8x8 block-variance consistency, higher → more real
    (appv3.py:1911-1925)."""
    blk = _block_stats(gray * 255.0, 8, "var")
    return 1.0 - torch.clamp(_std(blk, (1, 2)) / 50.0, max=1.0)


def jpeg_q_mismatch(gray):
    """Per-8x8-block Laplacian-variance spread (appv3.py:2506-2515)."""
    lap = laplacian(gray * 255.0)
    blk = _block_stats(lap, 8, "var")
    return torch.clamp(_std(blk, (1, 2)) / 30.0, max=1.0)


# --------------------------------------------------------------- priors

def grain_likelihood(gray):
    """Photographic-grain prior, higher → more real (appv3.py:1993-1998)."""
    hp = gray * 255.0 - gaussian_blur(gray * 255.0, 1.2)
    return torch.clamp(torch.mean(torch.abs(hp), dim=(1, 2)) / 3.0, max=1.0)


def _highlight_from(g255):
    bright = torch.mean((g255 > 245.0).float(), dim=(1, 2))
    return torch.clamp(bright / 0.05, max=1.0)


def highlight_clipping_realness(gray):
    """Fraction of clipped highlights / 5% (appv3.py:1966-1970)."""
    return _highlight_from(gray * 255.0)


def crop_consistency_score(img):
    """Crop-variance stability over a fixed 3x3 grid of third-size crops,
    higher → more real (appv3.py:1973-1990; the JAX module's deterministic
    variant, its dynamic slices static here)."""
    x = img * 255.0
    _, h, w, _ = x.shape
    ch, cw = h // 3, w // 3
    crops = []
    for oy in (0, (h - ch) // 2, h - ch):
        for ox in (0, (w - cw) // 2, w - cw):
            crops.append(_var(x[:, oy:oy + ch, ox:ox + cw], (1, 2, 3)))
    scores = torch.stack(crops, dim=1)
    return 1.0 - torch.clamp(_std(scores, 1) / 100.0, max=1.0)


def hf_glcm_contrast(gray):
    """High-frequency GLCM contrast at distance 1, angle 0, in closed form:
    E[(I(x,y) - I(x,y+1))^2] over the normalized Laplacian
    (appv3.py:2152-2167)."""
    return _glcm_from(_glcm_levels(gray))


def _glcm_levels(gray):
    hf = laplacian(gray * 255.0)
    lo = torch.amin(hf, dim=(1, 2), keepdim=True)
    hi = torch.amax(hf, dim=(1, 2), keepdim=True)
    return (hf - lo) / (hi - lo + _EPS) * 255.0


def _glcm_from(levels):
    norm = torch.round(levels)
    d = norm[:, :, 1:] - norm[:, :, :-1]
    contrast = torch.mean(d * d, dim=(1, 2))
    return torch.clamp(contrast / 2000.0, 0.0, 1.0)


def multiscale_fft_confidence(gray):
    """Spectral-energy stability across 256/128/64 rescales → bool-ish
    (appv3.py:2202-2222). (B,) 1.0 = stable (real-like); formula-exact, so
    it votes 0.0 on almost every natural image (see the JAX module)."""
    return _multiscale_from(_multiscale_stds(gray))


def _multiscale_stds(gray):
    from tpudf_torch.data.pipeline import resize
    scores = []
    b = gray.shape[0]
    for sz in (256, 128, 64):
        g = resize(gray, (b, sz, sz), "bilinear") * 255.0
        mag = fft2_mag(g, shifted=True)
        scores.append(_std(mag, (1, 2)))
    return torch.stack(scores, dim=1)


def _multiscale_from(s):
    diff = torch.amax(s, dim=1) - torch.amin(s, dim=1)
    mean = torch.mean(s, dim=1) + 1e-6
    return (diff < 0.15 * mean).float()


def noiseprint_score(gray):
    """Noise-variance inconsistency over 64px patches, higher → more fake
    (appv3.py:2225-2245; NlMeans → gaussian-denoise proxy)."""
    g255 = gray * 255.0
    residual = g255 - gaussian_blur(g255, 1.5)
    pv = _block_stats(residual, 64, "var").reshape(gray.shape[0], -1)
    mean_v = torch.mean(pv, dim=1) + 1e-6
    std_v = _std(pv, 1)
    consistency = 1.0 - torch.clamp(std_v / mean_v, max=1.0)
    return torch.clamp(1.0 - consistency, 0.0, 1.0)


# ------------------------------------------------------- diffusion cues

def perlin_diffusion_score(img):
    """Fixed perlin-diffusion smoothness score (appv3.py:2734-2777).
    img: (B,H,W,3) [0,1] RGB."""
    gray = _gray(img)
    gx = _conv3x3(gray, "sobel_x")
    gy = _conv3x3(gray, "sobel_y")
    grad = torch.sqrt(gx * gx + gy * gy)
    grad_norm = grad / (torch.mean(grad, dim=(1, 2), keepdim=True) + 1e-6)
    smoothness = torch.exp(-_std(grad_norm, (1, 2)))
    hp = gray - gaussian_blur(gray, 1.2)
    hf_penalty = torch.clamp(1.0 - _std(hp, (1, 2)) / 0.03, 0.0, 1.0)
    ent = laplacian(gray)
    entropy_score = torch.exp(-_std(ent, (1, 2)))
    prnu_map = gray - gaussian_blur(gray, 2.5)
    prnu_penalty = torch.clamp(1.0 - _std(prnu_map, (1, 2)) / 0.01, 0.0, 1.0)
    return torch.clamp(0.45 * smoothness + 0.25 * hf_penalty
                       + 0.15 * entropy_score + 0.15 * prnu_penalty, 0.0, 1.0)


@functools.lru_cache(maxsize=4)
def _radial_band_matrix(h, w, lo_frac, hi_frac):
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    rint = r.astype(np.int32)
    rmax = int(r.max())
    lo = max(2, int(lo_frac * rmax))
    hi = max(lo + 1, int(hi_frac * rmax))
    nb = hi - lo
    m = np.zeros((h * w, nb), np.float32)
    valid = (rint >= lo) & (rint < hi)
    m[np.arange(h * w)[valid.ravel()], (rint.ravel() - lo)[valid.ravel()]] = 1
    counts = m.sum(0)
    return m, counts


@functools.lru_cache(maxsize=8)
def _radial_consts(h, w, device):
    """The radial band matrix, its counts (at least 1), the centred log
    frequencies of its bins and their sum of squares, on `device`."""
    m, counts = _radial_band_matrix(h, w, 0.2, 0.8)
    log_f = np.log(np.arange(m.shape[1], dtype=np.float32)
                   + np.float32(1e-6))
    xc = log_f - np.mean(log_f, dtype=np.float32)
    return (torch.from_numpy(m).to(device),
            torch.from_numpy(np.maximum(counts, 1.0)).to(device),
            torch.from_numpy(xc).to(device))


def diffusion_perlin_residual(gray):
    """Laplacian-residual radial-PSD log-log slope → diffusion score
    (appv3.py:2811-2863)."""
    b, h, w = gray.shape
    g = gray * 255.0
    g = (g - torch.mean(g, dim=(1, 2), keepdim=True)) / (
        _std(g, (1, 2), keepdim=True) + 1e-6)
    res = laplacian(g)
    psd = fft2_mag(res, shifted=True) ** 2
    m, counts, xc = _radial_consts(h, w, gray.device)
    sums = psd.reshape(b, -1) @ m
    radial = sums / counts + 1e-8
    radial = radial / torch.amax(radial, dim=1, keepdim=True)
    log_p = torch.log(radial + 1e-6)
    slope = (log_p @ xc) / torch.sum(xc * xc)
    return torch.clamp(slope + 1.0, 0.0, 1.0)


def perlin_residual_score(gray):
    """Radial-PSD flatness of the Laplacian residual (appv3.py:2780-2809)."""
    b, h, w = gray.shape
    hp = laplacian(gray)
    psd = fft2_mag(hp, shifted=True) ** 2
    m, counts, _ = _radial_consts(h, w, gray.device)
    radial = psd.reshape(b, -1) @ m / counts + 1e-9
    radial = radial / torch.amax(radial, dim=1, keepdim=True)
    return torch.clamp(1.0 - _var(radial, 1), 0.0, 1.0)


@functools.lru_cache(maxsize=8)
def _flatness_mask(h, w, device):
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    mask = ((r > 0.2 * min(h, w)) & (r < 0.6 * min(h, w))).astype(np.float32)
    return torch.from_numpy(mask.ravel()).to(device)


def spectral_flatness_score(gray):
    """Mid-band geometric/arithmetic PSD flatness (appv3.py:3068-3096)."""
    b, h, w = gray.shape
    psd = fft2_mag(gray, shifted=True) ** 2 + 1e-8
    mask = _flatness_mask(h, w, gray.device)
    n = torch.sum(mask)
    flat = psd.reshape(b, -1)
    gm = torch.exp((torch.log(flat) @ mask) / n)
    am = (flat @ mask) / n
    flatness = gm / (am + 1e-8)
    return torch.clamp(1.0 - flatness * 10.0, 0.0, 1.0)


def esrgan_grid_score(gray):
    """Every-8th-row/col log-spectrum energy (upscaler grid artifact,
    appv3.py:2481-2486)."""
    mag = torch.log1p(fft2_mag(gray * 255.0, shifted=True))
    v = torch.mean(mag[:, :, ::8], dim=(1, 2))
    h = torch.mean(mag[:, ::8, :], dim=(1, 2))
    return torch.clamp((v + h) / 50.0, 0.0, 1.0)


# ----------------------------------------------------------- color cues

def saturation_peak_score(img):
    """Fraction of saturation > 200 / 5% (appv3.py:2489-2493)."""
    return _saturation_from(rgb_to_hsv_sat_hue(img)[0])


def _saturation_from(sat):
    ratio = torch.mean((sat > 200.0).float(), dim=(1, 2))
    return torch.clamp(ratio / 0.05, max=1.0)


def color_harmony_score(img):
    """Hue-histogram dispersion (appv3.py:2996-3004)."""
    return _harmony_from(rgb_to_hsv_sat_hue(img)[1] / 5.0)


def _harmony_from(hue5):
    b = hue5.shape[0]
    idx = torch.clamp(hue5, 0, 35).to(torch.int64).reshape(b, -1)
    return torch.clamp(_std(_hist(idx, 36), 1) / 200.0, max=1.0)


def color_correlation_score(img):
    """Patchwise RGB channel decorrelation (appv3.py:3099-3130)."""
    b, h, w, _ = img.shape
    ps = 32
    x = img[:, :h - h % ps, :w - w % ps]
    t = x.reshape(b, h // ps, ps, w // ps, ps, 3)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, ps * ps, 3)
    mu = torch.mean(t, dim=2, keepdim=True)
    c = t - mu
    sd = _std(t, 2) + _EPS                               # (b, n, 3)
    cov = torch.einsum("bnpc,bnpd->bncd", c, c) / (ps * ps)
    corr_rg = cov[..., 0, 1] / (sd[..., 0] * sd[..., 1])
    corr_rb = cov[..., 0, 2] / (sd[..., 0] * sd[..., 2])
    corr_gb = cov[..., 1, 2] / (sd[..., 1] * sd[..., 2])
    mean_corr = torch.mean((corr_rg + corr_rb + corr_gb) / 3.0, dim=1)
    return torch.clamp(1.0 - (mean_corr - 0.3) * 2.0, 0.0, 1.0)


def histogram_consistency(img):
    """Blockwise color-histogram inconsistency (appv3.py:3007-3047;
    marginal-histogram approximation, cosine similarity over 64px blocks)."""
    return _hist_consistency_from(_hist_scaled(img))


def _hist_scaled(img, bs=64, bins=32):
    """The 64 px blocks' values times the bin count, (B, blocks, px, 3)."""
    b, h, w, _ = img.shape
    x = img[:, :h - h % bs, :w - w % bs]
    gh, gw = x.shape[1] // bs, x.shape[2] // bs
    t = x.reshape(b, gh, bs, gw, bs, 3).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, gh * gw, bs * bs, 3) * bins


def _hist_consistency_from(scaled, bins=32):
    b, nb = scaled.shape[:2]
    idx = torch.clamp(scaled.to(torch.int64), 0, bins - 1)
    # per-channel histograms, channel c in bins [c·32, c·32 + 32)
    offs = torch.arange(3, device=scaled.device) * bins
    hist = _hist((idx + offs).reshape(b, nb, -1), 3 * bins)
    hist = hist / (torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
                   + _EPS)
    sim = torch.einsum("bnd,bmd->bnm", hist, hist)
    return torch.clamp(1.0 - torch.mean(sim, dim=(1, 2)), 0.0, 1.0)


# --------------------------------------------------------- texture cues

def texture_noise_score(img):
    """Texture uniformity + HF noise anomaly (appv3.py:2955-2972)."""
    gray = _gray(img)
    pv = _block_stats(gray, 32, "var").reshape(gray.shape[0], -1)
    texture_var = _var(pv, 1)
    texture_score = 1.0 - torch.clamp(texture_var / 0.05, max=1.0)
    lap = laplacian(gray)
    hf = _var(lap, (1, 2)) / (torch.mean(torch.abs(lap), dim=(1, 2)) + 1e-6)
    noise_score = torch.clamp(hf / 5.0, max=1.0)
    return torch.clamp(0.5 * texture_score + 0.5 * noise_score, 0.0, 1.0)


def vov_score(gray):
    """Variance-of-variance smoothness score (appv3.py:2866-2883)."""
    pv = _block_stats(gray, 32, "var").reshape(gray.shape[0], -1)
    v = _var(pv, 1)
    return torch.clamp(1.0 - v / (v + 0.05), 0.0, 1.0)


def asymmetry_score(img):
    """Left-right mirror similarity, higher → more fake
    (appv3.py:2974-2993)."""
    x = img * 255.0
    w = x.shape[2]
    mid = w // 2
    left = x[:, :, :mid]
    right = torch.flip(x[:, :, w - mid:], dims=(2,))
    diff = torch.mean(torch.abs(left - right), dim=(1, 2, 3))
    return torch.clamp(1.0 - torch.clamp(diff / 25.0, max=1.0), 0.0, 1.0)


def exposure_variation(gray):
    """Std of the equalized histogram (appv3.py:2518-2521), the
    equalization through the empirical CDF."""
    return _exposure_from(torch.clamp(gray * 255.0, 0, 255))


def _exposure_from(g255):
    b = g255.shape[0]
    g = g255.to(torch.int64).reshape(b, -1)
    cdf = torch.cumsum(_hist(g, 256), dim=1)
    cdf = cdf / cdf[:, -1:]
    eq = torch.gather(cdf, 1, g) * 255.0
    return _std(eq, 1) / 60.0


# ------------------------------------------------- benford / self-sim

def benford_distance(band):
    """L1 distance of the leading-digit histogram from Benford's law
    (appv3.py:1750-1764). band: (B, N) wavelet coefficients → (B,).
    Values with |x| <= 1 are excluded, exactly as the reference."""
    x = torch.abs(band)
    valid = x > 1.0
    xs = torch.clamp(x, min=1.0)
    mags = torch.floor(torch.log10(xs) + 1e-9)
    lead = torch.floor(xs / torch.pow(10.0, mags)).to(torch.int64)
    lead = torch.where(valid & (lead >= 1) & (lead <= 9), lead, 0)
    counts = _hist(lead, 10)[..., 1:]                          # (B, 9)
    tot = torch.sum(counts, dim=-1, keepdim=True)
    probs = counts / (tot + _EPS)
    dist = torch.sum(torch.abs(probs - _const("benford", band.device)),
                     dim=-1)
    return torch.where(tot[..., 0] > 0, dist, 0.0)


def benford_wavelet_score(gray):
    """Mean Benford distance over the db1 detail bands (appv3.py:1766-1775;
    the reference's db1 branch). gray: (B,H,W) [0,1]."""
    return _benford_from(torch.stack(haar_dwt2(gray * 255.0)[1], dim=1))


def _benford_from(bands):
    """bands: (B, 3, H/2, W/2), the detail bands LH, HL, HH."""
    b = bands.shape[0]
    d = [benford_distance(bands[:, i].reshape(b, -1)) for i in range(3)]
    return (d[0] + d[1] + d[2]) / 3.0


@functools.lru_cache(maxsize=2)
def _selfsim_pair_mask_np(n_grid: int, patch: int):
    """Static valid-pair mask for the self-similarity score: upper-triangle
    pairs whose patch coordinates differ by >= 2*patch in y OR x (the
    reference excludes near neighbours, appv3.py:2913-2915)."""
    coords = np.stack(np.mgrid[0:n_grid, 0:n_grid], -1).reshape(-1, 2) * patch
    dy = np.abs(coords[:, None, 0] - coords[None, :, 0])
    dx = np.abs(coords[:, None, 1] - coords[None, :, 1])
    far = (dy >= 2 * patch) | (dx >= 2 * patch)
    upper = np.triu(np.ones((len(coords), len(coords)), bool), k=1)
    return (far & upper).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _selfsim_pair_mask(n_grid: int, patch: int, device):
    mask = torch.from_numpy(_selfsim_pair_mask_np(n_grid, patch)).to(device)
    return mask, torch.sum(mask)


def self_similarity_anomaly_score(img, patch: int = 16):
    """Fraction of distant patch pairs with cosine similarity > 0.90 over
    the full non-overlapping 16px grid (appv3.py:2886-2923; the JAX
    module's deterministic variant). img: (B, 256, 256, 3) [0,1]."""
    return _selfsim_from(_selfsim_sims(img, patch), patch)


def _selfsim_sims(img, patch: int = 16):
    """The cosine similarities of every pair of the grid's patches."""
    b, h, w, c = img.shape
    ng = h // patch
    t = img.reshape(b, ng, patch, ng, patch, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, ng * ng, patch * patch * c)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-9)
    return torch.einsum("bnd,bmd->bnm", t, t)


def _selfsim_from(sims, patch: int = 16):
    ng = int(round(sims.shape[1] ** 0.5))
    mask, n = _selfsim_pair_mask(ng, patch, sims.device)
    high = torch.sum((sims > 0.90).float() * mask, dim=(1, 2))
    return torch.clamp(high / n, 0.0, 1.0)


def forensic_classic_score(gray):
    """PRNU-consistency classic forensic score (appv3.py:2722-2727)."""
    pr = prnu_consistency_score(gray)
    return torch.clamp(1.0 - torch.clamp(pr / 3.5, max=1.0), 0.0, 1.0)


def diffusion_score_v2(gray, img):
    """The reference's composite diffusion score (appv3.py:2927-2931):
    0.4*perlin_residual + 0.3*vov + 0.3*self_similarity."""
    return torch.clamp(0.4 * perlin_residual_score(gray)
                       + 0.3 * vov_score(gray)
                       + 0.3 * self_similarity_anomaly_score(img), 0.0, 1.0)


def forensic_v2_score(gray, img):
    """forensic_v2 composite (appv3.py:2934-2951): classic + perlin +
    texture/noise + noiseprint blended 40/60 with the diffusion score.
    Returns (forensic_v2, diffusion) as the reference does."""
    diff = diffusion_score_v2(gray, img)
    v3 = torch.clamp(0.30 * forensic_classic_score(gray)
                     + 0.30 * perlin_diffusion_score(img)
                     + 0.20 * texture_noise_score(img)
                     + 0.20 * noiseprint_score(gray), 0.0, 1.0)
    return torch.clamp(0.4 * v3 + 0.6 * diff, 0.0, 1.0), diff


# ---------------------------------------------------- aggregate priors

def _prnu_std(gray):
    return torch.clamp(_std(gray * 255.0 - gaussian_blur(gray * 255.0, 3.0),
                            (1, 2)) / 10.0, 0.0, 1.0)


def real_image_prior_v2(img, gray):
    """PRNU + CFA-inverse + JPEG DCT prior (appv3.py:2055-2080)."""
    cfa_inv = extract_cfa_inverse(img)
    jpeg_res = jpeg_residual_dct(gray)
    return torch.clamp(_prnu_std(gray) * 0.40 + cfa_inv * 0.35
                       + jpeg_res * 0.25, 0.0, 1.0)


def real_image_prior_v3(img, gray):
    """7-cue real prior (appv3.py:2170-2199)."""
    prnu_ac = prnu_acorr(gray)
    cfa_inv = extract_cfa_inverse(img)
    dem_err = extract_demosaic_error(img)
    jpeg_res = jpeg_residual_dct(gray)
    jpeg_q = qtable_consistency(gray)
    glcm = hf_glcm_contrast(gray)
    return torch.clamp(_prnu_std(gray) * 0.22 + prnu_ac * 0.18
                       + (1 - cfa_inv) * 0.12 + (1 - dem_err) * 0.12
                       + jpeg_res * 0.12 + jpeg_q * 0.12 + glcm * 0.12,
                       0.0, 1.0)


def real_prior_v2_aggregate(img, gray):
    """7-way aggregate real prior (appv3.py:3050-3066)."""
    r1 = jpeg_block_consistency(gray)
    r2 = highlight_clipping_realness(gray)
    r3 = crop_consistency_score(img)
    r4 = 1.0 - cfa_bayer_score(gray)
    r5 = torch.clamp(prnu_consistency_score(gray), 0.0, 1.0)
    r6 = grain_likelihood(gray)
    r7 = multiscale_fft_confidence(gray)
    return torch.clamp((r1 + r2 + r3 + r4 + r5 + r6 + r7) / 7.0, 0.0, 1.0)


def real_hard_override(cfa, grain, jpeg):
    """(B,) bool hard-real override (appv3.py:2471-2478)."""
    return (cfa < 0.18) & (grain > 0.80) & (jpeg < 0.002)


# ---------------------------------------------------- generator vote

GEN_WEIGHTS = (("diffusion", 0.18), ("perlin", 0.12), ("texture_noise", 0.10),
               ("render", 0.08), ("jpeg_q", 0.10), ("sat_peak", 0.08),
               ("spectral", 0.08), ("cfa_fake", 0.10), ("esrgan", 0.06),
               ("embedding_anomaly", 0.05), ("patch_spread", 0.04),
               ("head_delta", 0.03))
REAL_GUARD_WEIGHTS = (("prnu_scaled", 0.25), ("grain_real", 0.20),
                      ("real_prior_v4", 0.25), ("hc_score", 0.15),
                      ("jpeg_q_inv", 0.15))


def image_generator_likelihood(signals: dict):
    """Weighted synthetic-likelihood vote with real-guard attenuation
    (appv3.py:2569-2645). signals: dict of (B,) tensors; missing keys are
    skipped (weights renormalized), as in the reference."""
    num = 0.0
    den = 0.0
    for k, w in GEN_WEIGHTS:
        if k in signals and signals[k] is not None:
            num = num + torch.clamp(signals[k], 0.0, 1.0) * w
            den = den + w
    raw = num / max(den, 1e-6) if den else 0.0

    gnum, gden = 0.0, 0.0
    guard = dict(signals)
    if "jpeg_q" in signals and signals["jpeg_q"] is not None:
        guard["jpeg_q_inv"] = 1.0 - torch.clamp(signals["jpeg_q"], 0.0, 1.0)
    for k, w in REAL_GUARD_WEIGHTS:
        if k in guard and guard[k] is not None:
            gnum = gnum + torch.clamp(guard[k], 0.0, 1.0) * w
            gden = gden + w
    real_guard = gnum / max(gden, 1e-6) if gden else 0.0

    return torch.clamp(raw * (1.0 - 0.55 * real_guard), 0.0, 1.0)


# ------------------------------------------------------- steps at ties

# The cues that bin, threshold or round a float, each as (pre(img, gray) →
# the float it bins, post(pre) → the cue), so that cue = post(pre). Where
# two implementations' `pre` agree but for rounding, a cue that differs
# is a step of `post` at a tie (integer bins on uint8-derived values land
# on bin edges often). The composite cues are linear in some of them:
# {cue: {binned cue: weight}}.
TIE_STEPS = {
    "benford_wavelet": (
        lambda img, gray: torch.stack(haar_dwt2(gray * 255.0)[1], dim=1),
        _benford_from),
    "color_harmony": (lambda img, gray: rgb_to_hsv_sat_hue(img)[1] / 5.0,
                      _harmony_from),
    "exposure_variation": (
        lambda img, gray: torch.clamp(gray * 255.0, 0, 255), _exposure_from),
    "glcm_contrast": (lambda img, gray: _glcm_levels(gray), _glcm_from),
    "highlight_clipping": (lambda img, gray: gray * 255.0, _highlight_from),
    "histogram_consistency": (lambda img, gray: _hist_scaled(img),
                              _hist_consistency_from),
    "multiscale_fft": (lambda img, gray: _multiscale_stds(gray),
                       _multiscale_from),
    "saturation_peak": (lambda img, gray: rgb_to_hsv_sat_hue(img)[0],
                        _saturation_from),
    "self_similarity": (lambda img, gray: _selfsim_sims(img),
                        _selfsim_from),
}
TIE_LINEAR = {
    "real_prior_v3": {"glcm_contrast": 0.12},
    "real_prior_agg": {"highlight_clipping": 1 / 7, "multiscale_fft": 1 / 7},
    "diffusion_v2": {"self_similarity": 0.3},
    "forensic_v2": {"self_similarity": 0.6 * 0.3},
}


# ----------------------------------------------------------- batteries

BATTERY_KEYS = (
    "asymmetry", "benford_wavelet", "cfa_fake", "cfa_strength",
    "color_correlation", "color_harmony", "crop_consistency",
    "demosaic_error", "diffusion", "diffusion_v2", "esrgan_grid",
    "exposure_variation", "forensic_v2", "glcm_contrast", "grain",
    "highlight_clipping", "histogram_consistency", "jpeg_block_consistency",
    "jpeg_q_mismatch", "jpeg_residual", "multiscale_fft", "noiseprint",
    "perlin", "perlin_residual", "prnu_acorr", "prnu_fft_consistency",
    "prnu_strength", "qtable_consistency", "real_prior_agg",
    "real_prior_v2", "real_prior_v3", "saturation_peak", "self_similarity",
    "spectral_flatness", "texture_noise", "vov")
"""The battery's output keys, sorted: the fusion tail's fb_* columns."""


def forensic_battery(img):
    """Run the full static-image battery on (B, 256, 256, 3) [0,1] RGB.
    Returns dict of (B,) scores, computed on img's device in f32."""
    with f32_math():
        gray = _gray(img)
        noise = extract_prnu(gray)
        out = {
            "prnu_strength": prnu_strength(noise),
            "prnu_fft_consistency": prnu_fft_consistency(noise),
            "prnu_acorr": prnu_acorr(gray),
            "cfa_strength": extract_cfa_strength(img),
            "cfa_fake": cfa_bayer_score(gray),
            "demosaic_error": extract_demosaic_error(img),
            "jpeg_residual": jpeg_residual_dct(gray),
            "jpeg_block_consistency": jpeg_block_consistency(gray),
            "jpeg_q_mismatch": jpeg_q_mismatch(gray),
            "qtable_consistency": qtable_consistency(gray),
            "grain": grain_likelihood(gray),
            "highlight_clipping": highlight_clipping_realness(gray),
            "crop_consistency": crop_consistency_score(img),
            "glcm_contrast": hf_glcm_contrast(gray),
            "multiscale_fft": multiscale_fft_confidence(gray),
            "noiseprint": noiseprint_score(gray),
            "perlin": perlin_diffusion_score(img),
            "perlin_residual": perlin_residual_score(gray),
            "diffusion": diffusion_perlin_residual(gray),
            "spectral_flatness": spectral_flatness_score(gray),
            "esrgan_grid": esrgan_grid_score(gray),
            "saturation_peak": saturation_peak_score(img),
            "color_harmony": color_harmony_score(img),
            "color_correlation": color_correlation_score(img),
            "histogram_consistency": histogram_consistency(img),
            "texture_noise": texture_noise_score(img),
            "vov": vov_score(gray),
            "asymmetry": asymmetry_score(img),
            "exposure_variation": exposure_variation(gray),
            "real_prior_v2": real_image_prior_v2(img, gray),
            "real_prior_v3": real_image_prior_v3(img, gray),
            "real_prior_agg": real_prior_v2_aggregate(img, gray),
            "benford_wavelet": benford_wavelet_score(gray),
            "self_similarity": self_similarity_anomaly_score(img),
        }
        fv2, diff_v2 = forensic_v2_score(gray, img)
    out["diffusion_v2"] = diff_v2
    out["forensic_v2"] = fv2
    return out
