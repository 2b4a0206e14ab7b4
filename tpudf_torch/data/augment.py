"""Device-side training augmentation (tpudf/data/augment.py) on PyTorch
tensors: flips, rotation, color jitter, gaussian blur and noise, JPEG
simulation (8x8 DCT quantization) and CLAHE-style local contrast, on
(B, H, W, C) images in [0, 1].

Each random op of the JAX module (`random_hflip`, ..., `random_jpeg`) is
split into its draws (`*_draws`, from an explicit torch.Generator on the
images' device) and a pure apply (`*_apply`), so that a test can hand
JAX's draws to the apply; `augment_draws` and `augment_apply` are the
same split of `train_augment`, the one composition its callers use. The draws are not
JAX's numbers (another generator); their distributions are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.ops.dct import JPEG_LUMA_Q, dct2_8x8, idct2_8x8


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) \
        + lo


def _bernoulli(gen, p, n):
    return torch.rand((n,), generator=gen, device=gen.device) < p


def _per_image(mask):
    return mask[:, None, None, None]


def flip_draws(gen, b, p=0.5):
    """(B,) bool: which images a random flip flips."""
    return _bernoulli(gen, p, b)


def hflip_apply(x, flip):
    return torch.where(_per_image(flip), torch.flip(x, (2,)), x)


def vflip_apply(x, flip):
    return torch.where(_per_image(flip), torch.flip(x, (1,)), x)


def rot90_draws(gen, b):
    """(B,) int64 in 0..3: quarter turns per image."""
    return torch.randint(0, 4, (b,), generator=gen, device=gen.device)


def rot90_apply(x, k):
    """Rotate image i by k[i] quarter turns (square images), as
    jnp.rot90(x, k, (1, 2))."""
    rots = torch.stack([torch.rot90(x, j, (1, 2)) for j in range(4)], dim=1)
    idx = k.to(torch.long)[:, None, None, None, None].expand(
        -1, 1, *x.shape[1:])
    return torch.take_along_dim(rots, idx, dim=1)[:, 0]


def brightness_contrast_draws(gen, b, brightness=0.2, contrast=0.2):
    """(db, dc), each (B, 1, 1, 1): a brightness shift and a contrast
    factor 1 + u, u uniform in ±contrast."""
    db = _uniform(gen, (b, 1, 1, 1), -brightness, brightness)
    dc = 1.0 + _uniform(gen, (b, 1, 1, 1), -contrast, contrast)
    return db, dc


def brightness_contrast_apply(x, db, dc):
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * dc + mean + db, 0.0, 1.0)


def saturation_draws(gen, b, sat=0.2):
    """(B, 1, 1, 1) saturation factors 1 + u, u uniform in ±sat."""
    return 1.0 + _uniform(gen, (b, 1, 1, 1), -sat, sat)


def saturation_apply(x, s):
    gray = torch.mean(x, dim=-1, keepdim=True)
    return torch.clamp(gray + (x - gray) * s, 0.0, 1.0)


@functools.lru_cache(maxsize=8)
def _gauss_kernel_np(sigma: float, radius: int):
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype("float32")


def gaussian_blur(x, sigma=1.0, radius=2):
    """Separable gaussian blur of (B, H, W, C), zero padding."""
    k = torch.from_numpy(_gauss_kernel_np(float(sigma), radius)).to(
        device=x.device, dtype=x.dtype)
    b, h, w, c = x.shape
    xr = torch.movedim(x, -1, 1).reshape(b * c, 1, h, w)
    y = F.conv2d(xr, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    y = F.conv2d(y, k.reshape(1, 1, 1, -1), padding=(0, radius))
    return torch.movedim(y.reshape(b, c, h, w), 1, -1)


def blur_apply(x, do, sigma=1.0):
    return torch.where(_per_image(do), gaussian_blur(x, sigma), x)


def noise_draws(gen, shape, p=0.3, std=0.02):
    """(noise of x's shape, std-scaled; (B,) bool: which images get it)."""
    noise = torch.randn(shape, generator=gen, device=gen.device) * std
    return noise, _bernoulli(gen, p, shape[0])


def noise_apply(x, noise, do):
    return torch.clamp(x + torch.where(_per_image(do), noise,
                                       torch.zeros_like(noise)), 0.0, 1.0)


def jpeg_simulate(x, quality: int):
    """JPEG-artifact simulation: luma-only 8x8 DCT → quantize with the
    standard luminance table scaled to `quality` → dequant → inverse DCT
    (the reference UltraJPEGTransform's device analogue,
    cifake_binary_classifier.py:86-110)."""
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = torch.clamp(torch.floor((torch.from_numpy(JPEG_LUMA_Q) * scale
                                 + 50.0) / 100.0), 1, 255).to(x.device)
    h, w = x.shape[1], x.shape[2]
    q_full = q.repeat(h // 8, w // 8)[None, :, :, None]
    coeffs = dct2_8x8(x * 255.0 - 128.0)
    out = idct2_8x8(torch.round(coeffs / q_full) * q_full)
    return torch.clamp((out + 128.0) / 255.0, 0.0, 1.0)


def jpeg_levels(q_lo=5, q_hi=25, n_levels=5):
    """The static quality ladder of `random_jpeg`."""
    return [int(q_lo + i * (q_hi - q_lo) / (n_levels - 1))
            for i in range(n_levels)]


def jpeg_draws(gen, b, p=0.5, n_levels=5):
    """((B,) ladder index per image, (B,) bool: which images change)."""
    pick = torch.randint(0, n_levels, (b,), generator=gen, device=gen.device)
    return pick, _bernoulli(gen, p, b)


def jpeg_apply(x, pick, do, q_lo=5, q_hi=25, n_levels=5):
    variants = torch.stack([jpeg_simulate(x, q) for q in
                            jpeg_levels(q_lo, q_hi, n_levels)], dim=1)
    idx = pick.to(torch.long)[:, None, None, None, None].expand(
        -1, 1, *x.shape[1:])
    picked = torch.take_along_dim(variants, idx, dim=1)[:, 0]
    return torch.where(_per_image(do), picked, x)


def clahe_approx(x, clip=0.03, grid=8):
    """CLAHE approximation: per-tile mean / std local contrast
    normalisation blended with the input, per channel
    (siglip2siddataset.py:983-1048)."""
    b, h, w, c = x.shape
    th, tw = h // grid, w // grid
    tiles = x.reshape(b, grid, th, grid, tw, c)
    mu = torch.mean(tiles, dim=(2, 4), keepdim=True)
    sd = torch.std(tiles, dim=(2, 4), keepdim=True, unbiased=False) + 1e-5
    normed = torch.clamp((tiles - mu) / sd, -2.5, 2.5)
    eq = (normed * torch.clamp(sd, max=clip * 2.5) + mu).reshape(b, h, w, c)
    return torch.clamp(0.5 * x + 0.5 * eq, 0.0, 1.0)


def augment_draws(gen, shape, *, hflip=True, rot=False, jitter=True,
                  blur=True, noise=True, jpeg=False):
    """Every draw of `train_augment` for images of `shape`, in its order."""
    b = shape[0]
    d = {}
    if hflip:
        d["hflip"] = flip_draws(gen, b)
    if rot:
        d["rot"] = rot90_draws(gen, b)
    if jitter:
        d["bc"] = brightness_contrast_draws(gen, b)
        d["sat"] = saturation_draws(gen, b)
    if blur:
        d["blur"] = _bernoulli(gen, 0.3, b)
    if noise:
        d["noise"] = noise_draws(gen, shape)
    if jpeg:
        d["jpeg"] = jpeg_draws(gen, b)
    return d


def augment_apply(x, draws):
    """The composite pipeline of `train_augment` on given draws."""
    if "hflip" in draws:
        x = hflip_apply(x, draws["hflip"])
    if "rot" in draws:
        x = rot90_apply(x, draws["rot"])
    if "bc" in draws:
        x = brightness_contrast_apply(x, *draws["bc"])
        x = saturation_apply(x, draws["sat"])
    if "blur" in draws:
        x = blur_apply(x, draws["blur"])
    if "noise" in draws:
        x = noise_apply(x, *draws["noise"])
    if "jpeg" in draws:
        x = jpeg_apply(x, *draws["jpeg"])
    return x


def train_augment(gen, x, *, hflip=True, rot=False, jitter=True, blur=True,
                  noise=True, jpeg=False):
    """Composite training pipeline mirroring the reference Kornia stacks."""
    return augment_apply(x, augment_draws(
        gen, x.shape, hflip=hflip, rot=rot, jitter=jitter, blur=blur,
        noise=noise, jpeg=jpeg))
