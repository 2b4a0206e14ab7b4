"""Named TTA transform battery for batch inference (tpudf/data/tta.py).

Device equivalents of the reference's 9 named TTA transforms
(inference_deepfakeface_complete.py:84-128, 220-314): identity, flips,
rotations, CLAHE-like local contrast, sharpen, edge-enhance, brightness.
All pure (B, H, W, 3) [0,1] → same-shape transforms on the input's
device that stack into one padded ViT batch.
"""

from __future__ import annotations

import torch

from tpudf_torch.data.augment import clahe_approx, gaussian_blur


def identity(x):
    return x


def hflip(x):
    return torch.flip(x, (2,))


def vflip(x):
    return torch.flip(x, (1,))


def rot90(x):
    return torch.rot90(x, 1, (1, 2))


def rot180(x):
    return torch.rot90(x, 2, (1, 2))


def rot270(x):
    return torch.rot90(x, 3, (1, 2))


def clahe(x):
    return clahe_approx(x)


def sharpen(x, amount=1.0):
    """Unsharp mask."""
    blur = gaussian_blur(x, sigma=1.0, radius=2)
    return torch.clamp(x + amount * (x - blur), 0.0, 1.0)


def edge_enhance(x):
    """PIL EDGE_ENHANCE-style kernel via unsharp with a stronger center."""
    blur = gaussian_blur(x, sigma=0.8, radius=1)
    return torch.clamp(1.5 * x - 0.5 * blur, 0.0, 1.0)


def brightness(x, delta=0.1):
    return torch.clamp(x + delta, 0.0, 1.0)


TTA_TRANSFORMS = {
    "identity": identity,
    "hflip": hflip,
    "vflip": vflip,
    "rot90": rot90,
    "rot180": rot180,
    "rot270": rot270,
    "clahe": clahe,
    "sharpen": sharpen,
    "edge_enhance": edge_enhance,
}


def tta_batch(x, names=None):
    """(B, S, S, 3) → ((B, K, S, S, 3) stacked named TTA views, names)."""
    names = names or list(TTA_TRANSFORMS)
    return torch.stack([TTA_TRANSFORMS[n](x) for n in names], dim=1), names


def jitter_views(generator: torch.Generator, x, n=4, max_shift=0.02):
    """Small random translate views (appv3.py:3353-3375 jitter_augment),
    the app's stability collage: each view rolls the batch by a shift
    drawn uniformly in ±max_shift of the side (rounded half to even,
    clipped to an eighth of it). `generator` takes the place of JAX's key
    (its draws are not JAX's). Returns (B, n, H, W, C)."""
    _, h, w, _ = x.shape
    views = []
    for _ in range(n):
        dy, dx = (torch.rand(2, generator=generator,
                             device=generator.device) * 2 - 1) * max_shift
        sy = int(torch.clamp(torch.round(dy * h), -(h // 8), h // 8))
        sx = int(torch.clamp(torch.round(dx * w), -(w // 8), w // 8))
        views.append(torch.roll(x, (sy, sx), (1, 2)))
    return torch.stack(views, dim=1)


def tta_aggregate(logits, axis=1, mode="mean"):
    """Aggregate per-view logits: mean (default), median (the mean of the
    two middle values when their count is even, as jnp.median) or a
    trimmed mean (an eighth off each end, at least one)."""
    if mode == "mean":
        return torch.mean(logits, dim=axis)
    if mode == "median":
        return torch.quantile(logits, 0.5, dim=axis)
    srt = torch.sort(logits, dim=axis).values
    k = logits.shape[axis]
    lo, hi = max(1, k // 8), k - max(1, k // 8)
    return torch.mean(srt.narrow(axis, lo, hi - lo), dim=axis)
