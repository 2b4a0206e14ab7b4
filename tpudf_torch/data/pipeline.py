"""Device-side preprocessing (tpudf/data/pipeline.py) on PyTorch tensors.

uint8 images go to the card once; resize, crop, flip, rotation and SigLIP
normalisation run there. All functions are batched, NHWC.

Resizing is JAX's, not `F.interpolate`'s: `jax.image.resize` samples at
half-pixel positions with a Keys cubic (a = −0.5) or a triangle kernel,
widens the kernel by 1/scale only when downscaling with antialias, divides
each output's weights by their sum (so the border renormalises instead of
replicating), and zeroes outputs whose sample lies outside
[−0.5, in − 0.5]. `resize_matrix` builds that (dst, src) weight matrix in
numpy float32 by the same rule, and `resize` applies it per axis as a
product, skipping axes whose size does not change, as JAX does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5
GRAY = (0.299, 0.587, 0.114)


def normalize_siglip(x):
    """uint8/float [0,255]/[0,1] pixels → SigLIP-normalized float."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return (x - SIGLIP_MEAN) / SIGLIP_STD


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


def resize_matrix(src: int, dst: int, method: str,
                  antialias: bool = True) -> np.ndarray:
    """(dst, src) float32 weights of jax.image.resize along one axis."""
    kernel = _KERNELS[method]
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(dst) / f32(src))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=f32)[:, None]
               ) / kernel_scale
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).T, f32)


@functools.lru_cache(maxsize=64)
def _matrix_on(src, dst, method, antialias, device):
    """resize_matrix as a tensor on `device`, built once per geometry."""
    return torch.from_numpy(resize_matrix(src, dst, method, antialias)).to(
        device)


def resize(x, shape, method: str, antialias: bool = True):
    """jax.image.resize(x, shape, method, antialias) for float x."""
    x = x if x.is_floating_point() else x.float()
    for d, n in enumerate(shape):
        m = x.shape[d]
        if m == n:
            continue
        wm = _matrix_on(m, n, method, antialias, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(wm, x, dims=([1], [d])), 0, d)
    return x


def resize_bilinear(x, size: int):
    """(B, H, W, C) → (B, size, size, C), antialiased bilinear (PIL-like)."""
    b, _, _, c = x.shape
    return resize(x.float(), (b, size, size, c), "bilinear")


def resize_bicubic(x, size: int):
    b, _, _, c = x.shape
    return resize(x.float(), (b, size, size, c), "cubic")


def center_crop(x, size: int):
    _, h, w, _ = x.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return x[:, top:top + size, left:left + size]


def preprocess_for_siglip(x, image_size: int, method="bicubic"):
    """Resize to the tower's square input, then normalize (the open_clip
    SigLIP eval transform: bicubic, 0.5/0.5)."""
    rs = resize_bicubic if method == "bicubic" else resize_bilinear
    if x.shape[1] != image_size or x.shape[2] != image_size:
        x = rs(x, image_size)
    return normalize_siglip(x)


@functools.lru_cache(maxsize=16)
def _const_on(values: tuple, dtype, device):
    """A small constant vector on `device`, copied there once (a copy from
    the host per call would wait for the card's queue)."""
    return torch.tensor(values, dtype=dtype, device=device)


def rgb_to_gray(x):
    """(B, H, W, 3) [0,1] → (B, H, W) luma (ITU-R 601)."""
    return torch.einsum("bhwc,c->bhw", x,
                        _const_on(tuple(GRAY), x.dtype, x.device))


# ----------------------------------------------------- multicrop inventory

def make_multicrops(x):
    """The 9-crop ensemble: center 50 %, left/right halves, top/bottom
    halves, 4 quadrants, each resized back to S (bicubic).

    x: (B, S, S, C) → crops (B, 9, S, S, C), weights (9,)"""
    b, s, _, c = x.shape
    m = s // 2

    def crop(top, left, hh, ww):
        return resize(x[:, top:top + hh, left:left + ww], (b, s, s, c),
                      "bicubic")

    q = (s - m) // 2
    views = [
        crop(q, q, m, m),          # center 50%
        crop(0, 0, s, m),          # left half
        crop(0, s - m, s, m),      # right half
        crop(0, 0, m, s),          # top half
        crop(s - m, 0, m, s),      # bottom half
        crop(0, 0, m, m),          # quadrants
        crop(0, s - m, m, m),
        crop(s - m, 0, m, m),
        crop(s - m, s - m, m, m),
    ]
    weights = _const_on((0.20,) + (0.10,) * 8, torch.float32, x.device)
    return torch.stack(views, dim=1), weights


def make_patch_grid(x, grid: int = 4):
    """Patch-grid localization views: the grid x grid tiles, row-major,
    each upscaled to S (bilinear). x: (B, S, S, C) → (B, grid², S, S, C).
    All tiles go through one resize: the same per-tile arithmetic."""
    b, s, _, c = x.shape
    ps = s // grid
    tiles = x[:, :grid * ps, :grid * ps].reshape(b, grid, ps, grid, ps, c)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * grid, ps, ps, c)
    return resize(tiles, (b, grid * grid, s, s, c), "bilinear")


def tta_views(x, *, vflip=False, rot=False):
    """Flip/rotate TTA battery: h-flip always, v-flip and rot90 optional.
    x: (B, S, S, C) → (B, K, S, S, C), K in {2, 3, 4}."""
    views = [x, torch.flip(x, dims=(2,))]
    if vflip:
        views.append(torch.flip(x, dims=(1,)))
    if rot:
        views.append(torch.rot90(x, 1, dims=(1, 2)))
    return torch.stack(views, dim=1)


def rot90_view(x):
    """90° rotated dual view (jnp.rot90(k=1, axes=(1, 2)))."""
    return torch.rot90(x, 1, dims=(1, 2))
