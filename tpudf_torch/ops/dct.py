"""8x8 block DCT-II/III as small products (tpudf/ops/dct.py).

The reference uses scipy.fft.dct for JPEG-residual forensics
(appv3.py:2035-2149); the blockwise 2-D DCT is two 8 x 8 products per
tile, batched over all tiles. JPEG's luminance table and the orthonormal
DCT matrix are numpy constants (the JAX module's, copied).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# standard JPEG luminance quantization table (Annex K)
JPEG_LUMA_Q = (np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32))


@functools.lru_cache(maxsize=2)
def _dct_matrix_np(n: int = 8):
    """Orthonormal DCT-II matrix D (f32): X = D x Dᵀ for an n x n block."""
    d = np.zeros((n, n), np.float64)
    for k in range(n):
        for i in range(n):
            d[k, i] = math.cos(math.pi * (2 * i + 1) * k / (2 * n))
    d *= math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float32)


def _dct_matrix(like, n: int = 8):
    return _dct_matrix_on(n, like.device, like.dtype)


@functools.lru_cache(maxsize=8)
def _dct_matrix_on(n, device, dtype):
    """The matrix on `device`, copied there once (a copy from the host per
    call would wait for the card's queue)."""
    return torch.from_numpy(_dct_matrix_np(n)).to(device=device, dtype=dtype)


def _blocks(x, n=8):
    """(B, H, W) or (B, H, W, C) → (..., H/n, W/n, n, n) per channel."""
    chan = x.dim() == 4
    if chan:
        x = torch.movedim(x, -1, 1)               # (B, C, H, W)
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // n, n, w // n, n).transpose(-3, -2)
    return x, chan


def _unblocks(x, chan):
    *lead, gh, gw, n, _ = x.shape
    x = x.transpose(-3, -2).reshape(*lead, gh * n, gw * n)
    return torch.movedim(x, 1, -1) if chan else x


def dct2_8x8(x):
    """Blockwise 2-D DCT-II of (B, H, W) or (B, H, W, C), H, W % 8 == 0;
    the coefficients laid out blockwise in place."""
    d = _dct_matrix(x)
    bl, chan = _blocks(x, 8)
    return _unblocks(torch.einsum("ki,...ij,lj->...kl", d, bl, d), chan)


def idct2_8x8(x):
    """The inverse (DCT-III) of `dct2_8x8`."""
    d = _dct_matrix(x)
    bl, chan = _blocks(x, 8)
    return _unblocks(torch.einsum("ik,...ij,jl->...kl", d, bl, d), chan)


def blockwise_dct_energy(gray):
    """Per-block AC energy map: (B, H, W) → (B, H/8, W/8) mean |AC coeff| —
    building block for JPEG-residual forensics (appv3.py:2035-2063)."""
    d = _dct_matrix(gray)
    bl, _ = _blocks(gray, 8)
    co = torch.einsum("ki,...ij,lj->...kl", d, bl, d)
    ac = torch.abs(co).sum((-2, -1)) - torch.abs(co[..., 0, 0])
    return ac / 63.0
