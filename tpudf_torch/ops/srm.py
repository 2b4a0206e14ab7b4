"""SRM (steganalysis rich model) residual statistics — kernel K3.

`srm_raw_moments` gives E[r], E[r²], E[r³], E[r⁴] of the two distinct SRM
residuals (K1 and K2 normalise to the same 3x3 stencil): r2 from the
[-1 2 -1; 2 -4 2; -1 2 -1]/16 stencil and r3 from the 4-neighbour
Laplacian /8, both 'same' size with zero padding.

Replaces tpudf/ops/srm.py `_srm_moments_kernel` (wrapper
`srm_raw_moments`). The CUDA kernel (`csrc/srm.cu`) cuts each image in
tiles of a strip of rows by up to 1024 columns (`srm_plan`), one block a
tile, so that small batches fill the card: a block copies its tile and a
one-pixel halo (zeros outside the image) into shared memory, forms both
residuals there tap by tap, accumulates the four powers in f64 and reduces
them to the tile's partial (by warp shuffles, then in warp order); the last
tile of an image to finish adds the partials in tile order, so the result
does not depend on which block finishes last. It is bound by device-memory
bytes (one f32 read per pixel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build

KERNEL = "srm_raw_moments"

# appv3.py:1597-1615 kernel bank, each normalised by its |sum| at use site.
# K1 (5x5) is K2 inside a zero ring, so only K2 and K3 are distinct after
# normalisation.
_K1 = np.array([[0, 0, 0, 0, 0],
                [0, -1, 2, -1, 0],
                [0, 2, -4, 2, 0],
                [0, -1, 2, -1, 0],
                [0, 0, 0, 0, 0]], np.float32)
_K2 = np.array([[-1, 2, -1],
                [2, -4, 2],
                [-1, 2, -1]], np.float32)
_K3 = np.array([[0, -1, 0],
                [-1, 4, -1],
                [0, -1, 0]], np.float32)

SRM_KERNELS = [_K1, _K2, _K3]
_EPS = 1e-6


def _norm(k):
    return k / (np.abs(k).sum() + _EPS)


def _stencil3(gray, k3):
    """'same' zero-padded 3x3 correlation, summed tap by tap in row-major
    order with f32 products (the order csrc/srm.cu uses)."""
    b, h, w = gray.shape
    p = F.pad(gray, (1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            c = float(k3[di, dj])
            if c == 0.0:
                continue
            t = p[:, di:di + h, dj:dj + w] * c
            acc = t if acc is None else acc + t
    return acc


def srm_residuals(gray):
    """gray: (B, H, W) → list of 3 residual maps (B, H, W) ('same' size,
    zero padding — conv semantics of the reference). K1 (a zero ring
    around K2's pattern) and K2 normalise to the same stencil, so their
    residual is computed once and listed twice."""
    r2 = _stencil3(gray, _norm(_K2))
    r3 = _stencil3(gray, _norm(_K3))
    return [r2, r2, r3]


def srm_raw_moments_reference(gray):
    """Plain PyTorch twin of K3: (B, H, W) f32 → (B, 8)."""
    b = gray.shape[0]
    gray = gray.float()
    moms = []
    for y in (_stencil3(gray, _norm(_K2)), _stencil3(gray, _norm(_K3))):
        flat = y.reshape(b, -1)
        x2 = flat * flat
        moms += [torch.mean(flat, 1), torch.mean(x2, 1),
                 torch.mean(x2 * flat, 1), torch.mean(x2 * x2, 1)]
    return torch.stack(moms, dim=-1)


SRM_THREADS = 256          # csrc/srm.cu kSrmThreads
SRM_MAX_COLS = 1024        # kSrmMaxCols
SRM_MIN_ROWS = 4           # kSrmMinRows
SRM_TILE_BYTES = 46 * 1024  # kSrmTileBytes
SRM_TARGET_BLOCKS = 264    # kSrmTargetBlocks


def srm_plan(b, h, w):
    """K3's tiles (csrc/srm.cu `srm_plan`): (rows of a strip, columns of a
    tile, strips, column tiles) at (B, H, W): enough tiles for
    SRM_TARGET_BLOCKS, strips of at least SRM_MIN_ROWS rows (H where
    fewer), the tile and its one-pixel halo within SRM_TILE_BYTES of f32."""
    cols = min(w, SRM_MAX_COLS)
    ctiles = -(-w // cols)
    want = -(-SRM_TARGET_BLOCKS // (b * ctiles))
    rows = max(-(-h // want), SRM_MIN_ROWS)
    rows = min(rows, SRM_TILE_BYTES // (4 * (cols + 2)) - 2, h)
    return rows, cols, -(-h // rows), ctiles


_counts = {}


def _zeroed_counts(b, device):
    """The kernel's per-image completion counts: zero before a launch and
    left zero by it (its last block per image resets its count), so one
    buffer serves every launch on a stream (one buffer a device and
    stream: launches on two streams may overlap)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    c = _counts.get(key)
    if c is None or c.numel() < b:
        c = torch.zeros(max(b, 256), dtype=torch.int32, device=device)
        _counts[key] = c
    return c


# the taps csrc/srm.cu multiplies (kK2Taps, kK3Taps): K2's nine, the
# Laplacian's edge-adjacent four and centre
K2_TAPS = tuple(range(9))
K3_TAPS = (1, 3, 4, 5, 7)


@functools.lru_cache(maxsize=8)
def _coeffs_on(device):
    """Both stencils' coefficients on `device`, copied there once (a copy
    from the host per launch would wait for the card's queue)."""
    return torch.from_numpy(np.concatenate(
        [_norm(_K2).ravel(), _norm(_K3).ravel()])).to(device)


def _srm_cuda(gray):
    b, h, w = gray.shape
    if gray.dtype != torch.float32:
        raise ValueError(f"K3 takes f32 gray, got {gray.dtype}")
    gray = gray.contiguous()
    coeffs = _coeffs_on(gray.device)
    _, _, strips, ctiles = srm_plan(b, h, w)
    partial = torch.empty((b, strips * ctiles, 8), dtype=torch.float64,
                          device=gray.device)
    out = torch.empty((b, 8), dtype=torch.float32, device=gray.device)
    _build.call("tpudf_srm_moments", gray, coeffs, partial,
                _zeroed_counts(b, gray.device), out, b, h, w)
    LAUNCHES.hit(KERNEL)
    return out


def srm_raw_moments(gray):
    """(B, H, W) → (B, 8) raw moments of the K2 then the K3 residual. CPU
    tensors take the plain twin; CUDA tensors launch K3 or raise."""
    if not gray.is_cuda:
        return srm_raw_moments_reference(gray)
    return _srm_cuda(gray)


def srm_features(gray, raw_moments=srm_raw_moments):
    """(B, H, W) → (B, 9): per-kernel residual mean, var and kurtosis
    (kurtosis = E[(x-m)^4] / (var+eps)^2, biased), from the raw moments."""
    moms = raw_moments(gray)
    feats = {}
    for i, base in ((0, 0), (2, 4)):
        m1, m2, m3, m4 = (moms[:, base + j] for j in range(4))
        v = torch.clamp(m2 - m1 * m1, min=0.0)
        mu4 = m4 - 4.0 * m3 * m1 + 6.0 * m2 * m1 * m1 - 3.0 * m1 ** 4
        k = mu4 / ((v + _EPS) ** 2)
        feats[i] = (m1, v, k)
    feats[1] = feats[0]                # K1 == K2 after normalization
    out = []
    for i in range(3):
        out += list(feats[i])
    return torch.stack(out, dim=-1)
