"""K3 (`csrc/srm.cu`, the SRM residual moments) on its strips, on the CPU:
a numpy model of the kernel's order, held against the port's twin and
JAX's reference and interpret runs. The model follows the kernel step by
step: `srm.srm_plan`'s tiles (strips of rows by runs of columns), each
tile's one-pixel halo (zeros outside the image), both residuals formed tap
by tap in f32 from the halo'd tile, each converted to f64 once and its four
powers accumulated there by each of 256 threads over its pixels (thread t:
the tile's columns t, t + 256, ..., each from its top row down), the
warp's sums reduced by xor shuffles (16, 8, 4, 2, 1), the block's
warps added in warp order into the tile's partial, and the image's
partials added in tile order. Tolerances are the twin's (PERF.md §6): rtol
1e-5 against the XLA reference (separable vs 9-tap sums), 2e-4 against
the Pallas kernel in interpret mode; the model and the twin's residuals
are the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudf.ops import srm as J_srm
from tpudf_torch.ops import srm

SHAPES = [(2, 256, 256), (3, 37, 61), (2, 257, 64)]


def _coeffs():
    return [srm._norm(srm._K2).ravel(), srm._norm(srm._K3).ravel()]


def _residuals(tile, nr, nc):
    """Both residuals of the tile's nr x nc pixels from its halo'd block
    (nr + 2, nc + 2), tap by tap in f32 as the kernel adds them: its taps
    (`srm.K2_TAPS`, `K3_TAPS`), the first product, then each sum."""
    out = []
    for k, taps in zip(_coeffs(), (srm.K2_TAPS, srm.K3_TAPS)):
        v = None
        for tap in taps:
            di, dj = divmod(tap, 3)
            m = (tile[di:di + nr, dj:dj + nc] * np.float32(k[tap])).astype(
                np.float32)
            v = m if v is None else (v + m).astype(np.float32)
        out.append(v)
    return out


def test_k3_taps_are_the_stencils_non_zero_taps():
    for k, taps in zip(_coeffs(), (srm.K2_TAPS, srm.K3_TAPS)):
        assert tuple(np.flatnonzero(k)) == taps


def _powers(v):
    """r, r^2, r^3, r^4 of the f32 residual, each in f64 from one
    conversion (the square exact)."""
    d = v.astype(np.float64)
    d2 = d * d
    return [d, d2, d2 * d, d2 * d2]


def k3_model(gray, threads=srm.SRM_THREADS):
    """(B, H, W) f32 -> (B, 8) f32 in the kernel's order."""
    b, h, w = gray.shape
    rows, cols, strips, ctiles = srm.srm_plan(b, h, w)
    padded = np.pad(gray, ((0, 0), (1, 1), (1, 1)))
    out = np.zeros((b, 8), np.float32)
    for i in range(b):
        partials = []
        for t in range(strips * ctiles):
            r0, c0 = t // ctiles * rows, t % ctiles * cols
            nr, nc = min(rows, h - r0), min(cols, w - c0)
            tile = padded[i, r0:r0 + nr + 2, c0:c0 + nc + 2]
            vals = [p for v in _residuals(tile, nr, nc) for p in _powers(v)]
            # thread t: columns t, t + 256, ..., each from its top row
            ncol = -(-nc // threads)
            grid = np.zeros((8, nr, ncol * threads), np.float64)
            grid[:, :, :nc] = np.stack(vals)
            order = grid.reshape(8, nr, ncol, threads).transpose(0, 2, 1, 3)
            acc = np.zeros((8, threads), np.float64)
            for step in order.reshape(8, ncol * nr, threads).transpose(
                    1, 0, 2):
                acc = acc + step
            lanes = acc.reshape(8, threads // 32, 32)
            for o in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[..., np.arange(32) ^ o]
            warps = lanes[..., 0]
            part = warps[:, 0]
            for wp in range(1, threads // 32):
                part = part + warps[:, wp]
            partials.append(part)
        s = np.zeros(8, np.float64)
        for part in partials:
            s = s + part
        out[i] = (s * (1.0 / (float(h) * w))).astype(np.float32)
    return out


def _gray(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_k3_model_matches_twin_and_jax(shape):
    gray = _gray(shape, sum(shape))
    got = k3_model(gray)
    twin = srm.srm_raw_moments(torch.from_numpy(gray)).numpy()
    ref = np.asarray(J_srm.srm_raw_moments(jnp.asarray(gray)))
    interp = np.asarray(J_srm.srm_raw_moments(jnp.asarray(gray),
                                              interpret=True))
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got, interp, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES + [(8, 256, 256), (256, 256, 256),
                                             (1, 5, 5000), (4, 3, 2)],
                         ids=str)
def test_k3_tiles_cover_each_pixel_once(shape):
    """The plan's tiles cover every pixel exactly once, their halo'd
    blocks fit the kernel's shared memory, and the B = 8 cores fill the
    card (at least 132 blocks)."""
    b, h, w = shape
    rows, cols, strips, ctiles = srm.srm_plan(b, h, w)
    seen = np.zeros((h, w), np.int32)
    for t in range(strips * ctiles):
        r0, c0 = t // ctiles * rows, t % ctiles * cols
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert (seen == 1).all()
    assert (rows + 2) * (cols + 2) * 4 <= srm.SRM_TILE_BYTES
    assert rows >= min(h, srm.SRM_MIN_ROWS) and cols <= srm.SRM_MAX_COLS
    if (b, h) == (8, 256):
        assert b * strips * ctiles >= 132


def test_k3_residuals_are_the_twins_bits():
    """The kernel's tap-by-tap residuals on a halo'd strip equal the twin's
    `_stencil3` bit for bit, so the strips change only the sums' order."""
    gray = _gray((1, 37, 61), 3)
    tile = np.pad(gray[0], 1)
    mine = _residuals(tile, 37, 61)
    twin = [srm._stencil3(torch.from_numpy(gray), k.reshape(3, 3))[0].numpy()
            for k in _coeffs()]
    for a, b in zip(mine, twin):
        np.testing.assert_array_equal(a, b)
