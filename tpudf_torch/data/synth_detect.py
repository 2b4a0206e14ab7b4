"""Procedural real-vs-fake image generator (tpudf/data/synth_detect.py,
numpy only, the same draws in the same order) for deployed-geometry
certification (zero-egress stand-in for CiFake/SID data — BASELINE.md
pins the real-data quality targets; docs/CERTIFICATION.md §0 explains why
they cannot be measured here).

The discrimination task is designed to be TOKEN-LEVEL and NON-TRIVIAL so
that it can actually be destroyed by the deployed speed modes if they are
too aggressive (the point of the end-task gate — VERDICT r4 weak #3):

  REAL  = smooth multi-sine shading + color gradient + film grain.
  FAKE  = the SAME base family plus one subtle generator-style artifact,
          chosen per image:
            grid     localized low-amplitude periodic texture (period
                     4-12 px) inside a random sub-region — only a few of
                     the 16x16 patch tokens carry the cue, so merging
                     those tokens away loses the signal;
            blocky   a random region replaced by its 2x-downsampled
                     nearest-upsampled self (upsampler blockiness);
            checker  global checkerboard at half amplitude.
          Grain noise is kept IDENTICAL between classes so no global
          first-order statistic separates them.

Unlike the tests' 64px fixtures (tests/test_train_infer_e2e.py), this
generator targets real tower geometry (256px+) and calibrated difficulty:
`artifact_amp` tunes the float-feature AUC into a measurable band
(~0.9-0.98) so a 0.02 AUC degradation is observable, not saturated away.
"""

from __future__ import annotations

import numpy as np


def _base(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth 'natural' base image (size, size, 3) in [0,1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / float(size)
    img = np.full((size, size, 3), 0.5, np.float32)
    for _ in range(rng.integers(2, 4)):
        a, b = rng.uniform(1.5, 7.0, 2).astype(np.float32)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.16)
        col = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        img += amp * np.sin(a * yy + b * xx + ph)[..., None] * col
    # slow color gradient
    g = rng.uniform(-0.08, 0.08, 3).astype(np.float32)
    img += (yy[..., None] - 0.5) * g
    return img


def _add_grain(rng, img, sigma):
    return img + sigma * rng.standard_normal(img.shape).astype(np.float32)


def _fake_artifact(rng: np.random.Generator, img: np.ndarray,
                   amp: float) -> np.ndarray:
    size = img.shape[0]
    kind = rng.integers(0, 3)
    if kind == 0:  # localized periodic grid
        side = int(rng.integers(size // 4, size // 2))
        y0 = int(rng.integers(0, size - side))
        x0 = int(rng.integers(0, size - side))
        p = float(rng.choice([4, 6, 8, 12]))
        yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
        tex = np.sign(np.sin(2 * np.pi * xx / p) *
                      np.cos(2 * np.pi * yy / p)).astype(np.float32)
        img = img.copy()
        img[y0:y0 + side, x0:x0 + side] += amp * tex[..., None]
    elif kind == 1:  # nearest-upsample blockiness in a region
        side = int(rng.integers(size // 3, size // 2)) // 2 * 2
        y0 = int(rng.integers(0, size - side))
        x0 = int(rng.integers(0, size - side))
        img = img.copy()
        reg = img[y0:y0 + side, x0:x0 + side]
        low = reg.reshape(side // 2, 2, side // 2, 2, 3).mean((1, 3))
        img[y0:y0 + side, x0:x0 + side] = np.repeat(
            np.repeat(low, 2, 0), 2, 1)
    else:  # global faint checkerboard
        yy, xx = np.mgrid[0:size, 0:size]
        tex = np.where((yy + xx) % 2 == 0, 1.0, -1.0).astype(np.float32)
        img = img + (amp * 0.5) * tex[..., None]
    return img


def make_detect_batch(n_per_class: int, size: int, seed: int = 0,
                      artifact_amp: float = 0.03,
                      grain: float = 0.035):
    """Returns (images uint8 (2N, size, size, 3), labels f32 (2N,)) with
    REAL first (label 0) then FAKE (label 1), deterministically seeded."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for cls in (0, 1):
        for _ in range(n_per_class):
            img = _base(rng, size)
            if cls == 1:
                img = _fake_artifact(rng, img, artifact_amp)
            img = _add_grain(rng, img, grain)
            imgs.append(np.clip(img, 0.0, 1.0))
            labels.append(float(cls))
    arr = (np.stack(imgs) * 255.0).round().astype(np.uint8)
    return arr, np.asarray(labels, np.float32)
