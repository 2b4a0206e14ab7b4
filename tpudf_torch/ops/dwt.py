"""Haar (db1) 2-D wavelet energies as reshape arithmetic (tpudf/ops/dwt.py,
the exact f32 reshape form; the TPU's separable-matmul form is not needed
off the TPU). Convention of pywt.dwt2; signs are energy-equivalent."""

from __future__ import annotations

import torch


def haar_dwt2(x):
    """x: (..., H, W) with even H, W → (cA, (cH, cV, cD)), each
    (..., H/2, W/2)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2)
    a = x[..., 0, :, 0]
    b = x[..., 0, :, 1]
    c = x[..., 1, :, 0]
    d = x[..., 1, :, 1]
    ca = (a + b + c + d) * 0.5
    ch = (c + d - a - b) * 0.5      # detail along rows (axis -2)
    cv = (b + d - a - c) * 0.5      # detail along cols (axis -1)
    cd = (a + d - b - c) * 0.5
    return ca, (ch, cv, cd)


def haar_energies_2level(x):
    """Mean |coeff|^2 of [cA1,cH1,cV1,cD1,cA2,cH2,cV2,cD2]: (..., H, W) →
    (..., 8)."""
    ca1, (ch1, cv1, cd1) = haar_dwt2(x)
    ca2, (ch2, cv2, cd2) = haar_dwt2(ca1)
    bands = [ca1, ch1, cv1, cd1, ca2, ch2, cv2, cd2]
    return torch.stack([torch.mean(b ** 2, dim=(-2, -1)) for b in bands],
                       dim=-1)
