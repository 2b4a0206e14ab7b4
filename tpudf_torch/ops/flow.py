"""Dense optical flow and the rendering-score core (tpudf/ops/flow.py), on
tensors: the part the image report needs.

Coarse-to-fine pyramidal Lucas-Kanade, dense per pixel: 2x2 average-pool
levels, per level a bilinear warp by the upsampled flow, Scharr gradients,
window sums of the structure tensor, a closed-form 2x2 solve per pixel and
a few fixed refinement iterations. Everything is convolutions,
elementwise math and 4-point gathers over a (T, H, W) batch on its device
(`F.conv2d` in place of JAX's `reduce_window` / `conv_general_dilated`;
callers on the card run it inside `forensics.f32_math()`).

`flow_signals`, `_harris` and `_affine_fit_residual` (the video battery)
are not ported yet.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpudf_torch.data.pipeline import resize


def _avg_pool2(x):
    """(T, H, W) → (T, H/2, W/2) 2x2 mean."""
    t, h, w = x.shape
    return x.reshape(t, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


@functools.lru_cache(maxsize=16)
def _ones(win: int, device):
    return torch.ones((1, 1, win, win), device=device)


def _box_filter(x, k: int):
    """Box SUM over a (2k+1)^2 window, same zero padding. (T, H, W)."""
    return F.conv2d(x[:, None], _ones(2 * k + 1, x.device), padding=k)[:, 0]


def _box_mean(x, k: int):
    """Box MEAN with the true per-pixel window count (the zero padding
    shrinks the window at the borders)."""
    cnt = _box_filter(torch.ones_like(x), k)
    return _box_filter(x, k) / cnt


@functools.lru_cache(maxsize=4)
def _scharr_kernels(device):
    kx = torch.tensor([[-3., 0., 3.], [-10., 0., 10.], [-3., 0., 3.]]) / 32.0
    return kx.to(device)[None, None], kx.T.contiguous().to(device)[None, None]


def _scharr(x):
    """(T, H, W) → (gx, gy) Scharr gradients (units: intensity/px), edge
    padding."""
    kx, ky = _scharr_kernels(x.device)
    pad = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")
    return F.conv2d(pad, kx)[:, 0], F.conv2d(pad, ky)[:, 0]


def _warp_bilinear(img, u, v):
    """Sample img (T, H, W) at (x+u, y+v) with border clamp."""
    t, h, w = img.shape
    yy = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    x = torch.clamp(xx[None] + u, 0.0, w - 1.001)
    y = torch.clamp(yy[None] + v, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(t, -1)

    def gather(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(t, -1)
                            ).reshape(t, h, w)

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def _lk_refine(a, b, u, v, k: int, iters: int, eps=1e-4):
    """Fixed LK iterations at one pyramid level: gradients averaged between
    the warped source and the target, and a 5x5 mean smoothing of the flow
    after every update (the JAX module's robustness choices)."""
    gxb, gyb = _scharr(b)
    for _ in range(iters):
        aw = _warp_bilinear(a, u, v)
        gxa, gya = _scharr(aw)
        gx = 0.5 * (gxa + gxb)
        gy = 0.5 * (gya + gyb)
        it = b - aw
        sxx = _box_filter(gx * gx, k)
        sxy = _box_filter(gx * gy, k)
        syy = _box_filter(gy * gy, k)
        sxt = _box_filter(gx * it, k)
        syt = _box_filter(gy * it, k)
        det = sxx * syy - sxy * sxy
        inv_det = torch.where(det > eps, 1.0 / torch.clamp(det, min=eps), 0.0)
        du = (syy * sxt - sxy * syt) * inv_det
        dv = (sxx * syt - sxy * sxt) * inv_det
        # clamp per-iteration update for stability at strong warps
        u = u + torch.clamp(du, -4.0, 4.0)
        v = v + torch.clamp(dv, -4.0, 4.0)
        u = _box_mean(u, 2)
        v = _box_mean(v, 2)
    return u, v


def dense_flow(a, b, *, levels: int = 4, k: int = 7, iters: int = 3):
    """Dense flow a→b for (T, H, W) float [0, 255]-scale grayscale pairs.
    Returns (u, v) each (T, H, W) in pixels, MOTION convention (content at
    x in `a` appears at x + flow in `b`). H, W divisible by 2**levels."""
    pyr_a, pyr_b = [a], [b]
    for _ in range(levels - 1):
        pyr_a.append(_avg_pool2(pyr_a[-1]))
        pyr_b.append(_avg_pool2(pyr_b[-1]))
    t = a.shape[0]
    u = torch.zeros_like(pyr_a[-1])
    v = torch.zeros_like(pyr_a[-1])
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            th, tw = pyr_a[lvl].shape[1:]
            u = resize(u, (t, th, tw), "bilinear") * 2.0
            v = resize(v, (t, th, tw), "bilinear") * 2.0
        # smaller window at the coarsest levels (few pixels)
        kl = max(2, min(k, pyr_a[lvl].shape[1] // 8))
        u, v = _lk_refine(pyr_a[lvl], pyr_b[lvl], u, v, kl, iters)
    # internal math solves the SAMPLING offset a(x+u)=b(x); motion = -u
    return -u, -v


def exposure_blur_regularity_batched(gray, *, levels: int = 4):
    """`exposure_blur_regularity` over N clips at once: gray (N, T, H, W)
    [0,1] → (exposure (N,), blur (N,)), each clip's sums its own (JAX's
    vmap of the single-clip function)."""
    n, t, h, w = gray.shape
    g255 = torch.clamp(gray * 255.0, 0.0, 255.0)
    idx = torch.clamp((g255 / 4.0).to(torch.int64), 0, 63).reshape(n, t, -1)
    hist = torch.zeros((n, t, 64), device=gray.device).scatter_add_(
        -1, idx, torch.ones_like(idx, dtype=torch.float32))
    # cv2.normalize(hist, hist) default is L2; compareHist(BHATTACHARYYA)
    # then renormalizes by sums — net effect matches sum-normalized BC
    p = hist / (torch.sum(hist, dim=-1, keepdim=True) + 1e-6)
    bc = torch.sum(torch.sqrt(p[:, :-1] * p[:, 1:] + 1e-12), dim=-1)
    diffs = torch.sqrt(torch.clamp(1.0 - bc, 0.0, 1.0))
    exposure = 1.0 - torch.mean(diffs, dim=1)

    a = g255[:, :-1].reshape(-1, h, w)
    b = g255[:, 1:].reshape(-1, h, w)
    u, vflow = dense_flow(a, b, levels=levels)
    mag = torch.sqrt(u * u + vflow * vflow).reshape(n, t - 1, h, w)
    edges = (sobel_mag_255(b) > 100.0).float().reshape(n, t - 1, h, w)
    dims = (1, 2, 3)
    esum = torch.sum(edges, dim=dims)
    mu = torch.sum(mag * edges, dim=dims) / (esum + 1e-6)
    var = torch.sum(edges * (mag - mu[:, None, None, None]) ** 2,
                    dim=dims) / (esum + 1e-6)
    blur = torch.where(esum > 50.0, torch.exp(-var), 0.0)
    return exposure, blur


def exposure_blur_regularity(gray, *, levels: int = 4):
    """Rendering-pipeline score core of one clip (appv3.py:2525-2566
    re-derived): exposure continuity = 1 - mean Bhattacharyya distance
    between consecutive 64-bin intensity histograms; blur regularity =
    exp(-var(flow magnitude at edge pixels)). gray (T, H, W) [0,1] →
    (exposure, blur), 0-d tensors."""
    exposure, blur = exposure_blur_regularity_batched(gray[None],
                                                      levels=levels)
    return exposure[0], blur[0]


def sobel_mag_255(g255):
    from tpudf_torch.ops.forensics import sobel_mag
    return sobel_mag(g255)
