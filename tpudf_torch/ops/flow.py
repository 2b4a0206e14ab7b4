"""Dense optical flow, the video battery's flow family and the
rendering-score core (tpudf/ops/flow.py), on tensors.

Coarse-to-fine pyramidal Lucas-Kanade, dense per pixel: 2x2 average-pool
levels, per level a bilinear warp by the upsampled flow, Scharr gradients,
window sums of the structure tensor, a closed-form 2x2 solve per pixel and
a few fixed refinement iterations. Everything is convolutions,
elementwise math and 4-point gathers over a (T, H, W) batch on its device
(`F.conv2d` in place of JAX's `reduce_window` / `conv_general_dilated`;
callers on the card run it inside `forensics.f32_math()`).

`flow_signals` computes the six flow-family signals of a clip with no
host round trip: every pair's forward and backward flow in one batched
`dense_flow`, the corner threshold as `jnp.quantile`'s linear
interpolation (`_quantile_linear`, a sort and two gathers: no tensor
argument for the host to check), the affine fit's 3 x 3 normal equations
by `torch.linalg.solve_ex` (no error check to sync on).
"""

from __future__ import annotations

import functools

import numpy as np
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


def _harris(gray, k: int = 2, kappa=0.04):
    gx, gy = _scharr(gray)
    sxx = _box_filter(gx * gx, k)
    sxy = _box_filter(gx * gy, k)
    syy = _box_filter(gy * gy, k)
    return sxx * syy - sxy * sxy - kappa * (sxx + syy) ** 2


@functools.lru_cache(maxsize=8)
def _affine_basis(h: int, w: int, device):
    """(H*W, 3) rows [x/w - 0.5, y/h - 0.5, 1] in raster order, made on
    `device` (no copy from the host)."""
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    xn = (xx / w - 0.5)[None, :].expand(h, w).reshape(-1)
    yn = (yy / h - 0.5)[:, None].expand(h, w).reshape(-1)
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=1)


def _affine_fit_residual(u, v, thresh=1.0):
    """Per-frame global affine motion fit by least squares + one IRLS
    reweight; returns the outlier fraction (residual > thresh px), (T,).

    Solves flow(x,y) ≈ A @ [x, y, 1] jointly for (u, v): the dense-inlier
    stand-in for cv2.estimateAffinePartial2D+RANSAC (appv3.py:4247-4304)."""
    t, h, w = u.shape
    basis = _affine_basis(h, w, u.device)                      # (P, 3)
    uf = u.reshape(t, -1)
    vf = v.reshape(t, -1)
    eye = 1e-4 * torch.eye(3, device=u.device)

    def solve(wgt):
        # normal equations per frame: (3, 3) @ (3, 2), batched
        bw = basis[None] * wgt[..., None]                       # (T, P, 3)
        g = torch.einsum("tpi,pj->tij", bw, basis) + eye
        c = torch.stack([torch.einsum("tpi,tp->ti", bw, uf),
                         torch.einsum("tpi,tp->ti", bw, vf)], dim=-1)
        coef = torch.linalg.solve_ex(g, c)[0]                   # (T, 3, 2)
        ru = uf - torch.einsum("pi,ti->tp", basis, coef[..., 0])
        rv = vf - torch.einsum("pi,ti->tp", basis, coef[..., 1])
        return torch.sqrt(ru * ru + rv * rv)

    r = solve(torch.ones_like(uf))
    wgt = 1.0 / (1.0 + (r / max(thresh, 1e-6)) ** 2)           # IRLS step
    r = solve(wgt)
    return torch.mean((r > thresh).float(), dim=1)


def _quantile_linear(x, q: float):
    """jnp.quantile(x, q, axis=-1) (method "linear") for x (T, N) without
    NaNs: the rank q (N - 1), its floor and ceiling and both weights in
    f32 as JAX forms them, then low * w_low + high * w_high."""
    f32 = np.float32
    n = x.shape[-1]
    pos = f32(q) * f32(n - 1)
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    w_high = f32(pos - f32(low))
    w_low = f32(f32(1.0) - w_high)
    srt = torch.sort(x, dim=-1).values
    return srt[..., low] * float(w_low) + srt[..., high] * float(w_high)


def flow_fields(gray, *, levels: int = 4):
    """(T, H, W) grayscale [0,1] → (a, b, u, v, ub, vb): the [0, 255]
    frames a = 0..T-2 and b = 1..T-1, the forward flow a→b and the
    backward flow b→a, each (T-1, H, W). The T-1 forward and T-1 backward
    pairs run as one batch of 2(T-1) flows."""
    g = gray * 255.0
    a, b = g[:-1], g[1:]
    n = a.shape[0]
    uu, vv = dense_flow(torch.cat([a, b]), torch.cat([b, a]), levels=levels)
    return a, b, uu[:n], vv[:n], uu[n:], vv[n:]


def flow_signals(gray, *, levels: int = 4):
    """(T, H, W) grayscale [0,1] (T >= 3) → dict of 0-d flow signals
    (appv3.py:3862-4304 via fuse/temporal.py), on gray's device.
    parallax_err is NaN when no pair moves (the gate the reference
    applies)."""
    return flow_signals_from(*flow_fields(gray, levels=levels))


def flow_signals_from(a, b, u, v, ub, vb):
    """The six flow signals of `flow_fields`' output: thresholds, masks
    and means over the fields."""
    n = a.shape[0]
    mag = torch.sqrt(u * u + v * v)
    fb = torch.sqrt((u + ub) ** 2 + (v + vb) ** 2)
    fb_mean = torch.mean(fb)

    # direction incoherence over moving pixels (std of sin + std of cos)/2
    moving = (mag > 0.5).float()
    frac = torch.mean(moving)
    msum = torch.sum(moving) + 1e-6
    ang = torch.atan2(v, u)

    def mstd(x):
        mu = torch.sum(x * moving) / msum
        return torch.sqrt(torch.sum(moving * (x - mu) ** 2) / msum)

    dir_inc = torch.where(frac > 0.01,
                          0.5 * (mstd(torch.sin(ang)) + mstd(torch.cos(ang))),
                          0.0)

    # reprojection error: a warped by the forward flow against b (motion
    # convention: sample a at x - flow)
    reproj = torch.mean(torch.abs(_warp_bilinear(a, -u, -v) - b))

    # parallax: local flow-magnitude roughness / magnitude, normalized and
    # gated per frame pair as the host battery does
    local_mu = _box_mean(mag, 7)
    local_var = _box_mean((mag - local_mu) ** 2, 7)
    pair_mag = torch.mean(mag, dim=(1, 2))
    pair_rough = torch.mean(torch.sqrt(torch.clamp(local_var, min=0.0)),
                            dim=(1, 2))
    moving_pair = (pair_mag > 0.2).float()
    n_moving = torch.sum(moving_pair)
    ratios = pair_rough / (pair_mag + 1e-6)
    par = torch.where(n_moving > 0,
                      torch.sum(ratios * moving_pair)
                      / torch.clamp(n_moving, min=1.0), float("nan"))

    # KLT-style instability: fb failure rate at corner pixels
    resp = _harris(a)
    thr = _quantile_linear(resp.reshape(n, -1), 0.98)
    corners = (resp > thr[:, None, None]).float()
    csum = torch.sum(corners) + 1e-6
    klt = torch.sum((fb > 2.0).float() * corners) / csum

    affine_out = torch.mean(_affine_fit_residual(u, v))

    return {
        "flow_fb_inconsistency": torch.clamp(fb_mean / 4.0, 0.0, 1.0),
        "flow_dir_incoherence": torch.clamp(dir_inc, 0.0, 1.0),
        "flow_reprojection": torch.clamp(reproj / 20.0, 0.0, 1.0),
        "parallax_err": torch.clamp(par / 1.5, 0.0, 1.0),   # nan if static
        "klt_instability": torch.clamp(klt / 0.5, 0.0, 1.0),
        "affine_inconsistency": torch.clamp(affine_out / 0.6, 0.0, 1.0),
    }


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
