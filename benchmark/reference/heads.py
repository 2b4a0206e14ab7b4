"""The detect core's heads in f32: the v5 binary head, the 24-d
frequency vector (FFT bands, spectral slope, sector anisotropy, phase
entropy; Haar energies; SRM residual moments), the frequency MLP, the
Linear(2 → 1) fusion and CORAL's ordinal calibration with its blend."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import gelu_exact, layer_norm

EPS = 1e-6
GRAY = (0.299, 0.587, 0.114)
CORAL_PROBS = (0.32, 0.47, 0.61, 0.75)      # the default cutpoints


def binary_head(p, f, prec):
    """pooled (B, W) → (B,) logits: L2 norm, SE gate, LN, GELU MLP."""
    r = prec.highp
    f = r(f / (f.norm(dim=-1, keepdim=True) + 1e-6))
    se = torch.relu(f @ p["se"]["fc1"]["w"] + p["se"]["fc1"]["b"])
    se = torch.sigmoid(r(se) @ p["se"]["fc2"]["w"] + p["se"]["fc2"]["b"])
    x = layer_norm(f * se, p["ln"], 1e-5)
    x = gelu_exact(r(x) @ p["fc1"]["w"] + p["fc1"]["b"])
    x = gelu_exact(r(x) @ p["fc2"]["w"] + p["fc2"]["b"])
    return (r(x) @ p["fc3"]["w"] + p["fc3"]["b"])[:, 0]


def _masks(h, w, device):
    """Band (r <= .15, .45 of the largest radius) and 8-sector masks, the
    39 log-radius bins, and the slope's least-squares weights."""
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rad = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    rmax = rad.max()
    bands = np.stack([rad <= 0.15 * rmax,
                      (rad > 0.15 * rmax) & (rad <= 0.45 * rmax),
                      rad > 0.45 * rmax], -1).reshape(-1, 3)
    ang = np.arctan2(yy - cy, xx - cx)
    sect = np.stack([(ang >= a0) & (ang < a0 + math.pi / 4) for a0 in
                     np.linspace(-math.pi, math.pi, 8, endpoint=False)],
                    -1).reshape(-1, 8)
    edges = np.logspace(0.0, np.log10(rmax + 1.0), 40)
    idx = np.searchsorted(edges, (rad + 1.0).ravel(), side="left") - 1
    bins = np.zeros((h * w, 39))
    ok = (idx >= 0) & (idx < 39)
    bins[np.arange(h * w)[ok], idx[ok]] = 1.0
    xs = np.arange(39.0) - 19.0
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return (t(bands), t(sect), t(bins), t(xs / (xs ** 2).sum()))


def _haar(x):
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return ((a + b + c + d) / 2, (c + d - a - b) / 2, (b + d - a - c) / 2,
            (a + d - b - c) / 2)


def _srm(gray):
    """Mean, variance and kurtosis of the two distinct SRM residuals (the
    5x5 and 3x3 second-order kernels normalise to one 3x3 stencil; then
    the 4-neighbour Laplacian), zero padding: 9 numbers, the first
    kernel's three repeated."""
    k2 = torch.tensor([[-1, 2, -1], [2, -4, 2], [-1, 2, -1]],
                      dtype=torch.float32) / (16 + EPS)
    k3 = torch.tensor([[0, -1, 0], [-1, 4, -1], [0, -1, 0]],
                      dtype=torch.float32) / (8 + EPS)
    out = []
    for k in (k2, k3):
        r = F.conv2d(gray[:, None], k[None, None].to(gray.device),
                     padding=1).flatten(1).double()
        m1 = r.mean(1)
        var = ((r - m1[:, None]) ** 2).mean(1)
        mu4 = ((r - m1[:, None]) ** 4).mean(1)
        out.append(torch.stack([m1, var, mu4 / (var + EPS) ** 2], -1))
    return torch.cat([out[0], out[0], out[1]], -1).float()


def freq_vector(gray):
    """(B, H, W) gray in [0, 1] → (B, 24) standardised features."""
    b, h, w = gray.shape
    bands, sect, bins, slope_w = _masks(h, w, gray.device)
    f = torch.fft.fftshift(torch.fft.fft2(gray), dim=(-2, -1))
    mag = f.abs().reshape(b, -1)
    e = mag @ bands
    total = e.sum(-1) + EPS
    sm = (mag @ sect) / sect.sum(0).clamp(min=1.0)
    aniso = sm.var(-1, unbiased=False)
    cnt = bins.sum(0)
    mu = torch.where(cnt > 0, (torch.log(mag + EPS) @ bins)
                     / cnt.clamp(min=1.0), torch.zeros_like(cnt))
    slope = mu @ slope_w
    phase = torch.angle(f).reshape(b, -1)
    idx = torch.floor((phase + math.pi) * (50 / (2 * math.pi)))
    hist = torch.zeros((b, 50), device=gray.device).scatter_add_(
        1, idx.clamp(0, 49).long(), torch.ones_like(phase))
    prob = hist / (hist.sum(-1, keepdim=True) + EPS)
    entropy = -(prob * torch.log(prob + EPS)).sum(-1)
    ca1, ch1, cv1, cd1 = _haar(gray)
    ca2, ch2, cv2, cd2 = _haar(ca1)
    haar = torch.stack([(c ** 2).mean((-2, -1)) for c in
                        (ca1, ch1, cv1, cd1, ca2, ch2, cv2, cd2)], -1)
    v = torch.cat([torch.stack([e[:, 0] / total, e[:, 1] / total,
                                e[:, 2] / total,
                                (e[:, 2] + EPS) / (e[:, 0] + EPS), slope,
                                aniso, entropy], -1), haar, _srm(gray)], -1)
    std = v.std(-1, keepdim=True)
    return torch.where(std < EPS, torch.zeros_like(v),
                       (v - v.mean(-1, keepdim=True)) / (std + EPS))


def freq_mlp(p, v, prec):
    r = prec.highp
    x = layer_norm(r(v), p["ln"], 1e-5)
    x = gelu_exact(r(x) @ p["fc1"]["w"] + p["fc1"]["b"])
    return (r(x) @ p["fc2"]["w"] + p["fc2"]["b"])[:, 0]


def coral(z):
    """The fused logit → {"p_blend", "risk_probs", "p_fake_raw",
    "p_fake_coral", "entropy"}: 5 ordinal classes from the default
    cutpoints, 0.7 · sigmoid + 0.3 · the ordinal mean and variance."""
    cuts = torch.tensor([math.log(p / (1 - p)) for p in CORAL_PROBS],
                        device=z.device)
    g = torch.sigmoid(z[:, None] - cuts)
    rp = torch.cat([1 - g[:, :1], g[:, :-1] - g[:, 1:], g[:, -1:]], -1)
    rp = rp / (rp.sum(-1, keepdim=True) + 1e-8)
    k = torch.arange(5.0, device=z.device)
    mu = (k * rp).sum(-1)
    var = (rp * (k - mu[:, None]) ** 2).sum(-1)
    p_gauss = torch.clamp(mu / 4 + 0.5 * var, 0.0, 1.0)
    p_raw = torch.sigmoid(z)
    return {"p_blend": torch.clamp(0.7 * p_raw + 0.3 * p_gauss, 0.0, 1.0),
            "risk_probs": rp, "p_fake_raw": p_raw, "p_fake_coral": p_gauss,
            "entropy": -(rp * torch.log(rp + 1e-8)).sum(-1)}


def fuse(p, p_sig, p_freq):
    """The Linear(2 → 1) fusion of two probabilities → logit."""
    return (torch.stack([p_sig, p_freq], -1) @ p["w"] + p["b"])[:, 0]
