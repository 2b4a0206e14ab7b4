"""Images, labels and masks made on the device from the seed.

An image is a smooth random field (a 6 x 6 grid of colours, resampled),
a coarser texture at 1/16 of the size and a little pixel noise, as uint8
NHWC: neighbouring patches are alike, as in photographs, so ToMe has
partners to merge. Every seed gives the same sizes and counts; only the
values differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 512          # images made per call (bounds the f32 scratch)


def images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 on `device`."""
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, CHUNK):
        b = min(CHUNK, n - i)
        base = torch.rand((b, 3, 6, 6), generator=gen, device=device)
        tex = torch.rand((b, 3, size // 16, size // 16), generator=gen,
                         device=device)
        noise = torch.randn((b, 3, size, size), generator=gen,
                            device=device)
        x = (0.6 * F.interpolate(base, size=(size, size), mode="bilinear",
                                 align_corners=False)
             + 0.3 * F.interpolate(tex, size=(size, size), mode="bilinear",
                                   align_corners=False)
             + 0.05 * noise + 0.05)
        out[i:i + b] = (x.clamp(0.0, 1.0) * 255.0).round().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out


def mtl_batch(gen: torch.Generator, batch: int, size: int, device) -> dict:
    """One MTL batch as the trainer takes it: SigLIP-normalised pixels in
    [-1, 1], 3-class labels (real, synthetic, tampered: a fixed third of
    each, in a seeded order) and a rectangle mask on each tampered image
    (has_mask 1), empty masks elsewhere."""
    px = images(gen, batch, size, device).float() / 127.5 - 1.0
    cls = torch.arange(batch, device=device) % 3
    cls = cls[torch.randperm(batch, generator=gen, device=device)]
    corners = torch.rand((batch, 4), generator=gen, device=device)
    lo = (corners[:, :2] * 0.6 * size).long()
    ext = ((0.15 + 0.3 * corners[:, 2:]) * size).long()
    ar = torch.arange(size, device=device)
    rows = (ar[None] >= lo[:, :1]) & (ar[None] < lo[:, :1] + ext[:, :1])
    cols = (ar[None] >= lo[:, 1:]) & (ar[None] < lo[:, 1:] + ext[:, 1:])
    tampered = cls == 2
    mask = (rows[:, :, None] & cols[:, None, :]
            & tampered[:, None, None]).float()
    return {"pixels": px, "cls": cls, "mask": mask,
            "has_mask": tampered.float()}
