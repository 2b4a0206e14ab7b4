"""The image path's rendering score (tpudf/fuse/temporal.py
`render_scores_graph`), on tensors.

The rest of the JAX module (the video battery, `host_flow_signals`, the
aggregation) waits for the video slice.
"""

from __future__ import annotations

import torch

from tpudf_torch.data.pipeline import resize
from tpudf_torch.ops.flow import exposure_blur_regularity_batched
from tpudf_torch.ops.forensics import _gray


def render_scores_graph(pixels_uint8):
    """Batched image-path rendering score: each image and its horizontal
    flip as a two-frame clip (appv3.py:5128-5195), exposure continuity
    blended 55/45 with motion-blur regularity, batched over the images as
    JAX's vmap is. (B, H, W, 3) uint8 → (B,) in [0, 1], on the pixels'
    device."""
    gray = _gray(pixels_uint8.float() / 255.0)            # (B, H, W)
    b, h, wd = gray.shape
    if h % 16 or wd % 16 or h < 32 or wd < 32:
        gray = resize(gray, (b, 256, 256), "bilinear")
    pair = torch.stack([gray, torch.flip(gray, dims=(2,))], dim=1)
    exposure, blur = exposure_blur_regularity_batched(pair)
    return torch.clamp(0.55 * exposure + 0.45 * blur, 0.0, 1.0)
