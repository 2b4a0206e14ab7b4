"""Media loading guards and validation (tpudf/data/media.py: numpy and
PIL only, copied).

Re-implements the reference's input hardening (appv3.py:579-608, 5109-5136):
AVIF-capable decode ladder, EXIF transpose, megapixel cap, min/max side
enforcement with downscale, truncated-image tolerance, near-constant-image
rejection.
"""

from __future__ import annotations

import numpy as np

MAX_PIXELS = 300_000_000        # 300 MP cap (appv3.py:97-99)
MIN_SIDE = 64                   # appv3.py:572
MAX_SIDE = 2048                 # appv3.py:573


class MediaError(ValueError):
    """An input the app refuses: undecodable, too large or small, flat."""


def load_image_any(path: str, min_side=MIN_SIDE, max_side=MAX_SIDE):
    """Decode ladder: PIL (AVIF plugin if present) → imageio; EXIF
    transpose; side constraints → uint8 RGB array."""
    from PIL import Image, ImageFile, ImageOps
    ImageFile.LOAD_TRUNCATED_IMAGES = True      # appv3.py:97-99
    img = None
    try:
        img = Image.open(path)
        img.load()
    except Exception:
        try:
            import imageio.v3 as iio
            img = Image.fromarray(np.asarray(iio.imread(path)))
        except Exception as e:
            raise MediaError(f"cannot decode {path}: {e}")
    if img.width * img.height > MAX_PIXELS:
        raise MediaError(f"image too large: {img.size}")
    img = ImageOps.exif_transpose(img).convert("RGB")
    w, h = img.size
    if min(w, h) < min_side:
        raise MediaError(f"image too small: {img.size} (min side {min_side})")
    if max(w, h) > max_side:
        scale = max_side / max(w, h)
        img = img.resize((max(int(w * scale), 1), max(int(h * scale), 1)))
    return np.asarray(img, np.uint8)


def is_near_constant(arr_uint8, std_thresh=2.0) -> bool:
    """Reject flat/near-constant images (appv3.py:5109-5111)."""
    return float(np.asarray(arr_uint8, np.float32).std()) < std_thresh


def validate_image(arr_uint8):
    if is_near_constant(arr_uint8):
        raise MediaError("near-constant image rejected")
    return arr_uint8
