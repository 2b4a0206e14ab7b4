"""Face detection, crops and the face retouch score (tpudf/serve/face.py):
the part the image report needs.

Detection is cv2's Haar cascade on the host (the cascade ships inside
cv2); the retouch score runs the forensic cues on tensors. Landmarks,
identity embeddings and the temporal face signals wait for the video
slice.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.ops.forensics import (_gray, _var, f32_math, laplacian,
                                       perlin_diffusion_score)


def _cascade():
    try:
        import cv2
        path = cv2.data.haarcascades + "haarcascade_frontalface_default.xml"
        c = cv2.CascadeClassifier(path)
        return c if not c.empty() else None
    except Exception:
        return None


def detect_faces(image_rgb_uint8, min_size=48):
    """(H, W, 3) uint8 → list of (x, y, w, h) boxes."""
    c = _cascade()
    if c is None:
        return []
    import cv2
    gray = cv2.cvtColor(image_rgb_uint8, cv2.COLOR_RGB2GRAY)
    boxes = c.detectMultiScale(gray, scaleFactor=1.1, minNeighbors=5,
                               minSize=(min_size, min_size))
    return [tuple(int(v) for v in b) for b in boxes]


def face_crop(image_rgb_uint8, margin=0.25, out_size=None):
    """Largest-face square crop with margin; None if no face."""
    boxes = detect_faces(image_rgb_uint8)
    if not boxes:
        return None
    return _crop_from_box(image_rgb_uint8,
                          max(boxes, key=lambda b: b[2] * b[3]),
                          margin=margin, out_size=out_size)


def _crop_from_box(image_rgb_uint8, box, margin=0.25, out_size=None):
    """Square crop with margin around an already-detected (x, y, w, h)."""
    x, y, w, h = box
    cx, cy = x + w / 2, y + h / 2
    s = max(w, h) * (1 + 2 * margin)
    H, W = image_rgb_uint8.shape[:2]
    x0 = int(np.clip(cx - s / 2, 0, W - 1))
    y0 = int(np.clip(cy - s / 2, 0, H - 1))
    x1 = int(np.clip(cx + s / 2, x0 + 1, W))
    y1 = int(np.clip(cy + s / 2, y0 + 1, H))
    crop = image_rgb_uint8[y0:y1, x0:x1]
    if out_size is not None:
        from PIL import Image
        crop = np.asarray(Image.fromarray(crop).resize(
            (out_size, out_size), Image.BICUBIC))
    return crop


def retouch_scores(crops_uint8):
    """0.5·perlin + 0.5·HF-flatness (appv3.py:2496-2503) of (N, H, W, 3)
    uint8 crops on their device → (N,): the report's batched retouch
    score (tpudf/serve/report.py `_retouch_graph`)."""
    with f32_math():
        x = crops_uint8.float() / 255.0
        perlin = perlin_diffusion_score(x)
        hf = _var(laplacian(_gray(x) * 255.0), (1, 2))
    return 0.5 * perlin + 0.5 * torch.clamp(1.0 - hf / 200.0, 0.0, 1.0)


def face_region_retouch_score(face_rgb_uint8):
    """The retouch score of one (H, W, 3) uint8 face crop, as a float."""
    x = torch.as_tensor(np.ascontiguousarray(face_rgb_uint8))[None]
    return float(retouch_scores(x)[0])
