"""Procedural synthetic-face generator (tpudf/data/synth_faces.py, numpy
only, the same draws in the same order): pretraining data for the 5-point
landmark network and the identity embedding (models/face_landmark.py,
models/face_embed.py) and fixtures for the face-drift tests.

The environment has no egress, so the insightface/ArcFace stack the
reference loads from the network (appv3.py:67-90) cannot be downloaded.
Instead the face nets are pretrained on procedurally generated faces —
parameterized ellipse heads with eyes/brows/nose/mouth under randomized
identity geometry, pose, lighting, background and noise. An `identity`
(geometry + color parameter bundle) can be held fixed across frames or
swapped mid-clip, which is exactly the fixture the face-swap drift signals
are validated on.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FaceIdentity:
    """Geometry + appearance parameters that define one synthetic person."""
    eye_dx: float          # half inter-ocular distance / face width
    eye_y: float           # eye row position within face (0 top, 1 bottom)
    eye_r: float           # eye radius / face width
    nose_y: float
    mouth_y: float
    mouth_w: float         # mouth half-width / face width
    face_aspect: float     # height / width of the head ellipse
    skin: np.ndarray       # (3,) RGB 0-1
    lip: np.ndarray        # (3,)
    eye_dark: float        # iris darkness 0-1


def random_identity(rng) -> FaceIdentity:
    return FaceIdentity(
        eye_dx=rng.uniform(0.22, 0.34),
        eye_y=rng.uniform(0.36, 0.46),
        eye_r=rng.uniform(0.05, 0.09),
        nose_y=rng.uniform(0.56, 0.64),
        mouth_y=rng.uniform(0.72, 0.80),
        mouth_w=rng.uniform(0.16, 0.28),
        face_aspect=rng.uniform(1.15, 1.45),
        skin=np.asarray([rng.uniform(0.55, 0.9), rng.uniform(0.4, 0.75),
                         rng.uniform(0.3, 0.65)]),
        lip=np.asarray([rng.uniform(0.5, 0.85), rng.uniform(0.15, 0.4),
                        rng.uniform(0.15, 0.4)]),
        eye_dark=rng.uniform(0.05, 0.35),
    )


def render_face(size: int, ident: FaceIdentity, rng, *,
                center=None, scale=None, angle=None):
    """Render one face. Returns (image01 (S,S,3), landmarks (5,2) in [0,1]
    normalized (x, y), box (4,) normalized (cx, cy, w, h)).

    Landmark order matches insightface's 5-pt convention: left eye, right
    eye, nose tip, left mouth corner, right mouth corner.
    """
    if center is None:
        center = rng.uniform(0.35, 0.65, 2)              # (cx, cy)
    if scale is None:
        scale = rng.uniform(0.22, 0.38)                  # face half-width
    if angle is None:
        angle = rng.uniform(-0.25, 0.25)                 # radians

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cx, cy = float(center[0]), float(center[1])
    ca, sa = np.cos(angle), np.sin(angle)
    # face-local coords: u across, v down, both in units of face half-width
    u = ((xx - cx) * ca + (yy - cy) * sa) / scale
    v = (-(xx - cx) * sa + (yy - cy) * ca) / scale

    bg = rng.uniform(0.1, 0.9, 3)[None, None, :] \
        + rng.normal(0, 0.04, (size, size, 3))
    img = np.clip(bg, 0, 1)

    asp = ident.face_aspect
    head = (u ** 2 + (v / asp) ** 2) <= 1.0
    shade = 1.0 - 0.25 * np.clip(v / asp, -1, 1)         # simple lighting
    img[head] = np.clip(ident.skin[None, :] * shade[head][:, None]
                        + rng.normal(0, 0.02, (head.sum(), 3)), 0, 1)

    def local(pu, pv):
        """face-local → normalized image coords."""
        x = cx + (pu * ca - pv * sa) * scale
        y = cy + (pu * sa + pv * ca) * scale
        return np.asarray([x, y], np.float32)

    # feature positions in face-local units
    ey = (ident.eye_y * 2 - 1) * asp
    ny = (ident.nose_y * 2 - 1) * asp
    my = (ident.mouth_y * 2 - 1) * asp
    le = (-ident.eye_dx * 2, ey)
    re = (ident.eye_dx * 2, ey)
    lm = (-ident.mouth_w * 2, my)
    rm = (ident.mouth_w * 2, my)

    def disk(pu, pv, r, color):
        d = ((u - pu) ** 2 + (v - pv) ** 2) <= r ** 2
        img[d & head] = color

    er = ident.eye_r * 2
    disk(le[0], le[1], er * 1.6, np.asarray([0.95, 0.95, 0.95]))  # sclera
    disk(re[0], re[1], er * 1.6, np.asarray([0.95, 0.95, 0.95]))
    disk(le[0], le[1], er, np.full(3, ident.eye_dark))            # iris
    disk(re[0], re[1], er, np.full(3, ident.eye_dark))
    # brows
    brow = (np.abs(v - (ey - er * 3.2)) < er * 0.7) & (np.abs(u) > 0.12) \
        & (np.abs(u) < 0.78)
    img[brow & head] = ident.skin * 0.35
    # nose: small darker wedge
    nosem = (np.abs(u) < 0.10) & (v > ey + er) & (v < ny)
    img[nosem & head] = np.clip(ident.skin * 0.8, 0, 1)
    # mouth: ellipse between corners
    mw = ident.mouth_w * 2
    mouth = ((u / mw) ** 2 + ((v - my) / (er * 1.2)) ** 2) <= 1.0
    img[mouth & head] = ident.lip

    img = np.clip(img + rng.normal(0, rng.uniform(0.005, 0.03),
                                   img.shape), 0, 1)

    lms = np.stack([local(*le), local(*re), local(0.0, ny),
                    local(*lm), local(*rm)])
    box = np.asarray([cx, cy, 2 * scale, 2 * scale * asp], np.float32)
    return img.astype(np.float32), lms, box


def render_background(size: int, rng):
    """Face-free negative sample (textured background)."""
    img = rng.uniform(0.05, 0.95, 3)[None, None, :] \
        + rng.normal(0, 0.12, (size, size, 3))
    if rng.random() < 0.5:  # distractor blob that is NOT a face
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        c = rng.uniform(0.3, 0.7, 2)
        r = rng.uniform(0.1, 0.3)
        m = ((xx - c[0]) ** 2 + (yy - c[1]) ** 2) <= r ** 2
        img[m] = rng.uniform(0.2, 0.9, 3)
    return np.clip(img, 0, 1).astype(np.float32)


def make_batch(rng, batch: int, size: int, p_face=0.8):
    """Training batch: (images (B,S,S,3), presence (B,), landmarks (B,5,2),
    boxes (B,4)). Landmarks/boxes are zeros for background samples."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    pres = np.zeros((batch,), np.float32)
    lms = np.zeros((batch, 5, 2), np.float32)
    boxes = np.zeros((batch, 4), np.float32)
    for i in range(batch):
        if rng.random() < p_face:
            img, lm, box = render_face(size, random_identity(rng), rng)
            imgs[i], pres[i], lms[i], boxes[i] = img, 1.0, lm, box
        else:
            imgs[i] = render_background(size, rng)
    return imgs, pres, lms, boxes


def face_clip(size: int, t: int, rng, *, swap_at: int | None = None,
              jitter=0.01, id_a: FaceIdentity | None = None,
              id_b: FaceIdentity | None = None):
    """Video fixture: one identity moving smoothly; optionally swap to a
    second identity at frame `swap_at` (the face-swap drift fixture).
    Returns (frames_uint8 (T,S,S,3), landmarks (T,5,2))."""
    id_a = id_a if id_a is not None else random_identity(rng)
    id_b = id_b if id_b is not None else random_identity(rng)
    center = rng.uniform(0.42, 0.58, 2)
    vel = rng.uniform(-jitter, jitter, 2)
    scale = rng.uniform(0.26, 0.32)
    frames, lms = [], []
    for i in range(t):
        ident = id_b if (swap_at is not None and i >= swap_at) else id_a
        img, lm, _ = render_face(size, ident, rng, center=center.copy(),
                                 scale=scale, angle=0.0)
        frames.append((img * 255).astype(np.uint8))
        lms.append(lm)
        center = np.clip(center + vel + rng.uniform(-jitter, jitter, 2),
                         0.35, 0.65)
    return np.stack(frames), np.stack(lms)
