"""Face pipeline (tpudf/serve/face.py): detection, landmarks, identity
embeddings, the face temporal drift signals and the face retouch score.

The primary path is the landmark net (models/face_landmark.py, the
packaged weights or $TPUDF_FACE_CKPT) and the identity net
(models/face_embed.py) on the caller's device; the fallbacks are cv2's
Haar cascade boxes on the host (the cascade ships inside cv2), box
geometry when no landmark net is available, and the engine's tower
embeddings (`embed_fn`) when no identity net is. The signals
(appv3.py:3557-3755):
  * face_topology_drift — landmark-geometry vector drift (landmark path)
    or box aspect / position / size drift (Haar fallback)
  * face_track_drift — 0.6 x embedding drift + 0.4 x geometry drift over
    the dominant face track
  * face_embedding_drift — identity-embedding drift over landmark-aligned
    (or Haar) face crops. The identity net is pretrained on procedural
    identities, not ArcFace-grade (the JAX module's caveat holds).
  * face_region_retouch_score — perlin + HF-flatness of the face crop
    (appv3.py:2496-2503)
A signal is None where it is unavailable (fewer than 3 faces, no embedder).
Every resize is jax.image.resize's antialiased bilinear
(data/pipeline.resize); crops are truncated to uint8 as the JAX package
truncates them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpudf_torch.data.pipeline import resize
from tpudf_torch.ops.forensics import (_gray, _var, f32_math, laplacian,
                                       perlin_diffusion_score)

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
# the user caches, expanded at each lookup (so a HOME set later counts)
_DEFAULT_CACHE = "~/.cache/tpudf/face_landmarks.npz"
_PACKAGED_ASSET = os.path.join(_ASSETS, "face_landmarks.npz")
_EMBED_CACHE = "~/.cache/tpudf/face_embed.npz"
_EMBED_ASSET = os.path.join(_ASSETS, "face_embed.npz")

# the loaded parameters per (checkpoint env value, device); None results
# are not memoized, so a checkpoint that appears later is still found
_LM_MEMO = {}
_EMBED_MEMO = {}

# identity-drift → score mapping, calibrated on the synthetic fixtures
# (scripts/calibrate_face_embed.py): same-identity clips with a mid-clip
# relight land below lo; mid-clip identity swaps land ~span above it
ID_DRIFT_LO, ID_DRIFT_SPAN = 0.15, 0.25


def _resolve(env, cache, asset, load, device, memo, allow_train, train,
             save, default_steps):
    """The JAX package's resolution order: $env → the user cache (removed
    when its format is stale) → the packaged asset → when allowed
    (allow_train, or $TPUDF_FACE_TRAIN=1) pretraining on `device` for
    $TPUDF_FACE_TRAIN_STEPS steps (default_steps by default), saved to the
    user cache → None. Loaded and trained parameters are memoized per (env
    value, device)."""
    key = (os.environ.get(env, ""), str(torch.device(device)))
    if key in memo:
        return memo[key]

    def remember(params):
        if params is not None:
            memo[key] = params
        return params
    cache = os.path.expanduser(cache)
    path = os.environ.get(env, "")
    if path and os.path.exists(path):
        return remember(load(path, device))
    if os.path.exists(cache):
        try:
            return remember(load(cache, device))
        except ValueError:          # stale format: retrain below if allowed
            os.remove(cache)
    if os.path.exists(asset):
        try:
            return remember(load(asset, device))
        except ValueError:
            pass                    # stale packaged format: retrain below
    if allow_train is None:
        allow_train = os.environ.get("TPUDF_FACE_TRAIN", "") == "1"
    if not allow_train:
        return None
    params = train(steps=int(os.environ.get("TPUDF_FACE_TRAIN_STEPS",
                                            str(default_steps))),
                   device=device)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    save(params, cache)
    return remember(params)


def get_landmark_params(device, allow_train: bool | None = None):
    """The landmark net's parameters on `device`: $TPUDF_FACE_CKPT →
    ~/.cache/tpudf/face_landmarks.npz → the packaged asset
    (tpudf_torch/assets/face_landmarks.npz) → (allow_train, or
    $TPUDF_FACE_TRAIN=1) synthetic pretraining
    (models/face_landmark.train_landmark_net, 1500 steps by default) on
    `device`, cached to disk → None (callers fall back to Haar box
    geometry)."""
    from tpudf_torch.models.face_landmark import (load_landmark_net,
                                                  save_landmark_net,
                                                  train_landmark_net)
    return _resolve("TPUDF_FACE_CKPT", _DEFAULT_CACHE, _PACKAGED_ASSET,
                    load_landmark_net, device, _LM_MEMO, allow_train,
                    train_landmark_net, save_landmark_net, 1500)


def get_face_embed_params(device, allow_train: bool | None = None):
    """The face identity net's parameters on `device`:
    $TPUDF_FACE_EMBED_CKPT → ~/.cache/tpudf/face_embed.npz → the packaged
    asset → (allow_train, or $TPUDF_FACE_TRAIN=1) synthetic contrastive
    pretraining (models/face_embed.train_face_embed, 2000 steps by
    default) on `device`, cached to disk → None (callers fall back to
    tower embeddings). $TPUDF_FACE_ID_EMBED=0 disables the identity net."""
    if os.environ.get("TPUDF_FACE_ID_EMBED", "") == "0":
        return None
    from tpudf_torch.models.face_embed import (load_face_embed,
                                               save_face_embed,
                                               train_face_embed)
    return _resolve("TPUDF_FACE_EMBED_CKPT", _EMBED_CACHE, _EMBED_ASSET,
                    load_face_embed, device, _EMBED_MEMO, allow_train,
                    train_face_embed, save_face_embed, 2000)


def _params_device(params):
    return params["convs"][0]["k"].device


def identity_embed_crops(embed_params, crops_uint8):
    """(N, S, S, 3) uint8 aligned crops → (N, 128) L2-normalized identity
    embeddings (numpy), resized to the net's 64 px input on its device,
    in f32 (f32_math: TF32 off, as XLA computes the JAX net)."""
    from tpudf_torch.models.face_embed import CROP_SIZE, face_embed_forward
    dev = _params_device(embed_params)
    with f32_math():
        x = torch.from_numpy(np.ascontiguousarray(crops_uint8)).to(
            dev).float() / 255.0
        if x.shape[1] != CROP_SIZE:
            x = resize(x, (x.shape[0], CROP_SIZE, CROP_SIZE, 3), "bilinear")
        return face_embed_forward(embed_params, x).cpu().numpy()


def refine_corners(box, w, h):
    """The refinement crop of a normalized (cx, cy, bw, bh) box in a w x h
    frame: the box's 1.6x square, clipped, as integer pixel corners
    (px0, py0, px1, py1); int() truncates as the JAX package does."""
    cx, cy, bw, bh = box
    s = max(bw, bh) * 1.6
    x0 = float(np.clip(cx - s / 2, 0, 1 - 1e-3))
    y0 = float(np.clip(cy - s / 2, 0, 1 - 1e-3))
    x1 = float(np.clip(cx + s / 2, x0 + 1e-3, 1))
    y1 = float(np.clip(cy + s / 2, y0 + 1e-3, 1))
    px0, py0 = int(x0 * w), int(y0 * h)
    return px0, py0, max(int(x1 * w), px0 + 2), max(int(y1 * h), py0 + 2)


def detect_landmarks_batch(frames_rgb_uint8, lm_params, *,
                           presence_thresh=0.0):
    """(T, H, W, 3) uint8 → (landmarks (T,5,2) in image pixels or None per
    frame, boxes (T,4) normalized). One batch through the net at 64 px on
    its device, then a refinement pass on each predicted face's 1.6x crop
    (`refine_corners`); both in f32 (f32_math: TF32 off, as XLA computes
    the JAX net)."""
    from tpudf_torch.models.face_landmark import landmark_forward
    dev = _params_device(lm_params)
    frames = np.asarray(frames_rgb_uint8)
    t, h, w = frames.shape[:3]
    with f32_math():
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(
            dev).float() / 255.0
        out = landmark_forward(lm_params,
                               resize(x, (t, 64, 64, 3), "bilinear"))
        pres = out["presence"].cpu().numpy()
        boxes = out["box"].cpu().numpy()               # (T,4) cx,cy,w,h
        lms = out["landmarks"].cpu().numpy()           # (T,5,2) normalized

        # refinement: re-run on the 1.6x face crop for sub-pixel precision
        crops, metas = [], []
        for i in range(t):
            if pres[i] <= presence_thresh:
                metas.append(None)
                continue
            px0, py0, px1, py1 = refine_corners(boxes[i], w, h)
            crops.append(resize(x[i, py0:py1, px0:px1], (64, 64, 3),
                                "bilinear"))
            metas.append((px0, py0, px1 - px0, py1 - py0, i))
        if crops:
            ref = landmark_forward(lm_params, torch.stack(crops))
            rl = ref["landmarks"].cpu().numpy()
            rp = ref["presence"].cpu().numpy()
    result = [None] * t
    j = 0
    for meta in metas:
        if meta is None:
            continue
        px0, py0, cw, ch, i = meta
        if rp[j] > presence_thresh:
            result[i] = rl[j] * np.asarray([cw, ch]) + np.asarray([px0, py0])
        else:                                  # refinement lost it: coarse
            result[i] = lms[i] * np.asarray([w, h])
        j += 1
    return result, boxes


def landmark_topology_vec(lms_px, box_px=None):
    """(5,2) landmark pixels → the reference's 4-d face-geometry signature
    (appv3.py:3581-3591): [eye_dist/bw, mouth_dist/bw, eye_to_mouth/bh,
    nose_to_eye/bh]. box_px = (bw, bh); derived from the landmark extent
    when absent."""
    if box_px is None:
        span = lms_px.max(0) - lms_px.min(0)
        bw = max(float(span[0]) * 1.6, 1.0)
        bh = max(float(span[1]) * 1.6, 1.0)
    else:
        bw = max(float(box_px[0]), 1.0)
        bh = max(float(box_px[1]), 1.0)
    eye_dist = float(np.linalg.norm(lms_px[0] - lms_px[1])) / bw
    mouth_dist = float(np.linalg.norm(lms_px[3] - lms_px[4])) / bw
    eye_center = (lms_px[0] + lms_px[1]) * 0.5
    mouth_center = (lms_px[3] + lms_px[4]) * 0.5
    eye_to_mouth = abs(float(mouth_center[1] - eye_center[1])) / bh
    nose_to_eye = abs(float(lms_px[2][1] - eye_center[1])) / bh
    return np.asarray([eye_dist, mouth_dist, eye_to_mouth, nose_to_eye],
                      np.float32)


def _median3(vecs):
    """3-tap median filter along time per dimension: suppresses the
    landmark net's per-frame jitter while a persistent identity-swap step
    survives."""
    v = np.asarray(vecs)
    if len(v) < 3:
        return v
    pad = np.concatenate([v[:1], v, v[-1:]], axis=0)
    return np.median(np.stack([pad[:-2], pad[1:-1], pad[2:]]), axis=0)


def face_crop_from_landmarks(image_rgb_uint8, lms_px, margin=1.3,
                             out_size=None):
    """Landmark-aligned square crop centered on the landmark centroid with
    size proportional to the eye-mouth span; with out_size, resized on the
    host (the crop and its result are host arrays) and truncated to
    uint8."""
    arr = np.asarray(image_rgb_uint8)
    h, w = arr.shape[:2]
    c = lms_px.mean(0)
    span = max(float(np.linalg.norm(lms_px[0] - lms_px[4])),
               float(np.linalg.norm(lms_px[1] - lms_px[3])), 8.0)
    s = span * 2.0 * margin
    x0 = int(np.clip(c[0] - s / 2, 0, w - 2))
    y0 = int(np.clip(c[1] - s / 2, 0, h - 2))
    x1 = int(np.clip(c[0] + s / 2, x0 + 1, w))
    y1 = int(np.clip(c[1] + s / 2, y0 + 1, h))
    crop = arr[y0:y1, x0:x1]
    if out_size is not None:
        crop = resize(torch.from_numpy(np.ascontiguousarray(crop)).float(),
                      (out_size, out_size, 3), "bilinear"
                      ).numpy().astype(np.uint8)
    return crop


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


def _box_geometry_vec(box, frame_shape):
    """4-d geometry vector for a Haar face box, the landmark-free
    substitute for the reference's 5-point vector (appv3.py:3577-3593):
    [aspect ratio, relative center x, relative center y, relative size]."""
    x, y, w, h = box
    H, W = frame_shape[:2]
    return np.asarray([w / max(h, 1.0), (x + w / 2) / W, (y + h / 2) / H,
                       np.sqrt(w * h) / np.sqrt(H * W)], np.float32)


def _clip_landmarks(frames_rgb_uint8, lm_params):
    """(landmarks per frame, face boxes (T,2) pixel (bw, bh)) for a clip,
    or (None, None) when the net is unavailable or finds fewer than 3
    faces. Box sizes come from the net's box head: the reference
    normalizes its geometry ratios by the detection box, not the landmark
    extent (appv3.py:3581-3591)."""
    if lm_params is None:
        return None, None
    frames = np.stack([np.asarray(f) for f in frames_rgb_uint8])
    h, w = frames.shape[1:3]
    lms, boxes = detect_landmarks_batch(frames, lm_params)
    found = [l for l in lms if l is not None]
    if len(found) < 3:
        return None, None
    box_px = np.stack([boxes[:, 2] * w, boxes[:, 3] * h], axis=1)
    return lms, box_px


def _drift_map(vecs, lo, span):
    """Mean step-to-step L2 drift of a vector track, mapped to [0, 1] via
    the reference's clip((drift - lo) / span) (appv3.py:3600-3605)."""
    diffs = [float(np.linalg.norm(vecs[i] - vecs[i + 1]))
             for i in range(len(vecs) - 1)]
    return float(np.clip((float(np.mean(diffs)) - lo) / span, 0.0, 1.0))


def face_temporal_signals(frames_rgb_uint8, embed_fn=None, lm_params=None,
                          out_size=112, device=None):
    """All three face temporal drift signals (appv3.py:3557-3755) from one
    shared detection / alignment / embedding pass over the clip.

    Landmark path (lm_params given): the net's landmarks → the 4-d
    topology vector (3-tap median over time) and landmark-aligned crops.
    Haar fallback: the largest box's geometry vector and margin crops.
    Crop embeddings: the identity net on `device` (get_face_embed_params;
    by default the landmark net's device, else "cuda"), else embed_fn
    (the engine's tower: DetectEngine.embed_batch). Values are None where
    a signal is unavailable (< 3 faces / no embedder)."""
    if device is None:
        device = ("cuda" if lm_params is None
                  else _params_device(lm_params))
    frames = [np.asarray(f) for f in frames_rgb_uint8]
    lms, box_px = _clip_landmarks(frames, lm_params)
    topo_vecs, crops, geom = [], [], []
    if lms is not None:
        topo_vecs = _median3([landmark_topology_vec(l, box_px=b)
                              for l, b in zip(lms, box_px) if l is not None])
        for f, l in zip(frames, lms):
            if l is None:
                continue
            crops.append(face_crop_from_landmarks(f, l, out_size=out_size))
            c = l.mean(0)
            iod = float(np.linalg.norm(l[0] - l[1]))
            geom.append(np.asarray(
                [c[0] / f.shape[1], c[1] / f.shape[0],
                 iod / f.shape[1]], np.float32))
    else:
        for f in frames:
            boxes = detect_faces(f)
            if not boxes:
                continue
            box = max(boxes, key=lambda b: b[2] * b[3])
            v = _box_geometry_vec(box, f.shape)
            topo_vecs.append(v)
            geom.append(v)
            c = _crop_from_box(f, box, out_size=out_size)
            if c is not None:
                crops.append(c)

    topology = (_drift_map(topo_vecs, 0.03, 0.12)
                if len(topo_vecs) >= 3 else None)

    # one embedding pass over the dominant-face crop track: the identity
    # net (relight-invariant, swap-sensitive), else the tower's embeddings
    emb_score = track_emb_score = None
    id_params = get_face_embed_params(device)
    if len(crops) >= 3:
        if id_params is not None:
            emb = identity_embed_crops(id_params, np.stack(crops))
            emb_drift = 1.0 - float(np.mean(
                np.sum(emb[:-1] * emb[1:], axis=1)))
            emb_score = float(np.clip(
                (emb_drift - ID_DRIFT_LO) / ID_DRIFT_SPAN, 0.0, 1.0))
            track_emb_score = emb_score
        elif embed_fn is not None:
            emb = np.asarray(embed_fn(np.stack(crops)))
            emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-6)
            emb_drift = 1.0 - float(np.mean(
                np.sum(emb[:-1] * emb[1:], axis=1)))
            emb_score = float(np.clip((emb_drift - 0.05) / 0.40, 0.0, 1.0))
            track_emb_score = float(np.clip((emb_drift - 0.04) / 0.20,
                                            0.0, 1.0))

    # track drift: 0.6 x embedding stream + 0.4 x geometry stream
    scores = []
    if track_emb_score is not None:
        scores.append((track_emb_score, 0.6))
    if len(geom) >= 3:
        scores.append((_drift_map(geom, 0.03, 0.12), 0.4))
    track = (float(sum(v * w for v, w in scores)
                   / sum(w for _, w in scores)) if scores else None)

    return {"face_topology_drift": topology,
            "face_embedding_drift": emb_score,
            "face_track_drift": track}


def face_topology_drift(frames_rgb_uint8, lm_params=None, device=None):
    """Per-frame face-geometry drift (appv3.py:3557-3605); see
    face_temporal_signals."""
    return face_temporal_signals(frames_rgb_uint8, None, lm_params,
                                 device=device)["face_topology_drift"]


def face_track_drift(frames_rgb_uint8, embed_fn, lm_params=None,
                     device=None):
    """Dominant-face track drift (appv3.py:3650-3755); see
    face_temporal_signals."""
    return face_temporal_signals(frames_rgb_uint8, embed_fn, lm_params,
                                 device=device)["face_track_drift"]


def face_embedding_drift(frames_rgb_uint8, embed_fn, lm_params=None,
                         device=None):
    """Face-crop identity-embedding drift (the procedurally pretrained
    stand-in for the reference's ArcFace drift); see
    face_temporal_signals."""
    return face_temporal_signals(frames_rgb_uint8, embed_fn, lm_params,
                                 device=device)["face_embedding_drift"]


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
