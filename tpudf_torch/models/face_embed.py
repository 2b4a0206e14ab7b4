"""Face identity embedding network (tpudf/models/face_embed.py): the
metric-learning stand-in for the reference's ArcFace embeddings
(appv3.py:67-90, consumed by the face drift/track signals :3557-3755).

Four stride-2 "SAME" convolutions (`face_landmark.conv_same`) to a 4x4x128
map, flattened in the JAX package's NHWC order, projected to 128 and L2
normalized; the parameter dict and npz in the JAX package's layout.

Contrastive pretraining (`train_face_embed`, NT-Xent): positives are two
renders of the same procedural identity (data/synth_faces.py) under other
pose / scale / angle and identity-preserving relighting, negatives the
other identities of the batch; or a pool of real identities from disk
(`load_crop_pool_from_dir`). The pool, the pair batches and the relighting
are the JAX package's numpy draws in its order; the steps run Adam on a
cosine decay in f32 with TF32 off (`ops.forensics.f32_math`), on the
caller's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.models.face_landmark import _conv_init, conv_same

STEM = ((32, 2), (64, 2), (96, 2), (128, 2))   # (width, stride) per conv
EMBED_DIM = 128
CROP_SIZE = 64                                  # training/inference input
FORMAT_VERSION = 1


def init_face_embed(generator: torch.Generator):
    """Random weights from `generator` (the JAX package's init rule, not
    its numbers)."""
    params = {"convs": []}
    cin = 3
    for w, _ in STEM:
        params["convs"].append({"k": _conv_init(generator, (3, 3, cin, w)),
                                "b": torch.zeros(w)})
        cin = w
    # identity needs spatial layout (eye spacing, mouth width): flatten the
    # final 4x4 grid instead of pooling it away
    flat = (CROP_SIZE // 16) ** 2 * cin
    params["proj"] = {"k": _conv_init(generator, (flat, EMBED_DIM)),
                      "b": torch.zeros(EMBED_DIM)}
    return params


@torch.no_grad()
def face_embed_forward(params, images01):
    """images01: (B, 64, 64, 3) float in [0,1] → (B, 128) L2-normalized,
    on the parameters' device."""
    return face_embed_outputs(params, images01)


def face_embed_outputs(params, images01):
    """`face_embed_forward` with autograd (the training forward)."""
    x = images01.float().permute(0, 3, 1, 2) - 0.5
    for c, (_, stride) in zip(params["convs"], STEM):
        x = F.relu(conv_same(x, c["k"], c["b"], stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten
    z = x @ params["proj"]["k"] + params["proj"]["b"]
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


def _relight(img, rng):
    """Identity-preserving photometric augmentation: linear light gradient,
    brightness / gamma, mild color cast + noise (what a real clip's
    lighting changes do; the embedding must NOT move under these)."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi)
    ramp = ((xx / w) * np.cos(theta) + (yy / h) * np.sin(theta))
    g = 1.0 + rng.uniform(0.0, 0.5) * (ramp - ramp.mean())
    out = img * g[..., None]
    out = out * rng.uniform(0.6, 1.3)                       # brightness
    out = np.clip(out, 0, 1) ** rng.uniform(0.7, 1.4)      # gamma
    out = out * rng.uniform(0.85, 1.15, 3)[None, None, :]  # color cast
    out = out + rng.normal(0, rng.uniform(0.005, 0.04), out.shape)
    return np.clip(out, 0, 1).astype(np.float32)


def render_crop_pool(rng, n_ids: int, views: int, size: int = CROP_SIZE):
    """The contrastive pool, rendered once: (n_ids, views, S, S, 3)
    aligned crops in [0, 1], each view a fresh pose / scale / angle render
    of the same identity, cropped at noisy landmarks (serving crops come
    from a noisy landmark detector)."""
    from tpudf_torch.data.synth_faces import random_identity, render_face
    from tpudf_torch.serve.face import face_crop_from_landmarks

    pool = np.zeros((n_ids, views, size, size, 3), np.float32)
    big = size * 2
    for i in range(n_ids):
        ident = random_identity(rng)
        for v in range(views):
            img, lms, _ = render_face(big, ident, rng)
            noisy = lms * big + rng.normal(0, 1.0, lms.shape)
            crop = face_crop_from_landmarks(
                (img * 255).astype(np.uint8), noisy, out_size=size)
            pool[i, v] = crop.astype(np.float32) / 255.0
    return pool


def load_crop_pool_from_dir(path, size: int = CROP_SIZE,
                            max_ids: int | None = None,
                            max_views: int | None = None):
    """The contrastive pool from REAL identities on disk,
    ``path/<identity>/<image>`` with >= 2 aligned face crops per identity
    (docs/CERTIFICATION.md §2): (n_ids, views, S, S, 3) float32 in [0, 1],
    views = the smallest per-identity image count (identities with fewer
    than 2 images are skipped), each image PIL-bilinear resized to S."""
    import os

    from PIL import Image

    ids = sorted(d for d in os.listdir(path)
                 if os.path.isdir(os.path.join(path, d)))
    if max_ids:
        ids = ids[:max_ids]
    per_id = []
    for d in ids:
        files = sorted(
            f for f in os.listdir(os.path.join(path, d))
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        if len(files) >= 2:
            per_id.append((d, files))
    if len(per_id) < 2:
        raise ValueError(
            f"{path}: need >=2 identities with >=2 images each, "
            f"found {len(per_id)}")
    views = min(len(f) for _, f in per_id)
    if max_views:
        views = min(views, max_views)
    pool = np.zeros((len(per_id), views, size, size, 3), np.float32)
    for i, (d, files) in enumerate(per_id):
        for v in range(views):
            img = Image.open(os.path.join(path, d, files[v])).convert("RGB")
            pool[i, v] = np.asarray(
                img.resize((size, size), Image.BILINEAR),
                np.float32) / 255.0
    return pool


def make_pair_batch(rng, k_ids: int, size: int = CROP_SIZE, pool=None):
    """(2K, size, size, 3) aligned crops: rows [0, K) and [K, 2K) are two
    photometrically augmented views of the same K identities."""
    if pool is None:
        pool = render_crop_pool(rng, k_ids, 2, size)
        ids = np.arange(k_ids)
    else:
        ids = rng.choice(pool.shape[0], size=k_ids, replace=False)
    views = np.zeros((2, k_ids, size, size, 3), np.float32)
    for j, i in enumerate(ids):
        va, vb = rng.choice(pool.shape[1], size=2, replace=False)
        views[0, j] = _relight(pool[i, va], rng)
        views[1, j] = _relight(pool[i, vb], rng)
    return np.concatenate([views[0], views[1]], axis=0)


def nt_xent_loss(emb, temperature=0.1):
    """Normalized-temperature cross entropy over a (2K, D) two-view batch,
    the self-similarities masked with −1e9 · I."""
    k = emb.shape[0] // 2
    sim = emb @ emb.T / temperature
    sim = sim - 1e9 * torch.eye(2 * k, device=emb.device, dtype=sim.dtype)
    idx = torch.arange(k, device=emb.device)
    targets = torch.cat([idx + k, idx])
    rows = torch.arange(2 * k, device=emb.device)
    return torch.mean(-torch.log_softmax(sim, dim=-1)[rows, targets])


def train_face_embed(params=None, *, steps=2000, k_ids=32, n_ids=256,
                     pool_views=6, lr=1e-3, seed=0, log_every=0, pool=None,
                     device="cuda"):
    """Contrastive pretraining on procedural identities (default) or on a
    caller-supplied (n_ids, views, S, S, 3) crop pool (e.g. real
    identities, `load_crop_pool_from_dir`): Adam on
    optax.cosine_decay_schedule(lr, steps) (the port's warmup-cosine with
    no warm-up, read at the step count before each update). params: the
    initial tree (default drawn from torch.Generator(seed)). Returns the
    trained parameters on `device`."""
    import math

    from tpudf_torch.ops.forensics import f32_math
    from tpudf_torch.train.steps import (AdamW, fit_step, frozen_copy,
                                         tensor_leaves, trainable,
                                         warmup_cosine_decay_schedule)

    if params is None:
        params = init_face_embed(torch.Generator().manual_seed(seed))
    params = trainable(params, device)
    opt = AdamW(warmup_cosine_decay_schedule(0.0, lr, 0, steps), 0.0,
                math.inf)
    state = opt.init([t.detach() for t in tensor_leaves(params)])
    rng = np.random.default_rng(seed)
    if pool is None:
        pool = render_crop_pool(rng, n_ids, pool_views)
    k_ids = min(k_ids, pool.shape[0])
    with f32_math():
        for i in range(steps):
            batch = torch.from_numpy(make_pair_batch(rng, k_ids,
                                                     pool=pool)).to(device)
            state, loss = fit_step(params, opt, state, lambda p: nt_xent_loss(
                face_embed_outputs(p, batch)))
            if log_every and (i + 1) % log_every == 0:
                print(f"[face_embed] step {i + 1}/{steps} "
                      f"loss={float(loss):.4f}")
    return frozen_copy(params)


def save_face_embed(params, path):
    flat = {"format_version": np.asarray(FORMAT_VERSION)}
    for i, c in enumerate(params["convs"]):
        flat[f"conv{i}_k"] = c["k"].detach().cpu().numpy()
        flat[f"conv{i}_b"] = c["b"].detach().cpu().numpy()
    flat["proj_k"] = params["proj"]["k"].detach().cpu().numpy()
    flat["proj_b"] = params["proj"]["b"].detach().cpu().numpy()
    np.savez(path, **flat)


def load_face_embed(path, device):
    """The npz's tensors on `device`; ValueError on another format."""
    z = np.load(path)
    ver = int(z["format_version"]) if "format_version" in z else 0
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"face-embed checkpoint {path} has format v{ver}, expected "
            f"v{FORMAT_VERSION}; delete the cache / retrain")
    on = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    params = {"convs": []}
    i = 0
    while f"conv{i}_k" in z:
        params["convs"].append({"k": on(z[f"conv{i}_k"]),
                                "b": on(z[f"conv{i}_b"])})
        i += 1
    params["proj"] = {"k": on(z["proj_k"]), "b": on(z["proj_b"])}
    return params
