"""Face identity embedding network (tpudf/models/face_embed.py): the
metric-learning stand-in for the reference's ArcFace embeddings
(appv3.py:67-90, consumed by the face drift/track signals :3557-3755).

Four stride-2 "SAME" convolutions (`face_landmark.conv_same`) to a 4x4x128
map, flattened in the JAX package's NHWC order, projected to 128 and L2
normalized; the parameter dict and npz in the JAX package's layout.

Contrastive pretraining (`train_face_embed`, `render_crop_pool`,
`make_pair_batch`) needs the procedural face generator
(tpudf/data/synth_faces.py), which the port does not have yet (ROADMAP
Queue A item 5): the port serves the packaged weights.
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
    x = images01.float().permute(0, 3, 1, 2) - 0.5
    for c, (_, stride) in zip(params["convs"], STEM):
        x = F.relu(conv_same(x, c["k"], c["b"], stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten
    z = x @ params["proj"]["k"] + params["proj"]["b"]
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


def train_face_embed(*args, **kwargs):
    """Contrastive pretraining needs data/synth_faces.py."""
    raise NotImplementedError(
        "face-embed pretraining needs the procedural face generator "
        "(data/synth_faces.py), not yet in tpudf_torch (ROADMAP Queue A "
        "item 5); serve the packaged tpudf_torch/assets/face_embed.npz or "
        "point TPUDF_FACE_EMBED_CKPT at saved weights")


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
