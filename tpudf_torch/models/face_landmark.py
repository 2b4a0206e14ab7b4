"""5-point face landmark network (tpudf/models/face_landmark.py): the
stand-in for the reference's insightface detector (appv3.py:67-90: 5-pt
landmarks feeding face_topology/track/embedding drift, :3557-3755).

A tiny conv net over a parameter dict in the JAX package's layout (conv
kernels HWIO, dense weights (in, out)), so the npz checkpoints are shared
byte for byte: a strided conv stem to a 16x16 map, then a 5-channel
heatmap head decoded by spatial soft-argmax, and pooled presence / box
heads. Single dominant face.

The convolutions pad as `lax.conv_general_dilated`'s "SAME" does: on an
even input a stride-2, 3x3 conv pads (0, 1), not `padding=1`'s (1, 1), so
each pads explicitly (`conv_same`) and convolves with padding 0.

Coordinates are normalized to [0, 1] over the input square. Landmark order
follows insightface: left eye, right eye, nose, left mouth, right mouth.

`train_landmark_net` pretrains the net on the procedural face generator
(data/synth_faces.py, the same numpy draws as the JAX package's) with Adam,
in f32 with TF32 off (`ops.forensics.f32_math`), on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STEM = ((24, 2), (48, 2), (64, 1), (64, 1))   # (width, stride) per conv
HEAT_HW = 16                                   # heatmap resolution
FORMAT_VERSION = 3  # v3 = heatmap/soft-argmax landmark decoder

_HEADS = ("head_heat", "dense", "head_presence", "head_box")


def _same_pads(n: int, k: int, s: int):
    """(low, high) padding of "SAME" along one axis of size n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x, k_hwio, b, stride: int):
    """NCHW x, HWIO kernel: lax.conv_general_dilated(..., "SAME") + b."""
    kh, kw = k_hwio.shape[:2]
    hl, hh = _same_pads(x.shape[2], kh, stride)
    wl, wh = _same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(x, k_hwio.permute(3, 2, 0, 1), b, stride=stride)


def _conv_init(generator, shape):
    fan_in = int(np.prod(shape[:-1]))
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


def init_landmark_net(generator: torch.Generator, size: int = 64):
    """Input (B, size, size, 3); size must be divisible by 4 (the stem
    downsamples 4x; the heatmap is size//4 per side). Random weights from
    `generator` (the JAX package's init rule, not its numbers)."""
    params = {"convs": []}
    cin = 3
    for w, _ in STEM:
        params["convs"].append({"k": _conv_init(generator, (3, 3, cin, w)),
                                "b": torch.zeros(w)})
        cin = w
    params["head_heat"] = {"k": _conv_init(generator, (1, 1, cin, 5)),
                           "b": torch.zeros(5)}
    params["dense"] = {"k": _conv_init(generator, (cin, 64)),
                       "b": torch.zeros(64)}
    params["head_presence"] = {"k": _conv_init(generator, (64, 1)),
                               "b": torch.zeros(1)}
    params["head_box"] = {"k": _conv_init(generator, (64, 4)),
                          "b": torch.zeros(4)}
    return params


@torch.no_grad()
def landmark_forward(params, images01):
    """images01: (B, S, S, 3) float in [0,1] → dict:
    presence (B,) logit, box (B,4) normalized (cx,cy,w,h),
    landmarks (B,5,2) normalized (x,y), on the parameters' device.

    Landmarks decode by soft-argmax over per-landmark heatmaps: the
    softmax-weighted expectation of the spatial bin centres."""
    return landmark_outputs(params, images01)


def landmark_outputs(params, images01):
    """`landmark_forward` with autograd (the training forward)."""
    x = images01.float().permute(0, 3, 1, 2) - 0.5
    for c, (_, stride) in zip(params["convs"], STEM):
        x = F.relu(conv_same(x, c["k"], c["b"], stride))
    b, cin, gh, gw = x.shape

    heat = conv_same(x, params["head_heat"]["k"], params["head_heat"]["b"], 1)
    logits = heat.permute(0, 2, 3, 1).reshape(b, gh * gw, 5)
    w = torch.softmax(logits * 2.0, dim=1)          # fixed temperature
    ys = (torch.arange(gh, dtype=torch.float32, device=x.device) + 0.5) / gh
    xs = (torch.arange(gw, dtype=torch.float32, device=x.device) + 0.5) / gw
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"),
                       dim=-1).reshape(gh * gw, 2)  # (HW, 2) = (x, y)
    lms = torch.einsum("bnk,nc->bkc", w, grid)      # (B, 5, 2)

    pooled = x.mean(dim=(2, 3))
    h = F.relu(pooled @ params["dense"]["k"] + params["dense"]["b"])
    pres = (h @ params["head_presence"]["k"]
            + params["head_presence"]["b"])[:, 0]
    box = torch.sigmoid(h @ params["head_box"]["k"] + params["head_box"]["b"])
    return {"presence": pres, "box": box, "landmarks": lms}


def landmark_loss(out, pres, lms, boxes):
    """The presence BCE + 10 x the landmark loss in BOX-RELATIVE units
    (geometry errors weigh the same on small and large faces) + 2 x the
    box loss, the last two over face samples only."""
    from tpudf_torch.train.losses import bce_with_logits
    l_pres = bce_with_logits(out["presence"], pres)
    m = pres[:, None, None]
    wh = torch.clamp(boxes[:, None, 2:], min=0.05)
    l_lm = torch.sum(m * ((out["landmarks"] - lms) / wh) ** 2) \
        / (torch.sum(m) * 10.0 + 1e-6)
    mb = pres[:, None]
    l_box = torch.sum(mb * (out["box"] - boxes) ** 2) \
        / (torch.sum(mb) * 4.0 + 1e-6)
    return l_pres + 10.0 * l_lm + 2.0 * l_box


def train_landmark_net(params=None, *, steps=1500, batch=64, size=64,
                       lr=2e-3, seed=0, log_every=0, device="cuda"):
    """Pretrain on procedural faces (data/synth_faces.make_batch on
    np.random.default_rng(seed)) with Adam at `lr`; returns the trained
    parameters on `device`. params: the initial tree (default drawn from
    torch.Generator(seed)). Deterministic for a seed on a device."""
    from tpudf_torch.data.synth_faces import make_batch
    from tpudf_torch.ops.forensics import f32_math
    from tpudf_torch.train.steps import (adam, fit_step, frozen_copy,
                                         tensor_leaves, trainable)

    if params is None:
        params = init_landmark_net(torch.Generator().manual_seed(seed), size)
    params = trainable(params, device)
    opt = adam(lr)
    state = opt.init([t.detach() for t in tensor_leaves(params)])
    rng = np.random.default_rng(seed)
    on = lambda a: torch.from_numpy(a).to(device)
    with f32_math():
        for i in range(steps):
            imgs, pres, lms, boxes = (on(a) for a in make_batch(rng, batch,
                                                                size))
            state, loss = fit_step(params, opt, state, lambda p: landmark_loss(
                landmark_outputs(p, imgs), pres, lms, boxes))
            if log_every and (i + 1) % log_every == 0:
                print(f"[face_landmark] step {i + 1}/{steps} "
                      f"loss={float(loss):.4f}")
    return frozen_copy(params)


def save_landmark_net(params, path):
    """Flat .npz save in the JAX package's format."""
    flat = {"format_version": np.asarray(FORMAT_VERSION)}
    for i, c in enumerate(params["convs"]):
        flat[f"conv{i}_k"] = c["k"].detach().cpu().numpy()
        flat[f"conv{i}_b"] = c["b"].detach().cpu().numpy()
    for name in _HEADS:
        flat[f"{name}_k"] = params[name]["k"].detach().cpu().numpy()
        flat[f"{name}_b"] = params[name]["b"].detach().cpu().numpy()
    np.savez(path, **flat)


def load_landmark_net(path, device):
    """The npz's tensors on `device`; ValueError on another format."""
    z = np.load(path)
    ver = int(z["format_version"]) if "format_version" in z else 1
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"landmark checkpoint {path} has format v{ver}, expected "
            f"v{FORMAT_VERSION} (landmark parameterization changed); "
            "delete the cache / retrain")
    on = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    params = {"convs": []}
    i = 0
    while f"conv{i}_k" in z:
        params["convs"].append({"k": on(z[f"conv{i}_k"]),
                                "b": on(z[f"conv{i}_b"])})
        i += 1
    for name in _HEADS:
        params[name] = {"k": on(z[f"{name}_k"]), "b": on(z[f"{name}_b"])}
    return params
