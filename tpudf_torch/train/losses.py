"""Training losses (tpudf/train/losses.py) on PyTorch tensors.

Classification and segmentation families of the reference's loss battery
(siglip2siddataset.py:69-189): BCE with logits, softmax cross-entropy with
label smoothing, focal, boundary-aware, morphological consistency, IoU,
Dice and their combinations. The morphology is grayscale max/min pooling
over the last two axes with ±inf padding, as JAX's `reduce_window`; a
window holding tied maxima sends its gradient to the first of them in
row-major order (`F.max_pool2d`'s rule, and XLA's select-and-scatter's).
JAX's `mixup` (the binary trainer's) is split into its draws
(`mixup_draws`, from an explicit torch.Generator) and a pure apply
(`mixup_apply`), so that a test can feed JAX's draws to the apply.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpudf_torch.utils.nn import GlobalRows


def bce_with_logits(logits, targets, pos_weight=None):
    """Mean binary cross-entropy from logits (BCEWithLogitsLoss semantics,
    pos_weight included)."""
    log_p = F.logsigmoid(logits)
    log_np = F.logsigmoid(-logits)
    w_pos = pos_weight if pos_weight is not None else 1.0
    return torch.mean(-(w_pos * targets * log_p + (1.0 - targets) * log_np))


def softmax_ce(logits, labels, num_classes=None, label_smoothing=0.0):
    """Mean cross-entropy over integer labels."""
    nc = num_classes or logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), nc).to(logp.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / nc
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def focal_loss(logits, targets, alpha=0.25, gamma=2.0):
    """Binary focal loss (siglip2siddataset.py:69-77)."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.mean(alpha_t * (1 - p_t) ** gamma * ce)


def _pool(x, kernel_size, op):
    """Grayscale morphology over (..., H, W): a stride-1 max (or min) pool
    whose padding never wins."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    x4 = x.reshape(-1, 1, h, w)
    if op == "min":
        x4 = -x4
    y = F.max_pool2d(x4, kernel_size, stride=1, padding=kernel_size // 2)
    if op == "min":
        y = -y
    return y.reshape(*lead, h, w)


def dilate(x, kernel_size=3):
    return _pool(x, kernel_size, "max")


def erode(x, kernel_size=3):
    return _pool(x, kernel_size, "min")


def opening(x, kernel_size=3):
    return dilate(erode(x, kernel_size), kernel_size)


def closing(x, kernel_size=3):
    return erode(dilate(x, kernel_size), kernel_size)


def boundary_aware_loss(logits, targets, kernel_size=3):
    """BCE with 4x weight on the morphological boundary band
    (siglip2siddataset.py:98-116)."""
    boundary = (dilate(targets, kernel_size)
                - erode(targets, kernel_size)).detach()
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    return torch.mean(ce * (1.0 + 3.0 * boundary))


def morphological_loss(logits, targets, kernel_size=3):
    """Opening/closing consistency MSE (siglip2siddataset.py:118-140)."""
    p = torch.sigmoid(logits)
    o = torch.mean((opening(p, kernel_size)
                    - opening(targets, kernel_size)) ** 2)
    c = torch.mean((closing(p, kernel_size)
                    - closing(targets, kernel_size)) ** 2)
    return (o + c) / 2


def _sample_axes(p):
    return tuple(range(1, p.ndim))


def iou_loss(logits, targets, smooth=1e-6):
    """1 - soft IoU (siglip2siddataset.py:142-148)."""
    p = torch.sigmoid(logits)
    axes = _sample_axes(p)
    inter = torch.sum(p * targets, axes)
    union = torch.sum(p, axes) + torch.sum(targets, axes) - inter + smooth
    return 1.0 - torch.mean(inter / union)


def dice_loss(logits, targets, eps=1e-6):
    p = torch.sigmoid(logits)
    axes = _sample_axes(p)
    inter = torch.sum(p * targets, axes)
    denom = torch.sum(p, axes) + torch.sum(targets, axes) + eps
    return 1.0 - torch.mean(2 * inter / denom)


def bce_dice_loss(logits, targets, bce_w=1.0, dice_w=0.5):
    """Legacy BCE+Dice (siglip2siddataset.py:174-181)."""
    return (bce_w * bce_with_logits(logits, targets)
            + dice_w * dice_loss(logits, targets))


def combined_segmentation_loss(logits, targets, bce_w=0.4, focal_w=0.3,
                               dice_w=0.5, boundary_w=0.4, iou_w=0.4,
                               morph_w=0.2):
    """Six-component seg loss (siglip2siddataset.py:150-172)."""
    return (bce_w * bce_with_logits(logits, targets)
            + focal_w * focal_loss(logits, targets)
            + dice_w * dice_loss(logits, targets)
            + boundary_w * boundary_aware_loss(logits, targets)
            + iou_w * iou_loss(logits, targets)
            + morph_w * morphological_loss(logits, targets))


def dice_iou_from_logits(logits, targets, thr=0.5, eps=1e-6):
    """Per-sample hard dice/IoU at a threshold (siglip2siddataset.py:
    183-189). Returns (dice, iou, binary prediction)."""
    p = (torch.sigmoid(logits) > thr).to(torch.float32)
    axes = _sample_axes(p)
    inter = torch.sum(p * targets, axes)
    union = torch.sum(p + targets - p * targets, axes) + eps
    dice = 2 * inter / (torch.sum(p, axes) + torch.sum(targets, axes) + eps)
    return dice, inter / union, p


def mixup_draws(generator: torch.Generator, n: int, alpha=0.2):
    """The draws of JAX's `mixup`: (lam ~ Beta(alpha, alpha) as a Python float,
    a permutation of n on the generator's device). torch samples a Beta
    only from its global generator, so lam comes from a numpy generator
    seeded by one draw of `generator`. A GlobalRows (utils/nn.py) draws
    the global batch's permutation."""
    if isinstance(generator, GlobalRows):
        generator, n = generator.generator, generator.total
    dev = generator.device
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                             device=dev))
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    return lam, torch.randperm(n, generator=generator, device=dev)


def mixup_apply(x, y, lam, perm, rows=None):
    """Mixup (cifake_binary_classifier.py training loop): lam · x + (1 −
    lam) · x[perm], and the same of the labels. rows: a GlobalRows when x
    and y are this rank's rows of a global batch and perm permutes that
    batch: the partners come from the gathered batch."""
    if isinstance(rows, GlobalRows):
        sel = perm[rows.start:rows.start + x.shape[0]]
        return (lam * x + (1 - lam) * rows.gather(x)[sel],
                lam * y + (1 - lam) * rows.gather(y)[sel])
    return lam * x + (1 - lam) * x[perm], lam * y + (1 - lam) * y[perm]

