"""HiDF video classifier training (tpudf/train/video.py): the frozen
tower over a folded frame axis + the temporal video head.

Re-designs hidf_video_classifier.py:370-428 + main (:2805-3121): the (B, T)
frame axis folds into the batch for one tower call (the reference's B·T
reshape, :304); the backbone is frozen (:2913-2916): JAX's stop_gradient
on the features becomes a tower run under torch.no_grad(), so the tower's
kernels run their forward only (no K10 launch, no activation graph held);
BCE with the auto pos_weight (:2934-2940); `make_optimizer`'s warmup-cosine
AdamW with the global clip. The step updates the head and the optimizer
state in place; the head's dropout draws from the step's torch.Generator
(None: no dropout, JAX's step with rng None).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from tpudf_torch.core.precision import DEFAULT_POLICY, Policy
from tpudf_torch.models.heads import apply_video_head
from tpudf_torch.models.siglip import SigLIPConfig, siglip_forward
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.train.losses import bce_with_logits
from tpudf_torch.train.steps import fit_step, tensor_leaves


def video_frame_features(backbone_params, frames, cfg: SigLIPConfig,
                         policy: Policy = DEFAULT_POLICY,
                         kernels: KernelSet = KERNELS):
    """frames: (B, T, S, S, 3) SigLIP-normalised → (B, T, W) pooled
    features through ONE folded tower forward."""
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    feats = siglip_forward(backbone_params, flat, cfg, policy,
                           kernels=kernels)["pooled"]
    return feats.reshape(b, t, -1)


def video_forward(backbone_params, head_params, frames, cfg, policy,
                  generator=None, freeze_backbone=True,
                  kernels: KernelSet = KERNELS):
    """(B,) logits of the video head over the tower's frame features; the
    frozen tower runs without autograd."""
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not freeze_backbone):
        feats = video_frame_features(backbone_params, frames, cfg, policy,
                                     kernels)
    return apply_video_head(head_params, feats, generator=generator)


def auto_pos_weight(labels):
    """n_neg / n_pos BCE pos_weight (hidf :2934-2940)."""
    y = np.asarray(labels)
    n_pos = max(int((y == 1).sum()), 1)
    n_neg = max(int((y == 0).sum()), 1)
    return n_neg / n_pos


class VideoTrainState(NamedTuple):
    head: Any
    opt_state: Any
    step: int


def make_video_train_step(cfg: SigLIPConfig, optimizer,
                          policy: Policy = DEFAULT_POLICY,
                          pos_weight: float = 1.0,
                          kernels: KernelSet = KERNELS):
    """Frozen-backbone head training: (init_fn, step). init_fn(head) makes
    the head's leaves trainable in place and returns the state;
    step(state, backbone, batch, generator=None) → (state, {"loss",
    "acc"}) with batch = {"frames": (B, T, S, S, 3) normalised, "labels":
    (B,)}; after a step each head leaf's `.grad` holds its gradient."""

    def step(state: VideoTrainState, backbone, batch, generator=None):
        labels, logits = batch["labels"], []

        def loss_fn(head):
            logits.append(video_forward(backbone, head, batch["frames"], cfg,
                                        policy, generator=generator,
                                        kernels=kernels))
            return bce_with_logits(logits[0], labels, pos_weight)

        opt_state, loss = fit_step(state.head, optimizer, state.opt_state,
                                   loss_fn)
        z = logits[0].detach()
        acc = torch.mean(((z > 0) == (labels > 0.5)).float())
        return (VideoTrainState(state.head, opt_state, state.step + 1),
                {"loss": loss, "acc": acc})

    def init_fn(head):
        leaves = tensor_leaves(head)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return VideoTrainState(head, optimizer.init(
            [leaf.detach() for leaf in leaves]), 0)

    return init_fn, step


def make_video_eval_step(cfg: SigLIPConfig, policy: Policy = DEFAULT_POLICY,
                         kernels: KernelSet = KERNELS):
    """eval(head, backbone, frames) → (B,) logits, no dropout, no
    autograd."""
    @torch.no_grad()
    def step(head, backbone, frames):
        return video_forward(backbone, head, frames, cfg, policy,
                             kernels=kernels)
    return step
