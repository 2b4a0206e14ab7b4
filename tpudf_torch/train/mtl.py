"""SID_Set multi-task training (tpudf/train/mtl.py) on PyTorch tensors:
3-class classification + tamper segmentation on the has-mask subset,
epoch-scheduled loss weights, gradient accumulation, and the frozen
variant (Siglip2sidafrozen.py:754-770: embeddings and layers < K frozen),
optionally with the frozen prefix on the static-W8A8 kernels.

The step is eager and updates the state in place: autograd accumulates the
micro-batches' gradients in the leaves' `.grad`, which are averaged before
one optimizer update, as JAX's scan sums and divides. After a step each
trainable leaf's `.grad` holds that step's averaged gradient.

The freeze: the optimizer sees only the trainable leaves and, of the
stacked (L, ...) block leaves, only the rows of the trainable layers, as
views of the master tensors. Frozen values are therefore never written and
stay bit-identical, which is what JAX reaches with `apply_freeze` (zero
frozen gradients) and its restore of frozen values after the update
(mtl.py:177-187); the trainable values and the clip's global norm are the
same, because the frozen gradients JAX feeds the optimizer are zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpudf_torch.convert import add_kernel_layout
from tpudf_torch.core.mesh import data_size, data_sum
from tpudf_torch.core.precision import tree_map
from tpudf_torch.models.segformer import MTLConfig, freeze_mask, mtl_forward
from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                   quantize_siglip_static)
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.train.losses import (bce_dice_loss,
                                      combined_segmentation_loss, softmax_ce)


def dynamic_loss_weights(epoch: int, total_epochs: int, iou_focus=True):
    """Epoch-scheduled (cls_w, seg_w) (siglip2siddataset.py:972-981,
    1325-1334): the seg weight ramps up as training progresses."""
    frac = epoch / max(total_epochs - 1, 1)
    cls_w = 1.0
    seg_w = 0.5 + 1.5 * frac if iou_focus else 1.0
    return cls_w, seg_w


def _masked_seg_loss(seg_logits, masks, has_mask, kind="combined"):
    """Mean seg loss over the samples that have a mask; each sample's loss
    is taken alone, vmapped over l[None] as in JAX (one batched launch per
    op, not one per sample). seg_logits, masks: (B, S, S); has_mask: (B,)
    float 0/1. Inside a data-parallel step (core/mesh.py `data_step`)
    the denominator counts the masks of the global batch."""
    fn = combined_segmentation_loss if kind == "combined" else bce_dice_loss
    per = torch.func.vmap(lambda l, m: fn(l[None], m[None]))(seg_logits,
                                                             masks)
    # the global batch's count of masks; a data-parallel rank's share of
    # it, so that the ranks' gradients, averaged, are the global batch's
    denom = torch.clamp(data_sum(has_mask), min=1.0) / data_size()
    return torch.sum(per * has_mask) / denom


def mtl_loss_fn(params, batch, cfg: MTLConfig, policy, cls_w, seg_w,
                seg_loss="combined", label_smoothing=0.0, generator=None,
                stop_grad_below=0, frozen_blocks_q=None,
                kernels: KernelSet = KERNELS):
    """(loss, metrics) of one batch: cls_w · CE + seg_w · masked seg loss."""
    cls_logits, seg_logits = mtl_forward(
        params, batch["pixels"], cfg, policy,
        cls_dropout_generator=generator, stop_grad_below=stop_grad_below,
        frozen_blocks_q=frozen_blocks_q, kernels=kernels)
    l_cls = softmax_ce(cls_logits, batch["cls"], 3, label_smoothing)
    l_seg = _masked_seg_loss(seg_logits, batch["mask"], batch["has_mask"],
                             seg_loss)
    loss = cls_w * l_cls + seg_w * l_seg
    acc = torch.mean((torch.argmax(cls_logits, -1) == batch["cls"])
                     .float())
    return loss, {"loss": loss, "cls_loss": l_cls, "seg_loss": l_seg,
                  "cls_acc": acc}


def make_freeze_mask(params, cfg: MTLConfig, freeze_below: int = 21):
    """(mask, layer_trainable): a bool tree, False on the embeddings, and
    the (L,) float vector of trainable layers (layer i trainable when
    i >= freeze_below)."""
    mask, layers = freeze_mask(params, cfg, freeze_below)
    return mask, layers.float()


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def trainable_leaves(params, mask, layer_trainable):
    """[(leaf, first row)] of every leaf the optimizer updates: the leaves
    whose mask is True, and for the stacked block leaves the first
    trainable layer (the trainable layers are a suffix)."""
    n = len(layer_trainable)
    row0 = n - int(layer_trainable.sum())
    if not bool(layer_trainable[row0:].all()):
        raise ValueError("the trainable layers must be the top ones")
    return [(leaf, row0 if path[:2] == ("backbone", "blocks") else 0)
            for path, leaf in _paths(params) if _get(mask, path)]


class MTLTrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: int


@torch.no_grad()
def quantize_frozen_prefix(params, cfg: MTLConfig, calib_pixels, policy,
                           freeze_below: int = 21):
    """Static-W8A8 copy of the frozen backbone prefix: activation scales
    calibrated on `calib_pixels`, the blocks quantised and cut to the
    first freeze_below layers, with the kernels' layout. Pass it to
    make_mtl_train_step(frozen_q=...): the frozen layers then run on K1/K2
    inside the train step."""
    k = max(0, min(int(freeze_below), cfg.backbone.layers))
    bb = params["backbone"]
    scales = calibrate_siglip_act_scales(bb, cfg.backbone, calib_pixels,
                                         policy)
    q = quantize_siglip_static(bb, scales, cfg.backbone)
    # copies: the float leaves (LN, biases) would otherwise be views of the
    # trained master tensors
    return add_kernel_layout(tree_map(lambda a: a[:k].clone(), q["blocks"]))


def make_mtl_train_step(cfg: MTLConfig, optimizer, policy, *,
                        freeze_below: int | None = 21,
                        seg_loss="combined", accum_steps: int = 1,
                        frozen_q=None, kernels: KernelSet = KERNELS):
    """Returns (init_fn, step_fn); step(state, batch, generator, cls_w,
    seg_w) → (state, metrics).

    Gradient accumulation: the batch's leading dim is accum_steps ×
    micro-batch; the micro-batches' gradients are averaged before one
    optimizer update. frozen_q: a quantize_frozen_prefix output, the
    frozen prefix on the W8A8 kernels (requires freeze_below). generator
    feeds the class head's dropout, whose rate is 0 here as in JAX."""
    if frozen_q is not None and not freeze_below:
        raise ValueError("frozen_q requires freeze_below")
    sgb = freeze_below if freeze_below is not None else 0

    def _leaves(params):
        if freeze_below is None:
            return [(leaf, 0) for _, leaf in _paths(params)]
        mask, layers = make_freeze_mask(params, cfg, freeze_below)
        return trainable_leaves(params, mask, layers)

    def init_fn(params):
        leaves = _leaves(params)
        for _, leaf in _paths(params):
            leaf.requires_grad_(False)
        for leaf, _ in leaves:
            leaf.requires_grad_(True)
        return MTLTrainState(params, optimizer.init(
            [leaf.detach()[r:] for leaf, r in leaves]), 0)

    def step(state: MTLTrainState, batch, generator, cls_w, seg_w):
        params = state.params
        leaves = _leaves(params)
        for leaf, _ in leaves:
            leaf.grad = None
        micro = [{k: v.reshape((accum_steps, -1) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(accum_steps)]
        metrics = []
        for mb in micro:
            loss, m = mtl_loss_fn(params, mb, cfg, policy, cls_w, seg_w,
                                  seg_loss, generator=generator,
                                  stop_grad_below=sgb,
                                  frozen_blocks_q=frozen_q, kernels=kernels)
            loss.backward()
            metrics.append({k: v.detach() for k, v in m.items()})
        for leaf, _ in leaves:
            if leaf.grad is None:        # a leaf no loss term reached
                leaf.grad = torch.zeros_like(leaf)
            elif accum_steps > 1:
                leaf.grad.div_(accum_steps)
        opt_state, _ = optimizer.update(
            [leaf.grad[r:] for leaf, r in leaves], state.opt_state,
            [leaf.detach()[r:] for leaf, r in leaves])
        metrics = {k: torch.stack([m[k] for m in metrics]).mean()
                   for k in metrics[0]}
        return MTLTrainState(params, opt_state, state.step + 1), metrics

    return init_fn, step


def make_mtl_eval_step(cfg: MTLConfig, policy, kernels: KernelSet = KERNELS):
    """eval(params, pixels) → (cls_logits, seg_probs)."""
    @torch.no_grad()
    def step(params, pixels):
        cls_logits, seg_logits = mtl_forward(params, pixels, cfg, policy,
                                             kernels=kernels)
        return cls_logits, torch.sigmoid(seg_logits)
    return step
