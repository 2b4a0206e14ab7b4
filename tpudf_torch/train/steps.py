"""Optimizers, train state and the binary classifier's steps
(tpudf/train/steps.py) on PyTorch tensors.

`make_optimizer` is optax's `chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))`
written out, step for step: the global-norm clip, Adam's moments with
bias correction, the decoupled weight decay added to the update, and the
learning rate taken from the schedule at the count BEFORE the step (so
the first update of a warmup from 0 has lr 0, as in optax). It updates the
parameters in place (`_foreach` ops, a few launches for all leaves) where
optax returns new ones. `kind="adafactor"` writes out optax's `adafactor`
the same way (`Adafactor`).

The binary steps (`make_binary_train_step`, `make_binary_eval_step`) are
eager and update the state in place: the tower (frozen by default, run
without autograd as JAX's stop_gradient; or trained with the head,
`train_backbone`) → the v5 or fast head → BCE; mixup on the batch and the
head's dropout draw from the step's torch.Generator; the EMA of the
trainable leaves is updated in place after each step.

The smaller trainers (the experts, the video head, the face nets) share
`adam` (optax's adam / adamw at a constant rate), `trainable` (an f32
copy of a tree that takes gradients), `fit_step` (one in-place step of a
loss on a tree) and `frozen_copy`.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from tpudf_torch.core.precision import DEFAULT_POLICY, Policy, tree_map
from tpudf_torch.models.heads import apply_binary_head, apply_fast_binary_head
from tpudf_torch.models.siglip import SigLIPConfig, siglip_forward
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.train.losses import (bce_with_logits, mixup_apply,
                                      mixup_draws)


class TrainState(NamedTuple):
    params: Any          # trainable params (head, and optionally backbone)
    opt_state: Any
    ema: Any             # EMA of trainable params (or None)
    step: int


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """optax.warmup_cosine_decay_schedule: a linear warmup from init_value
    to peak_value over warmup_steps, then a cosine decay to end_value at
    decay_steps (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    return schedule


class AdamW:
    """clip_by_global_norm(grad_clip) → AdamW(schedule, weight_decay) on a
    list of f32 tensors. `init(params)` returns the state; `update(grads,
    state, params)` adds the update to each parameter in place and returns
    the new state and the global gradient norm."""

    grad_sync = None

    def __init__(self, schedule, weight_decay, grad_clip, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, state, params):
        # g / |g| * clip above the clip, g itself below it
        grads, norm, clip = _global_clip(self, grads)
        g = torch._foreach_mul(grads, clip)
        mu = torch._foreach_mul(state["mu"], self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        nu = torch._foreach_mul(state["nu"], self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return {"count": count, "mu": mu, "nu": nu}, norm


def global_norm(grads):
    """The L2 norm of a list of tensors taken together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _global_clip(opt, grads):
    """(grads, the global gradient norm, the factor of
    clip_by_global_norm). `opt.grad_sync`, which a ShardedTrainer
    (parallel/training.py) installs on the optimizer its step was built
    with for the length of that step, first averages the gradients over the data axis and gives the
    norm over the whole tensor-parallel model."""
    if opt.grad_sync is None:
        norm = global_norm(grads)
    else:
        grads, norm = opt.grad_sync(grads)
    return (grads, norm,
            torch.where(norm < opt.grad_clip, 1.0, opt.grad_clip / norm))


def _factored_dims(shape):
    """optax's choice of a factored second moment: (d1, d0), the second
    largest and the largest axis, when the second largest has at least 128
    entries; None otherwise."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """clip_by_global_norm(grad_clip) → optax.adafactor(schedule,
    weight_decay_rate=weight_decay) on a list of f32 tensors, optax's
    defaults written out: per leaf, g² + 1e-30 into a second moment with
    decay 1 − (t + 1)^-0.8, factored into row and column means over the two
    largest axes when the second largest has ≥ 128 entries, the update g /
    √v̂ clipped to a block rms of 1, times the learning rate, times the
    parameter's rms (at least 1e-3), plus weight_decay · p (not scaled by
    the learning rate: optax adds the decay after the lr), subtracted from
    the parameter in place."""

    grad_sync = None

    def __init__(self, schedule, weight_decay, grad_clip):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.grad_clip = grad_clip

    def init(self, params):
        moments = []
        for p in params:
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                moments.append({"v": torch.zeros_like(p)})
                continue
            d1, d0 = dims
            moments.append({"v_row": torch.zeros_like(p.select(d0, 0)),
                            "v_col": torch.zeros_like(p.select(d1, 0))})
        return {"count": 0, "moments": moments}

    @torch.no_grad()
    def update(self, grads, state, params):
        grads, norm, clip = _global_clip(self, grads)
        count = state["count"]
        lr = self.schedule(count)
        beta = 1.0 - torch.tensor(count + 1, dtype=torch.float32) ** -0.8
        moments = []
        for g, p, m in zip(grads, params, state["moments"]):
            g = g * clip
            beta_ = beta.to(g.device)
            g2 = g * g + 1e-30
            if "v" in m:
                v = beta_ * m["v"] + (1.0 - beta_) * g2
                u = g * v ** -0.5
                moments.append({"v": v})
            else:
                d1, d0 = _factored_dims(tuple(p.shape))
                vr = beta_ * m["v_row"] + (1.0 - beta_) * g2.mean(d0)
                vc = beta_ * m["v_col"] + (1.0 - beta_) * g2.mean(d1)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(rd1, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
                moments.append({"v_row": vr, "v_col": vc})
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)), min=1.0)
            u = u * lr
            p_rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3),
                                p_rms)
            u = u + self.weight_decay * p
            p.sub_(u)
        return {"count": count + 1, "moments": moments}, norm


def make_optimizer(lr=1e-4, weight_decay=1e-4, warmup_steps=100,
                   total_steps=10_000, grad_clip=1.0, kind="adamw"):
    """AdamW (the JAX package's default) or Adafactor (kind="adafactor",
    its memory-lean state: factored second moments) after a global-norm
    clip, on a warmup-cosine schedule."""
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    if kind == "adafactor":
        return Adafactor(sched, weight_decay, grad_clip)
    if kind != "adamw":
        raise ValueError(f"optimizer kind {kind!r}: adamw or adafactor")
    return AdamW(sched, weight_decay, grad_clip)


def tensor_leaves(tree):
    """The tensor leaves of a nested dict / list tree in a fixed order
    (dict insertion order); other leaves (the fast head's "size" and
    "heads") are static and left out."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def adam(lr, weight_decay=0.0):
    """optax.adamw(lr, weight_decay) (optax.adam at weight_decay 0): the
    port's AdamW at a constant rate, with no gradient clip."""
    return AdamW(lambda count: lr, weight_decay, math.inf)


def trainable(params, device):
    """A trainable f32 copy of a parameter tree on `device`."""
    out = tree_map(lambda t: torch.as_tensor(t).detach().to(
        device, torch.float32).clone(), params)
    for leaf in tensor_leaves(out):
        leaf.requires_grad_(True)
    return out


def fit_step(params, opt, opt_state, loss_fn):
    """One optimizer step of loss_fn(params) on the tree's tensor leaves,
    in place; returns (the new optimizer state, the loss)."""
    leaves = tensor_leaves(params)
    for leaf in leaves:
        leaf.grad = None
    loss = loss_fn(params)
    loss.backward()
    grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
             for leaf in leaves]
    opt_state, _ = opt.update(grads, opt_state,
                              [leaf.detach() for leaf in leaves])
    return opt_state, loss.detach()


def frozen_copy(params):
    """A detached copy of a parameter tree."""
    return tree_map(lambda t: t.detach().clone(), params)


def init_train_state(params, optimizer, ema_decay=None):
    """The state of a binary trainer: `params` (the head, or {"backbone",
    "head"}) made trainable in place, the optimizer state over their
    tensor leaves, and an EMA copy when ema_decay is set."""
    leaves = tensor_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    ema = (tree_map(lambda t: t.detach().clone() if torch.is_tensor(t)
                    else t, params) if ema_decay else None)
    return TrainState(params, optimizer.init([t.detach() for t in leaves]),
                      ema, 0)


def _apply_head(head_kind, kernels):
    if head_kind == "v5":
        return apply_binary_head
    return lambda p, f, generator=None: apply_fast_binary_head(
        p, f, generator=generator, kernels=kernels)


def binary_forward(backbone_params, head_params, pixels, cfg: SigLIPConfig,
                   policy: Policy = DEFAULT_POLICY, head_kind="v5",
                   kernels: KernelSet = KERNELS):
    """Frozen-backbone binary logits: (B, H, W, 3) → (B,); the tower runs
    without autograd (JAX's stop_gradient on the features)."""
    with torch.no_grad():
        feats = siglip_forward(backbone_params, pixels, cfg, policy,
                               kernels=kernels)["pooled"]
    return _apply_head(head_kind, kernels)(head_params, feats)


def make_binary_train_step(cfg: SigLIPConfig, optimizer,
                           policy: Policy = DEFAULT_POLICY, head_kind="v5",
                           ema_decay: float | None = None,
                           mixup_alpha: float = 0.0,
                           train_backbone: bool = False,
                           tome_r: int = 0, tome_floor: int = 0,
                           kernels: KernelSet = KERNELS):
    """Returns step(state, backbone_params, batch, generator) → (state,
    metrics); the state's parameters, optimizer state and EMA are updated
    in place, and after a step each trainable leaf's `.grad` holds that
    step's gradient.

    batch = {"pixels": (B, H, W, 3), "labels": (B,) float 0/1}. With
    train_backbone=True, `state.params` is {"backbone": ..., "head": ...}
    (the backbone as f32 masters) and gradients flow into the tower; else
    `state.params` is the head and `backbone_params` the frozen tower (as
    `siglip.tower_params` or a quantised tree give it). tome_r / tome_floor
    (frozen backbone only): the features with ToMe merging, the deployed
    serving features. generator: mixup's draws (`mixup_draws`), then the
    head's dropout; None runs neither."""
    if tome_r and train_backbone:
        raise ValueError("tome_r is a frozen-backbone feature-extraction "
                         "mode (inference-only tower path)")
    apply = _apply_head(head_kind, kernels)

    def loss_fn(trainable, backbone_params, pixels, labels, generator):
        if train_backbone:
            bb, head = trainable["backbone"], trainable["head"]
        else:
            bb, head = backbone_params, trainable
        with torch.set_grad_enabled(train_backbone):
            feats = siglip_forward(bb, pixels, cfg, policy, tome_r=tome_r,
                                   tome_floor=tome_floor,
                                   kernels=kernels)["pooled"]
        z = apply(head, feats, generator=generator)
        loss = bce_with_logits(z, labels)
        acc = torch.mean(((z > 0) == (labels > 0.5)).float())
        return loss, acc

    def step(state: TrainState, backbone_params, batch, generator=None):
        pixels, labels = batch["pixels"], batch["labels"]
        if mixup_alpha > 0 and generator is not None:
            lam, perm = mixup_draws(generator, pixels.shape[0], mixup_alpha)
            pixels, labels = mixup_apply(pixels, labels, lam, perm,
                                         rows=generator)
        leaves = tensor_leaves(state.params)
        for leaf in leaves:
            leaf.grad = None
        loss, acc = loss_fn(state.params, backbone_params, pixels, labels,
                            generator)
        loss.backward()
        for leaf in leaves:
            if leaf.grad is None:        # a leaf the loss does not reach
                leaf.grad = torch.zeros_like(leaf)
        opt_state, norm = optimizer.update(
            [leaf.grad for leaf in leaves], state.opt_state,
            [leaf.detach() for leaf in leaves])
        if state.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(tensor_leaves(state.ema), ema_decay)
                torch._foreach_add_(tensor_leaves(state.ema),
                                    [leaf.detach() for leaf in leaves],
                                    alpha=1 - ema_decay)
        return (TrainState(state.params, opt_state, state.ema,
                           state.step + 1),
                {"loss": loss.detach(), "acc": acc, "grad_norm": norm})

    return step


def make_binary_eval_step(cfg: SigLIPConfig, policy: Policy = DEFAULT_POLICY,
                          head_kind="v5", kernels: KernelSet = KERNELS):
    """eval(head_params, backbone_params, pixels) → (B,) logits, no
    dropout."""
    @torch.no_grad()
    def step(head_params, backbone_params, pixels):
        return binary_forward(backbone_params, head_params, pixels, cfg,
                              policy, head_kind, kernels=kernels)
    return step
