"""Optimizer and train state (tpudf/train/steps.py) on PyTorch tensors.

`make_optimizer` is optax's `chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))`
written out, step for step: the global-norm clip, Adam's moments with
bias correction, the decoupled weight decay added to the update, and the
learning rate taken from the schedule at the count BEFORE the step (so
the first update of a warmup from 0 has lr 0, as in optax). It updates the
parameters in place (`_foreach` ops, a few launches for all leaves) where
optax returns new ones.

`make_binary_train_step` (EMA, mixup) and `kind="adafactor"` are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


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
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # g / |g| * clip above the clip, g itself below it
        clip = torch.where(norm < self.grad_clip, 1.0,
                           self.grad_clip / norm)
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


def make_optimizer(lr=1e-4, weight_decay=1e-4, warmup_steps=100,
                   total_steps=10_000, grad_clip=1.0, kind="adamw"):
    """AdamW + warmup-cosine, the JAX package's default optimizer."""
    if kind != "adamw":
        raise NotImplementedError(f"optimizer kind {kind!r} is not ported "
                                  "(only adamw)")
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    return AdamW(sched, weight_decay, grad_clip)
