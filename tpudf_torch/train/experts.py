"""Expert-stack preparation (tpudf/train/experts.py): the frequency MLP,
the adaptive fusion head and the CORAL fit.

Re-designs the reference artifact pipeline (SURVEY.md §3.5):
  (2) "FreqMLP trainer.py":330-397 — the frequency MLP on 24-d features
      (BCE, AdamW, best-AUC selection on a held-out split)
  (3) train_fusion_head_only.py:361-456 — (z_freq, z_sig) logits of the
      corpus, then the AdaptiveFusionHead trained on them
  (4) coral.py:329-400 — quantile cutpoints + temperature of the stack's
      fused logits on a calibration set

The features are the batched device graph (ops/fft_features.py, its SRM
moments on kernel K3 on the card). optax's adamw / adam are the port's
`AdamW` at a constant rate with no clip (weight decay 0 for Adam). The
epoch orders and the val split come from np.random.default_rng(seed) as in
JAX, so they are the same numbers; the initial parameters come from a
torch.Generator(seed) unless the caller hands them in (`params=`), and the
v5 expert's dropout draws from a torch.Generator seeded per step as JAX
keys it (epoch · 10000 + batch start).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpudf_torch.calib.coral import fit_coral_cutpoints, fit_temperature
from tpudf_torch.core.precision import tree_map
from tpudf_torch.eval.metrics import roc_auc
from tpudf_torch.models.freq_mlp import (apply_freq_mlp, apply_freq_mlp_v5,
                                         fit_freq_normalizer, init_freq_mlp,
                                         init_freq_mlp_v5)
from tpudf_torch.models.fusion import (apply_adaptive_fusion,
                                       init_adaptive_fusion)
from tpudf_torch.ops.fft_features import extract_freq_vector
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.train.losses import bce_with_logits
from tpudf_torch.train.steps import (adam, fit_step, frozen_copy,
                                     tensor_leaves, trainable)


def extract_freq_matrix(gray_batches, device="cuda",
                        kernels: KernelSet = KERNELS):
    """(B, 256, 256) [0,1] grayscale batches → (N, 24) features (numpy),
    each batch one device pass ("FreqMLP trainer.py":209)."""
    out = []
    with torch.inference_mode():
        for g in gray_batches:
            g = torch.as_tensor(g, dtype=torch.float32, device=device)
            out.append(extract_freq_vector(g, kernels).cpu().numpy())
    return np.concatenate(out, axis=0)


def train_freq_mlp(features, labels, *, v5=True, epochs=60, lr=1e-3,
                   batch_size=256, weight_decay=1e-4, seed=0, val_frac=0.15,
                   log_fn=print, params=None, device="cuda"):
    """Train the frequency expert; returns (params, best_auc): AdamW + BCE,
    the parameters of the best val-AUC epoch ("FreqMLP trainer.py"
    :330-397). params: the initial tree (default drawn from
    torch.Generator(seed)); the v5 normalizer is fitted on the train split
    either way, as in JAX."""
    rng = np.random.default_rng(seed)
    n = len(features)
    perm = rng.permutation(n)
    n_val = max(int(n * val_frac), 1)
    va, tr = perm[:n_val], perm[n_val:]
    X = torch.as_tensor(np.asarray(features, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels, np.float32), device=device)
    y_np = np.asarray(labels, np.float32)

    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_freq_mlp_v5(gen) if v5 else init_freq_mlp(gen)
    params = tree_map(lambda t: torch.as_tensor(t).to(device, torch.float32),
                      params)
    if v5:
        params = fit_freq_normalizer(params,
                                     X[torch.as_tensor(tr, device=device)])
    params = trainable(params, device)
    apply = apply_freq_mlp_v5 if v5 else apply_freq_mlp
    opt = adam(lr, weight_decay)
    opt_state = opt.init([t.detach() for t in tensor_leaves(params)])

    best_auc, best_params = -1.0, frozen_copy(params)
    for epoch in range(epochs):
        order = rng.permutation(tr)
        losses = []
        for s in range(0, len(order), batch_size):
            idx = torch.as_tensor(order[s:s + batch_size], device=device)
            xb, yb = X[idx], y[idx]
            gen = (torch.Generator(device=device).manual_seed(
                epoch * 10000 + s) if v5 else None)
            opt_state, loss = fit_step(
                params, opt, opt_state,
                lambda p: bce_with_logits(
                    apply(p, xb, gen) if v5 else apply(p, xb), yb))
            losses.append(float(loss))
        with torch.no_grad():
            z_val = apply(params, X[torch.as_tensor(va, device=device)])
        auc = roc_auc(y_np[va], z_val.cpu().numpy())
        if np.isfinite(auc) and auc > best_auc:
            best_auc, best_params = auc, frozen_copy(params)
        if epoch % 10 == 0:
            log_fn(f"[freq epoch {epoch}] loss={np.mean(losses):.4f} "
                   f"val_auc={auc:.4f} best={best_auc:.4f}")
    return best_params, best_auc


def precompute_expert_logits(z_sig_fn, freq_params, gray_batches,
                             pixel_batches, v5=False, device="cuda",
                             kernels: KernelSet = KERNELS):
    """The corpus pass: (z_freq, z_sig) numpy pairs
    (train_fusion_head_only.py:397-400); z_sig_fn(pixels) → (B,) logits."""
    apply = apply_freq_mlp_v5 if v5 else apply_freq_mlp
    z_freqs, z_sigs = [], []
    with torch.inference_mode():
        for gray, px in zip(gray_batches, pixel_batches):
            g = torch.as_tensor(gray, dtype=torch.float32, device=device)
            z_freqs.append(apply(freq_params, extract_freq_vector(
                g, kernels)).cpu().numpy())
            z_sigs.append(torch.as_tensor(z_sig_fn(px)).float().cpu()
                          .numpy())
    return np.concatenate(z_freqs), np.concatenate(z_sigs)


def train_fusion_head(z_freq, z_sig, labels, *, epochs=200, lr=5e-3,
                      batch_size=512, seed=0, log_fn=print, params=None,
                      device="cuda"):
    """Train the AdaptiveFusionHead on precomputed logits with Adam
    (train_fusion_head_only.py:404-447); params: the initial tree (default
    drawn from torch.Generator(seed))."""
    X_f = torch.as_tensor(np.asarray(z_freq, np.float32), device=device)
    X_s = torch.as_tensor(np.asarray(z_sig, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels, np.float32), device=device)
    if params is None:
        params = init_adaptive_fusion(torch.Generator().manual_seed(seed))
    params = trainable(params, device)
    opt = adam(lr)
    opt_state = opt.init([t.detach() for t in tensor_leaves(params)])

    rng = np.random.default_rng(seed)
    n = len(z_freq)
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n, batch_size):
            idx = torch.as_tensor(order[s:s + batch_size], device=device)
            zf, zs, yb = X_f[idx], X_s[idx], y[idx]
            opt_state, loss = fit_step(
                params, opt, opt_state,
                lambda p: bce_with_logits(apply_adaptive_fusion(p, zf, zs),
                                          yb))
            losses.append(float(loss))
        if epoch % 50 == 0:
            log_fn(f"[fusion epoch {epoch}] loss={np.mean(losses):.4f}")
    return frozen_copy(params)


@dataclasses.dataclass
class CoralFit:
    cutpoints: list
    temperature: float
    bins_histogram: np.ndarray


def fit_coral(fused_logits, labels=None, fit_temp=True) -> CoralFit:
    """CORAL artifacts from calibration-set fused logits (coral.py
    :376-400): quantile cutpoints, the NLL temperature when labels are
    given, and the 50-bin histogram saved as coral_bins.npy."""
    cuts = fit_coral_cutpoints(fused_logits)
    temp = 1.0
    if fit_temp and labels is not None:
        temp = fit_temperature(fused_logits, labels)
    bins = np.histogram(np.asarray(fused_logits), bins=50)[0]
    return CoralFit(cuts, temp, bins)
