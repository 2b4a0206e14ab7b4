"""Few-shot adaptation + embedding anomaly over frozen SigLIP features
(tpudf/serve/adapt.py).

  * prototype classifier — softmax over −distance/T to the class means
    (inference_deepfakeface_complete.py:904-925,
     inference_ai_human_images.py:436-543 "100-shot prototype adaptation")
  * linear probe — ridge-regularized logistic probe trained on support
    features (inference_deepfakeface_complete.py:949-1013)
  * kernel probe — RBF-kernel logistic classifier, the stand-in for the
    reference's SVM-RBF (:927-947)
  * embedding anomaly — L2-norm + cosine deviation from the cached
    mean-real embedding (appv3.py:3494-3516, 1306-1370)

Features are numpy arrays or tensors; everything runs in f32 on the
features' device (a numpy array: the CPU), with TF32 off
(`ops.forensics.f32_math`). The probes train with `torch.optim.Adam` at
the JAX package's settings (optax.adam: the same lr, betas, eps), from
zeros, for the same number of full-batch steps on the same loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudf_torch.ops.forensics import f32_math


def _f32(x, device=None):
    """x as an f32 tensor: on its own device, or `device` if given."""
    t = torch.as_tensor(x)
    return t.to(device=device if device is not None else t.device,
                dtype=torch.float32)


def _bce(z, y):
    """Mean binary cross-entropy of logits z against targets y."""
    return -torch.mean(y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z))


def _adam(params, loss_fn, steps, lr):
    """`steps` full-batch Adam steps on loss_fn(), in place."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss_fn().backward()
            opt.step()


def prototype_classify(support_feats, support_labels, query_feats,
                       temperature=0.1, num_classes=2):
    """Nearest-prototype soft classification.
    support_feats: (N, D) L2-normalized; query_feats: (Q, D).
    Returns (Q, C) probabilities."""
    s = _f32(support_feats)
    y = _f32(support_labels, s.device)
    q = _f32(query_feats, s.device)
    with f32_math():
        protos = []
        for c in range(num_classes):
            mask = (y == c).float()
            protos.append(torch.sum(s * mask[:, None], dim=0)
                          / (torch.sum(mask) + 1e-8))
        protos = torch.stack(protos)                         # (C, D)
        d = torch.linalg.vector_norm(q[:, None] - protos[None], dim=-1)
        return torch.softmax(-d / temperature, dim=-1)


def train_linear_probe(support_feats, support_labels, *, steps=300, lr=1e-2,
                       l2=1e-3, seed=0):
    """Logistic linear probe on frozen features; returns {"w", "b"}.
    `seed` is kept for the JAX signature: the probe starts at zeros."""
    X = _f32(support_feats)
    y = _f32(support_labels, X.device)
    w = torch.zeros(X.shape[1], device=X.device, requires_grad=True)
    b = torch.zeros((), device=X.device, requires_grad=True)
    with f32_math():
        _adam([w, b], lambda: _bce(X @ w + b, y) + l2 * torch.sum(w ** 2),
              steps, lr)
    return {"w": w.detach(), "b": b.detach()}


def linear_probe_predict(params, query_feats):
    q = _f32(query_feats, params["w"].device)
    with f32_math():
        return torch.sigmoid(q @ params["w"] + params["b"])


def _rbf(a, b, gamma):
    """exp(-gamma |a_i - b_j|²) by the expanded square, as JAX computes it."""
    sq_a = torch.sum(a ** 2, 1)
    sq_b = torch.sum(b ** 2, 1)
    return torch.exp(-gamma * (sq_a[:, None] + sq_b[None] - 2 * a @ b.T))


def train_kernel_probe(support_feats, support_labels, *, gamma=None,
                       steps=300, lr=5e-2, l2=1e-3):
    """RBF-kernel logistic classifier (SVM-RBF stand-in): learns dual
    coefficients over the support kernel matrix, with the
    l2 · alpha K alpha penalty."""
    X = _f32(support_feats)
    y = _f32(support_labels, X.device)
    n, d = X.shape
    if gamma is None:
        gamma = 1.0 / d
    alpha = torch.zeros(n, device=X.device, requires_grad=True)
    b = torch.zeros((), device=X.device, requires_grad=True)
    with f32_math():
        K = _rbf(X, X, gamma)
        _adam([alpha, b], lambda: _bce(K @ alpha + b, y)
              + l2 * (alpha @ K @ alpha), steps, lr)
    return {"alpha": alpha.detach(), "b": b.detach(), "X": X,
            "gamma": gamma}


def kernel_probe_predict(model, query_feats):
    q = _f32(query_feats, model["X"].device)
    with f32_math():
        K = _rbf(q, model["X"], model["gamma"])
        return torch.sigmoid(K @ model["alpha"] + model["b"])


# -------------------------------------------------------- embedding anomaly

def mean_real_embedding(real_feats):
    """The mean L2-normalized real embedding, normalized (appv3.py
    REAL_REF_DIR / mean_real_embedding.npy equivalent)."""
    f = _f32(real_feats)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-6)
    mu = torch.mean(f, dim=0)
    return mu / (torch.linalg.vector_norm(mu) + 1e-6)


def embedding_anomaly_score(feats, mean_real=None):
    """L2-norm spread + cosine deviation from the real-embedding anchor
    (appv3.py:3494-3516). Returns (B,) in [0,1]."""
    f = _f32(feats)
    norms = torch.linalg.vector_norm(f, dim=-1)
    norm_dev = torch.clamp(torch.abs(norms - torch.mean(norms))
                           / (torch.std(norms, correction=0) + 1e-6) / 4.0,
                           0.0, 1.0)
    if mean_real is None:
        return norm_dev
    with f32_math():
        cos = (f / (norms[:, None] + 1e-6)) @ _f32(mean_real, f.device)
    cos_dev = torch.clamp((1.0 - cos) / 0.6, 0.0, 1.0)
    return torch.clamp(0.4 * norm_dev + 0.6 * cos_dev, 0.0, 1.0)
