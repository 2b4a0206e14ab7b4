"""Expert fusion (tpudf/models/fusion.py): the deployed Linear(2→1) head
over (p_sig, p_freq), the AdaptiveFusionHeadV5 ([z_freq, z_sig, |Δ|] →
MLP(3→32→2) → softmax weights → weighted logit sum → temperature,
appv3.py:1543-1562, train_fusion_head_only.py:303-317) and the GBDT fusion
evaluator (`TreeEnsemble`, the
XGBoost-style override over the 19-d meta-feature vector + Platt scale,
appv3.py:1427-1477, 5507-5578)."""

from __future__ import annotations

import json

import numpy as np
import torch

from tpudf_torch.models.heads import gelu_exact
from tpudf_torch.utils.nn import mm
from tpudf_torch.utils.safetensors_io import load_file


def init_fusion_linear(generator: torch.Generator):
    return {"w": torch.randn((2, 1), generator=generator) * 0.5,
            "b": torch.zeros(1)}


def apply_fusion_linear(params, p_sig, p_freq):
    """(…,) probabilities → fused logit."""
    x = torch.stack([p_sig, p_freq], dim=-1)
    return (mm(x, params["w"]) + params["b"])[..., 0]


def fusion_linear_from_safetensors(path, device="cpu"):
    """The deployed artifact siglip/fusion_head.safetensors (fc.weight
    (1, 2), fc.bias) as {"w": (2, 1), "b": (1,)} on `device`."""
    sd = load_file(path)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"w": t(sd["fc.weight"].T), "b": t(sd["fc.bias"])}


# --------------------------------------------------------- adaptive fusion

def init_adaptive_fusion(generator: torch.Generator, hidden=32):
    g = generator
    s = lambda i, o: torch.randn((i, o), generator=g) * i ** -0.5
    return {"fc1": {"w": s(3, hidden), "b": torch.zeros(hidden)},
            "fc2": {"w": s(hidden, 2), "b": torch.zeros(2)},
            "temp": torch.tensor(1.0)}


def apply_adaptive_fusion(params, z_freq, z_sig):
    """(…,) expert logits → (…,) fused logit: exact GELU, a softmax over
    the two expert weights, the weighted sum over the temperature."""
    diff = torch.abs(z_freq - z_sig)
    x = torch.stack([z_freq, z_sig, diff], dim=-1)
    h = gelu_exact(mm(x, params["fc1"]["w"]) + params["fc1"]["b"])
    w = torch.softmax(mm(h, params["fc2"]["w"]) + params["fc2"]["b"], dim=-1)
    z = w[..., 0] * z_freq + w[..., 1] * z_sig
    return z / (params["temp"] + 1e-6)


# -------------------------------------------------------------- GBDT eval

class TreeEnsemble:
    """A binary-classification GBDT (XGBoost JSON, or `train/gbdt.py`'s
    fit) evaluated on tensors (tpudf/models/fusion.py `TreeEnsemble`).

    Each tree is a row of (feature, threshold, left, right, leaf_value)
    tables; every sample descends `max_depth` times by `torch.gather`
    (leaves loop to themselves, so extra steps are no-ops), so a batch is
    a few gathers on its device, with no host round trip. `to(device)`
    moves the tables once."""

    def __init__(self, feats, thresh, left, right, leaf, base_score=0.0,
                 platt_a=1.0, platt_b=0.0):
        # tables shaped (n_trees, max_nodes)
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)
        self.feats = as_t(feats, torch.int64)
        self.thresh = as_t(thresh, torch.float32)
        self.left = as_t(left, torch.int64)
        self.right = as_t(right, torch.int64)
        self.leaf = as_t(leaf, torch.float32)
        self.base_score = float(base_score)
        self.platt_a = float(platt_a)
        self.platt_b = float(platt_b)
        self.max_depth = int(np.ceil(np.log2(self.feats.shape[1] + 1))) + 1

    def to(self, device):
        """The same ensemble with its tables on `device`."""
        out = TreeEnsemble.__new__(TreeEnsemble)
        out.__dict__.update(self.__dict__)
        for k in ("feats", "thresh", "left", "right", "leaf"):
            setattr(out, k, getattr(self, k).to(device))
        return out

    @classmethod
    def from_xgboost_json(cls, path, platt_path=None):
        with open(path) as f:
            model = json.load(f)
        learner = model["learner"]
        trees = learner["gradient_booster"]["model"]["trees"]
        base = float(learner["learner_model_param"].get("base_score", 0.5))
        n = len(trees)
        maxn = max(len(t["split_indices"]) for t in trees)
        feats = np.zeros((n, maxn), np.int32)
        thresh = np.zeros((n, maxn), np.float32)
        left = np.zeros((n, maxn), np.int32)
        right = np.zeros((n, maxn), np.int32)
        leaf = np.zeros((n, maxn), np.float32)
        for i, t in enumerate(trees):
            m = len(t["split_indices"])
            feats[i, :m] = t["split_indices"]
            thresh[i, :m] = t["split_conditions"]
            lc = np.asarray(t["left_children"])
            rc = np.asarray(t["right_children"])
            is_leaf = lc == -1
            # leaves: loop to self so extra walk steps are no-ops
            idx = np.arange(m)
            left[i, :m] = np.where(is_leaf, idx, lc)
            right[i, :m] = np.where(is_leaf, idx, rc)
            leaf[i, :m] = np.where(is_leaf, t["split_conditions"], 0.0)
            thresh[i, :m] = np.where(is_leaf, -np.inf, thresh[i, :m])
        pa, pb = 1.0, 0.0
        if platt_path is not None:
            with open(platt_path) as f:
                platt = json.load(f)
            pa, pb = float(platt.get("a", 1.0)), float(platt.get("b", 0.0))
        base_margin = (float(np.log(base / (1 - base))) if 0 < base < 1
                       else base)
        return cls(feats, thresh, left, right, leaf, base_margin, pa, pb)

    def margins(self, x):
        """x: (B, F) → (B,) raw ensemble margin."""
        b = x.shape[0]
        shape = (b, *self.feats.shape)

        def at(table, node):                            # (B, T)
            return torch.gather(table.expand(shape), 2,
                                node[..., None])[..., 0]

        node = torch.zeros((b, self.feats.shape[0]), dtype=torch.int64,
                           device=x.device)
        for _ in range(self.max_depth):
            xv = torch.gather(x, 1, at(self.feats, node))
            node = torch.where(xv < at(self.thresh, node),
                               at(self.left, node), at(self.right, node))
        return torch.sum(at(self.leaf, node), dim=1) + self.base_score

    def predict_proba(self, x):
        return torch.sigmoid(self.platt_a * self.margins(x) + self.platt_b)
