"""Bridge from a numpy copy of a `tpudf` params pytree to this package.

`params_from_numpy(tree, device)` turns nested dicts/lists of numpy arrays
(the backbone, float or static-int8 with its `act_scales`, the head, the
frequency MLP, the fusion or None, and CORAL cutpoints under "cuts") into
tensors on `device`, keeping JAX's layout:
(in, out) weights, {q, scale} int8 leaves, block leaves stacked on L. The
one kernel-private layout, the (out, in) int8 weight `qT` the GEMM kernel
reads, is derived here once (`add_kernel_layout`); `params_to_numpy` drops
it again.

Multi-task (MTL) trees — {"backbone", "cls_head", "decoder"} — cross the
same way and unchanged: the SegFormer decoder's convolution weights stay in
JAX's HWIO layout (a depthwise weight (3, 3, 1, e)), and
`models/segformer.py` hands F.conv2d an OIHW view of them ((e, 1, 3, 3)),
so nothing is transposed here and a tree round-trips exactly.

The trainers' small trees have named helpers that check the tree's keys
before they convert it (f32 tensors on `device`, JAX's layout):
`video_head_from_numpy` (init_video_head's), `adaptive_fusion_from_numpy`
(init_adaptive_fusion's) and `freq_mlp_v5_from_numpy` (init_freq_mlp_v5's,
its scalar temperature a 0-d tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.calib.coral import CoralCutpoints
from tpudf_torch.core.precision import tree_map

KERNEL_ONLY = ("qT",)


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def add_kernel_layout(tree):
    """Add `qT` = q transposed to (out, in), contiguous, to every int8
    {q, scale} leaf of the tree."""
    if isinstance(tree, dict):
        out = {k: add_kernel_layout(v) for k, v in tree.items()}
        q = out.get("q")
        if torch.is_tensor(q) and q.dtype == torch.int8 and "scale" in out:
            out["qT"] = q.transpose(-1, -2).contiguous()
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(add_kernel_layout(v) for v in tree)
    return tree


def params_from_numpy(tree, device):
    """numpy pytree (dicts/lists of arrays, None leaves kept) → tensors on
    device, plus the kernel layout. A "cuts" entry with `cuts` and
    `temperature` attributes (the JAX package's CoralCutpoints) becomes
    this package's CoralCutpoints."""
    cuts = tree.get("cuts") if isinstance(tree, dict) else None
    if hasattr(cuts, "temperature"):
        out = params_from_numpy({k: v for k, v in tree.items()
                                 if k != "cuts"}, device)
        out["cuts"] = CoralCutpoints(tuple(float(c) for c in cuts.cuts),
                                     float(cuts.temperature))
        return out
    return add_kernel_layout(tree_map(
        lambda a: None if a is None else _to_tensor(a, device), tree))


def params_to_numpy(tree):
    """Inverse of params_from_numpy (bf16 leaves come back as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()
                if k not in KERNEL_ONLY}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def _keyed_f32(tree, device, keys, what):
    if not isinstance(tree, dict) or set(tree) != set(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"not a {what} tree: keys {got}, expected "
                         f"{sorted(keys)}")
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(device), tree)


def video_head_from_numpy(tree, device):
    """JAX's init_video_head tree {ln, fc1, fc2, fc3} as tensors."""
    return _keyed_f32(tree, device, ("ln", "fc1", "fc2", "fc3"),
                      "video head")


def adaptive_fusion_from_numpy(tree, device):
    """JAX's init_adaptive_fusion tree {fc1, fc2, temp} as tensors."""
    return _keyed_f32(tree, device, ("fc1", "fc2", "temp"),
                      "adaptive fusion head")


def freq_mlp_v5_from_numpy(tree, device):
    """JAX's init_freq_mlp_v5 tree {norm_mean, norm_std, contrast, gates,
    blocks, head, temp} as tensors."""
    return _keyed_f32(tree, device, ("norm_mean", "norm_std", "contrast",
                                     "gates", "blocks", "head", "temp"),
                      "v5 frequency MLP")


def engine_from_numpy(src, device, policy=None):
    """The port's DetectEngine holding what another DetectEngine holds (the
    JAX package's: its arrays read with np.asarray): the config by field
    values, the parameter trees (params_from_numpy), the CORAL cutpoints
    with their temperature, the ToMe schedules, and the report's artifacts
    (mean_real; a TreeEnsemble by its tables; a BayesCalibration by its
    JSON form), on `device`. policy: the port's DEFAULT_POLICY unless
    given."""
    import dataclasses

    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.fuse.bayesian import BayesCalibration
    from tpudf_torch.models.fusion import TreeEnsemble
    from tpudf_torch.models.siglip import SigLIPConfig
    from tpudf_torch.serve.engine import DetectEngine

    cfg = SigLIPConfig(**{f.name: getattr(src.cfg, f.name)
                          for f in dataclasses.fields(SigLIPConfig)})
    p = params_from_numpy({**{k: getattr(src, k) for k in (
        "backbone", "head", "freq", "fusion")}, "cuts": src.cuts}, device)
    gbdt = src.gbdt
    if gbdt is not None:
        gbdt = TreeEnsemble(*(np.asarray(getattr(gbdt, k)) for k in (
            "feats", "thresh", "left", "right", "leaf")),
            base_score=gbdt.base_score, platt_a=gbdt.platt_a,
            platt_b=gbdt.platt_b).to(device)
    calib = src.bayes_calibration
    if calib is not None:
        calib = BayesCalibration.from_json(calib.to_json()).to(device)
    mean_real = (None if src.mean_real is None
                 else np.asarray(src.mean_real, np.float32))
    return DetectEngine(
        cfg=cfg, policy=policy or DEFAULT_POLICY, **p,
        tome_r=src.tome_r, tome_floor=src.tome_floor,
        patch_tome_r=src.patch_tome_r, patch_tome_floor=src.patch_tome_floor,
        mean_real=mean_real, gbdt=gbdt, bayes_calibration=calib)
