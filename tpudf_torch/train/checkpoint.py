"""Checkpoint save/restore (tpudf/train/checkpoint.py) with torch.save.

The JAX package writes orbax checkpoints; the card's machine has no orbax,
so the state (nested dicts and lists of tensors and numbers, e.g.
`MTLTrainState._asdict() | {"epoch": e}`) is written with `torch.save`,
tensors moved to the CPU, with the same JSON metrics sidecar. State from
the JAX package crosses over as a numpy tree through `convert.py`, not
through orbax files. Small heads are exported as flat safetensors files
(`save_head_safetensors`, the port's own writer), and a foreign state dict
is loaded into a template tree key by key (`load_state_filtered`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpudf_torch.core.precision import tree_map


def save_checkpoint(path: str, state, metrics: dict | None = None):
    """Write `state` to `path` (torch.save, CPU tensors) and `metrics` to
    `path + ".metrics.json"`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cpu = tree_map(lambda a: a.detach().cpu() if torch.is_tensor(a) else a,
                   state)
    tmp = path + ".tmp"
    torch.save(cpu, tmp)
    os.replace(tmp, path)
    if metrics is not None:
        with open(path + ".metrics.json", "w") as f:
            json.dump(_to_jsonable(metrics), f, indent=2)


def restore_checkpoint(path: str, device="cpu"):
    """The state `save_checkpoint` wrote, its tensors on `device`. Only
    tensors, containers and numbers are read back (weights_only)."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def restore_train_state(path: str, device="cpu"):
    """A binary trainer's checkpoint (`state._asdict() | {"epoch": e}`,
    what the CLIs' save_best writes) with or without an EMA slot: the
    restored dict (params, opt_state, ema — None when the run kept no EMA
    —, step, epoch), tensors on `device`. torch.save keeps the tree's
    structure, so no template is needed: JAX's version tries templates
    with and without the slot (inference_ai_human_images.py:804-827)."""
    if not os.path.exists(path):         # genuine I/O problems surface
        raise FileNotFoundError(path)
    state = restore_checkpoint(path, device)
    if not isinstance(state, dict) or not {"params", "opt_state",
                                           "step"} <= state.keys():
        raise ValueError(f"cannot restore train state from {path}")
    state.setdefault("ema", None)
    return state


def load_metrics(path: str) -> dict | None:
    p = path + ".metrics.json"
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def save_head_safetensors(path: str, params):
    """Flat safetensors export for small heads (fusion/freq), mirroring the
    reference artifact format: keys joined by dots, list indices as keys,
    every leaf a contiguous numpy array (safetensors writes the raw
    buffer, so a transposed view would be scrambled)."""
    from tpudf_torch.utils.safetensors_io import save_file
    save_file({k: np.ascontiguousarray(_numpy(v))
               for k, v in _flatten(params).items()}, path)


def load_state_filtered(sd, template, log_fn=print):
    """Strict→filtered state loading: each template leaf whose key is in
    `sd` with the same shape takes sd's value, on the template leaf's
    device and dtype; the others keep the template's; the rest is reported
    (appv3.py:1257-1263 `_filter_state_for_model` +
    inference_ai_human_images.py:841-857 non-strict fallback). Returns the
    template's structure."""
    flat_t = _flatten(template)
    flat_s = _flatten(sd)
    out = dict(flat_t)
    missing, mismatched, used = [], [], 0
    for k, v in flat_t.items():
        if k not in flat_s:
            missing.append(k)
        elif _shape(flat_s[k]) != _shape(v):
            mismatched.append((k, _shape(flat_s[k]), _shape(v)))
        else:
            out[k] = _like(flat_s[k], v)
            used += 1
    if missing:
        log_fn(f"[ckpt] {len(missing)} keys missing (kept init): "
               f"{missing[:5]}…")
    if mismatched:
        log_fn(f"[ckpt] {len(mismatched)} shape mismatches skipped: "
               f"{mismatched[:3]}…")
    log_fn(f"[ckpt] loaded {used}/{len(flat_t)} tensors")
    return _unflatten(out, template)


def detect_feature_dim(sd, candidates=(768, 1024, 1152)) -> int | None:
    """The backbone feature dim of a head state dict: the first candidate
    in the shape of its first 2-D leaf that has one
    (inference_ai_human_images.py:804-827 checkpoint auto-detection)."""
    for v in _flatten(sd).values():
        shp = _shape(v)
        if len(shp) == 2:
            for c in candidates:
                if c in shp:
                    return c
    return None


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _shape(x):
    return tuple(x.shape) if torch.is_tensor(x) else np.shape(x)


def _like(x, ref):
    """x as a leaf of ref's kind: a tensor on ref's device in ref's dtype
    where ref is a tensor, else a numpy array of ref's dtype."""
    if torch.is_tensor(ref):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.detach().to(device=ref.device, dtype=ref.dtype)
    return _numpy(x).astype(np.asarray(ref).dtype)


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}.{i}"))
    else:
        flat[prefix] = tree
    return flat


def _unflatten(flat: dict, template, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(flat, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(flat, v, f"{prefix}.{i}")
               for i, v in enumerate(template)]
        return type(template)(out)
    return flat[prefix]


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x
