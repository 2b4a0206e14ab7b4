"""Checkpoint save/restore (tpudf/train/checkpoint.py) with torch.save.

The JAX package writes orbax checkpoints; the card's machine has no orbax,
so the state (nested dicts and lists of tensors and numbers, e.g.
`MTLTrainState._asdict() | {"epoch": e}`) is written with `torch.save`,
tensors moved to the CPU, with the same JSON metrics sidecar. State from
the JAX package crosses over as a numpy tree through `convert.py`, not
through orbax files.
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
