"""Precision policy: f32 parameters, bf16 compute, f32 statistics.

Mirrors tpudf/core/precision.py. `cast_tree` casts the floating leaves of a
nested dict/list of tensors; `round_tree` rounds them through a dtype but
keeps their storage dtype (what a kernel reading f32 vectors sees after the
JAX tower's per-layer cast to the compute dtype).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameters stay f32 and statistics (LN, softmax) run in f32; the
    tower's activations and products run in compute_dtype."""
    compute_dtype: torch.dtype = torch.bfloat16


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_tree(tree, dtype):
    """Cast all floating tensor leaves to `dtype`."""
    return tree_map(
        lambda a: a.to(dtype) if torch.is_tensor(a)
        and a.is_floating_point() else a, tree)


def round_tree(tree, dtype):
    """Round floating leaves through `dtype`, keeping their own dtype."""
    return tree_map(
        lambda a: a.to(dtype).to(a.dtype) if torch.is_tensor(a)
        and a.is_floating_point() and a.dtype != dtype else a, tree)


DEFAULT_POLICY = Policy()
# Full-f32 policy for CPU parity tests.
F32_POLICY = Policy(compute_dtype=torch.float32)
