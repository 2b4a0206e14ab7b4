"""Sharded training (tpudf/parallel/training.py): the mesh, a
train step and per-rank data feeding.

`ShardedTrainer` places the trainables: with tensor parallelism the
backbone of {"backbone", "head", ...} is split by heads over the model
axis (parallel/sharding.py) and everything else is replicated (rank 0's
values). Each rank runs the step on its own rows of every global batch
(parallel/hostdata.py). The step closes over its optimizer; for the
length of each step the trainer installs its gradient sync there
(`optimizer.grad_sync`, the previous value restored after), the least
invasive place: before the update (and before the global clip), each
gradient is averaged over the data group, and only that group (one flat
all-reduce), and under tensor parallelism the norm sums the split
leaves' squares over the model group. The tensor-parallel collectives of
the forward and backward are Megatron's f / g inside the tower.

The step sees the global batch's randomness, as JAX's jit does: the
head's dropout masks and mixup's (lam, perm) come from one generator that
every rank seeds alike (`batch_generator(seed, bi)`), drawn for the
global batch (`utils.nn.GlobalRows`); a rank keeps its own rows of the
masks and takes its mixup partners from the other ranks by all-gather.
Inside the step `core.mesh.data_step` is active, so a loss that divides
by a count of rows (the MTL step's masked segmentation loss) counts the
global batch's. The metrics are averaged over the data group.

It drives the binary step (the tower trained, or frozen and passed as
`extra_replicated`) and, with `init_fn`, the MTL step (called
step(state, batch, generator, *args)) with its batch over the data axis.
Adafactor's factored moments and rms clips are not elementwise, so under
tensor parallelism the trainer takes AdamW only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tpudf_torch.core.mesh import Mesh, data_step
from tpudf_torch.parallel.dist import all_gather, all_reduce
from tpudf_torch.parallel.hostdata import (HostShardedSampler,
                                           global_batch_from_host_shards)
from tpudf_torch.parallel.sharding import (REPLICATED, replicate_tree,
                                           shard_siglip_params,
                                           siglip_param_spec,
                                           unshard_siglip_params)
from tpudf_torch.train.steps import Adafactor, global_norm, init_train_state
from tpudf_torch.utils.nn import GlobalRows


def batch_generator(seed: int, bi: int, device) -> torch.Generator:
    """Batch bi's generator, identical on every rank (JAX's
    fold_in(rng, bi))."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + bi)


def _split_flags(tree, rules):
    """For each tensor leaf of `tree`, in `tensor_leaves` order: True
    where its rule splits it over the model axis."""
    if isinstance(tree, dict):
        return [f for k, v in tree.items() for f in _split_flags(
            v, rules.get(k, REPLICATED) if isinstance(rules, dict)
            else rules)]
    if isinstance(tree, (list, tuple)):
        return [f for v in tree for f in _split_flags(v, rules)]
    return [rules != REPLICATED] if torch.is_tensor(tree) else []


class ShardedTrainer:
    """Owns the placed train state, the step and the per-rank feeding.

    params: the trainables. When it is {"backbone": ..., ...} and
    tensor_parallel (default: a model axis > 1), the backbone is split
    by heads (cfg, the SigLIP config, names its heads); the rest is
    replicated. The optimizer state is made from the placed leaves
    (`init_train_state`, or `init_fn` for a step with a state of its
    own)."""

    def __init__(self, mesh: Mesh, step_fn: Callable, optimizer,
                 params: Any, *, extra_replicated: Any = None,
                 tensor_parallel: bool | None = None,
                 ema_decay: float | None = None, cfg=None,
                 init_fn: Callable | None = None):
        self.mesh = mesh
        if tensor_parallel is None:
            tensor_parallel = mesh.model > 1
        rules = {}
        if isinstance(params, dict) and "backbone" in params:
            placed = {"backbone": shard_siglip_params(
                mesh, params["backbone"], tensor_parallel, cfg)}
            placed.update(replicate_tree(
                mesh, {k: v for k, v in params.items() if k != "backbone"}))
            if "tp" in placed["backbone"]:
                rules = {"backbone": siglip_param_spec(True)}
        else:
            placed = replicate_tree(mesh, params)
        self.tensor_parallel = bool(rules)
        if self.tensor_parallel and isinstance(optimizer, Adafactor):
            raise ValueError("Adafactor's factored moments and rms clips "
                             "are not elementwise: the tensor-parallel "
                             "trainer takes AdamW")
        self._split = _split_flags(placed, rules)
        self.optimizer = optimizer
        self._init_fn = init_fn
        self.state = (init_fn(placed) if init_fn is not None
                      else init_train_state(placed, optimizer, ema_decay))
        self.extra = (replicate_tree(mesh, extra_replicated)
                      if extra_replicated is not None else None)
        self._step = step_fn

    def _sync(self, grads):
        """The gradients averaged over the data group, and the global
        norm over the whole model."""
        flat = all_reduce(_flatten_dense_tensors(grads),
                          self.mesh.data_group, "mean")
        grads = list(_unflatten_dense_tensors(flat, grads))
        if not self.tensor_parallel:
            return grads, global_norm(grads)
        if len(grads) != len(self._split):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self._split)} placed leaves")
        rep = [g for g, s in zip(grads, self._split) if not s]
        split = [g for g, s in zip(grads, self._split) if s]
        sq = all_reduce(global_norm(split) ** 2, self.mesh.model_group)
        if rep:
            sq = sq + global_norm(rep) ** 2
        return grads, torch.sqrt(sq)

    @contextlib.contextmanager
    def _syncing(self):
        """The optimizer averages over this trainer's data group inside
        the block only."""
        prev = self.optimizer.grad_sync
        self.optimizer.grad_sync = self._sync
        try:
            yield
        finally:
            self.optimizer.grad_sync = prev

    def _global_rows(self, generator, local_rows: int):
        """The step's generator slot: the global batch's draws, this
        rank's rows."""
        m = self.mesh
        return GlobalRows(generator, local_rows * m.data,
                          m.data_index * local_rows,
                          lambda t: all_gather(t, m.data_group))

    def step(self, batch: dict, generator=None, *args) -> dict:
        """One optimizer step on this rank's rows of a global batch
        (name → (local_B, ...) host arrays); returns the metrics averaged
        over the data axis."""
        local = {k: global_batch_from_host_shards(self.mesh, np.asarray(v))
                 for k, v in batch.items()}
        n = next(iter(local.values())).shape[0]
        rows = (None if generator is None
                else self._global_rows(generator, n))
        lead = () if self._init_fn is not None else (self.extra,)
        with data_step(self.mesh), self._syncing():
            self.state, metrics = self._step(self.state, *lead, local, rows,
                                             *args)
        return {k: all_reduce(v.detach().float(), self.mesh.data_group,
                              "mean") for k, v in metrics.items()}

    def run_epoch(self, arrays: dict, sampler: HostShardedSampler,
                  epoch: int, seed: int = 0) -> dict:
        """Feed every global batch of `epoch` through the step; arrays
        maps name → (N, ...) host data (only this rank's rows are read).
        Batch bi draws from `batch_generator(seed, bi)`."""
        if (sampler.p, sampler.np_) != (self.mesh.data_index,
                                        self.mesh.data):
            raise ValueError("the sampler's rank is not this rank's place "
                             "on the data axis")
        last = {}
        for bi, idx in enumerate(sampler.local_batches(epoch)):
            last = self.step({k: v[idx] for k, v in arrays.items()},
                             batch_generator(seed, bi, self.mesh.device))
        return last

    def backbone_params(self, cfg):
        """The whole backbone (the model group's parts gathered)."""
        return unshard_siglip_params(self.state.params["backbone"], cfg)
