"""The (data, model) mesh over the process group's ranks
(tpudf/core/mesh.py).

Rank r sits at (r // model, r % model), the JAX package's row-major
reshape of its devices into (data, model):
  * axis "data": batch parallelism. The ranks that share a model index
    form this rank's data group; each holds its own rows of a batch.
  * axis "model": Megatron-style tensor parallelism of the tower's blocks
    (parallel/sharding.py). The ranks that share a data index form this
    rank's model group; they read the same rows.

The groups are `torch.distributed.new_group` subgroups, made by every
rank in one order (DeviceMesh is not used: a world whose ranks share one
card on purpose, the gloo correctness worlds, is outside its one device
per rank). Without a process group the mesh is (1, 1) and has no groups.

`data_step(mesh)` marks a data-parallel train step: inside it
`data_sum` sums over the global batch (an all-reduce over the data
group), for a loss whose denominator counts the batch's rows (the MTL
step's masked segmentation loss), and `data_size` is the data axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None     # this rank's data axis (same model index)
    model_group: Any = None    # this rank's model axis (same data index)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the default process group's world (one
    rank without one). device: this rank's device; the one
    `parallel.dist.initialize` gave it by default, else the card."""
    from tpudf_torch.parallel.dist import rank_device, world

    rank, n = world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    dev = torch.device(device or rank_device() or "cuda")
    mesh = Mesh(data, model, rank, dev)
    if not dist.is_initialized():
        return mesh
    grid = np.arange(n).reshape(data, model)
    for i in range(data):                  # model groups: one data index
        g = dist.new_group(grid[i].tolist())
        if i == mesh.data_index:
            mesh.model_group = g
    for j in range(model):                 # data groups: one model index
        g = dist.new_group(grid[:, j].tolist())
        if j == mesh.model_index:
            mesh.data_group = g
    return mesh


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an n-row global batch (n a multiple of the
    data axis)."""
    if n % mesh.data:
        raise ValueError(f"batch {n} not divisible by data axis {mesh.data}")
    lb = n // mesh.data
    return slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)


def replicated(mesh: Mesh, x):
    """The whole tensor on this rank's device."""
    return torch.as_tensor(x).to(mesh.device)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a dict (or one array) of host arrays of the
    global batch, on its device."""
    def put(x):
        x = np.asarray(x)
        return torch.as_tensor(np.ascontiguousarray(
            x[data_sharding(mesh, x.shape[0])])).to(mesh.device)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


_STEP = [None]          # the mesh of the data-parallel step in flight


@contextlib.contextmanager
def data_step(mesh: Mesh):
    prev, _STEP[0] = _STEP[0], mesh
    try:
        yield
    finally:
        _STEP[0] = prev


def data_sum(x):
    """Σ x over the global batch: over this rank's rows, then over the
    data axis inside `data_step`."""
    s = torch.sum(x)
    mesh = _STEP[0]
    if mesh is None or mesh.data_group is None:
        return s
    from tpudf_torch.parallel.dist import all_reduce
    return all_reduce(s.detach(), mesh.data_group)


def data_size() -> int:
    """The data axis of the step in flight (1 outside `data_step`)."""
    return 1 if _STEP[0] is None else _STEP[0].data
