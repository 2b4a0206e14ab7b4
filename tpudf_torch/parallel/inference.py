"""Batch-parallel inference over the mesh (tpudf/parallel/inference.py).

  * DataParallelRunner: pads the last partial batch to the data-axis
    multiple by repeating its last row, puts this rank's rows (only those)
    on its device, runs the function on them, gathers the outputs along
    the data axis (an all-gather over the data group) and trims the pad.
  * sharded_siglip_features: the tower's pooled features, the parameters
    replicated (data parallel) or split by heads (tensor parallel,
    parallel/sharding.py).
  * sharded_detect_core: the engine's 53-view full analysis
    (serve/engine.py `_detect_batch`) on each rank's images, unpacked as
    the engine unpacks it.

Each rank runs the kernels of the single-process path on its own rows
(under tensor parallelism, on its own heads): the port's counterpart of
JAX's shard_map around its Pallas kernels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpudf_torch.core.mesh import Mesh
from tpudf_torch.parallel.dist import all_gather


def _gather_tree(out, group, n: int):
    if torch.is_tensor(out):
        return all_gather(out, group)[:n]
    if isinstance(out, dict):
        return {k: _gather_tree(v, group, n) for k, v in out.items()}
    return out


class DataParallelRunner:
    """fn(*replicated_args, local_batch) on this rank's rows of a host
    batch; returns its outputs (a tensor or a dict of them; other leaves
    pass as they are) gathered over the data axis and trimmed to the
    batch, on this rank's device."""

    def __init__(self, mesh: Mesh, fn: Callable):
        self.mesh = mesh
        self.fn = fn

    def __call__(self, *replicated_args, batch):
        batch = np.asarray(batch)
        b = batch.shape[0]
        pad = (-b) % self.mesh.data
        if pad:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], pad, axis=0)], axis=0)
        lb = batch.shape[0] // self.mesh.data
        i = self.mesh.data_index
        local = torch.as_tensor(np.ascontiguousarray(
            batch[i * lb:(i + 1) * lb])).to(self.mesh.device)
        out = self.fn(*replicated_args, local)
        return _gather_tree(out, self.mesh.data_group, b)


def sharded_siglip_features(mesh: Mesh, backbone_params, cfg, policy=None,
                            tensor_parallel=False):
    """run(batch=pixels) → (B, W) f32 numpy pooled features of
    SigLIP-normalised NHWC pixels, with data (and optional tensor)
    parallelism."""
    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.models.siglip import siglip_forward, tower_params
    from tpudf_torch.parallel.sharding import shard_siglip_params

    policy = policy or DEFAULT_POLICY
    if tensor_parallel and mesh.model > 1:
        params = shard_siglip_params(mesh, backbone_params, True, cfg)
    else:
        params = tower_params(shard_siglip_params(mesh, backbone_params,
                                                  False),
                              policy.compute_dtype)

    @torch.no_grad()
    def fn(params, pixels):
        return siglip_forward(params, pixels, cfg, policy)["pooled"]

    runner = DataParallelRunner(mesh, fn)

    def run(batch):
        return runner(params, batch=batch).float().cpu().numpy()

    return run


def sharded_detect_core(mesh: Mesh, engine):
    """run(pixels) → the full analysis' per-image outputs (as
    `engine.predict_batch` gives them) with the images over the data
    axis; the engine's tower, heads and schedules replicated from rank
    0."""
    from tpudf_torch.parallel.sharding import replicate_tree
    from tpudf_torch.serve.engine import FULL_SCALARS, _detect_batch, _unpack

    tower, head, freq, fusion = (replicate_tree(mesh, t) for t in (
        engine.tower, engine.head, engine.freq, engine.fusion))
    kw = dict(cfg=engine.cfg, policy=engine.policy, cuts=engine.cuts,
              kernels=engine.kernels, tome_r=engine.tome_r,
              tome_floor=engine.tome_floor,
              patch_tome_r=engine.patch_tome_r,
              patch_tome_floor=engine.patch_tome_floor)

    def fn(tower, head, freq, fusion, pixels):
        return _detect_batch(tower, head, freq, fusion, pixels, **kw)

    runner = DataParallelRunner(mesh, fn)

    def run(pixels_uint8):
        out = runner(tower, head, freq, fusion, batch=pixels_uint8)
        return _unpack(out, FULL_SCALARS)

    return run
