"""Per-rank data feeding for the data axis (tpudf/parallel/hostdata.py).

Each rank reads only the rows that land on it; no rank builds the global
batch.
  * HostShardedSampler: a seeded global order per epoch, identical on
    every rank (no coordination traffic), padded by wrap-around to a
    multiple of the global batch (`np.resize` tiles it when global_batch
    > n); data-axis rank p of P takes the p-th contiguous block of every
    global batch, so the gathered batch is the single-process batch in
    order. In JAX p / P are the process index and count; in the port one
    process is one rank and the ranks of one model group must read the
    same rows, so p / P are the rank's index on the data axis and that
    axis's size, not the world's.
  * global_batch_from_host_shards: a rank's local rows on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudf_torch.core.mesh import Mesh


class HostShardedSampler:
    """This rank's slice of a global sample order. p / P: its index on
    the data axis and the axis's size, from `mesh` (or given); (0, 1)
    without either."""

    def __init__(self, n: int, global_batch: int, *, shuffle=True, seed=0,
                 mesh: Mesh | None = None, process_index=None,
                 process_count=None):
        self.n = int(n)
        self.global_batch = int(global_batch)
        self.p = (process_index if process_index is not None
                  else mesh.data_index if mesh is not None else 0)
        self.np_ = (process_count if process_count is not None
                    else mesh.data if mesh is not None else 1)
        if self.global_batch % self.np_:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"process_count {self.np_}")
        self.local_batch = self.global_batch // self.np_
        self.shuffle = shuffle
        self.seed = seed

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The GLOBAL order for this epoch — identical on every rank."""
        if self.shuffle:
            order = np.random.default_rng(
                self.seed * 100_003 + epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        pad = (-self.n) % self.global_batch
        if pad:
            # np.resize tiles the order as many times as needed — a plain
            # order[:pad] slice is silently short when global_batch > n
            order = np.concatenate([order, np.resize(order, pad)])
        return order

    def local_batches(self, epoch: int):
        """Yield this rank's index arrays, one per global batch."""
        order = self.epoch_order(epoch)
        lb = self.local_batch
        for start in range(0, len(order), self.global_batch):
            gb = order[start:start + self.global_batch]
            yield gb[self.p * lb:(self.p + 1) * lb]   # (local_batch,)


def global_batch_from_host_shards(mesh: Mesh, local_batch: np.ndarray):
    """This rank's rows (local_B, ...) on its device: the rank's block of
    the global batch of local_B · data rows, which no rank assembles."""
    return torch.as_tensor(np.ascontiguousarray(local_batch)).to(
        mesh.device)
