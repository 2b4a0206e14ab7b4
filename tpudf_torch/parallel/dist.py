"""Multi-process runtime (tpudf/parallel/dist.py) over torch.distributed,
and the collectives the port's data- and tensor-parallel paths issue.

One process is one rank. The launcher is torchrun (`python -m
torch.distributed.run --nproc_per_node N script.py ...`, which ships with
torch): it exports RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT, and a worker calls `initialize_from_env()` first; without
those variables it is a no-op, so single-process CLIs need no guard.
`torchrun(n, args)` starts such a run on this host. A
rank runs on cuda:LOCAL_RANK over NCCL; `device="cpu"` runs it on the CPU
over gloo; a caller that puts several ranks on one card on purpose (a
correctness world: NCCL refuses two ranks on one device) passes that
device and backend="gloo".

The collectives take tensors on the rank's device. Under gloo a CUDA
tensor is staged through host memory (copied to the CPU, reduced or
gathered there, copied back); the compute stays on the card. Without a process group (a world of one that never called
`initialize`) each collective returns its input.

The tensor-parallel blocks use Megatron's two autograd functions:
`copy_to_model` (f: identity forward, all-reduce backward) at the input
of a column-parallel product and `reduce_from_model` (g: all-reduce
forward, identity backward) at the output of a row-parallel one. Their
all-reduces are these helpers, not torch.distributed.nn's.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from tpudf_torch.core.backend import require_cuda

ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_STATE = {"device": None}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(nproc: int, args, **popen_kw) -> subprocess.Popen:
    """Start `python -m torch.distributed.run` with nproc ranks of args
    (a script and its arguments, or "-m", module, ...) on this host, at a
    free port, from the repository's root with it on PYTHONPATH. popen_kw
    goes to subprocess.Popen (stdout, stderr, text)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "localhost", "--master_port",
           str(free_port()), *map(str, args)]
    env = {**os.environ, "PYTHONPATH": _ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(cmd, cwd=_ROOT, env=env, **popen_kw)


def is_multiprocess_env() -> bool:
    return all(v in os.environ for v in ENV_VARS)


def initialize(backend: str | None = None, *, device="cuda",
               init_method: str = "env://", world_size: int | None = None,
               rank: int | None = None) -> bool:
    """Bring up the default process group. device: "cuda" (this rank's
    card, cuda:LOCAL_RANK; the backend NCCL), "cpu" (gloo), or a device
    the caller picks (with its backend). Returns True when it ran, False
    when a group already existed."""
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _STATE["device"] = dev
    return True


def initialize_from_env(device="cuda", backend: str | None = None) -> bool:
    """Initialize from torchrun's variables; a no-op (False) without
    them."""
    if not is_multiprocess_env():
        return False
    return initialize(backend, device=device,
                      world_size=int(os.environ["WORLD_SIZE"]),
                      rank=int(os.environ["RANK"]))


def rank_device() -> torch.device | None:
    """The device `initialize` gave this rank (None before it ran)."""
    return _STATE["device"]


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


def _host_staged(t, group) -> bool:
    return (t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO)


def all_reduce(t, group, op: str = "sum"):
    """Σ (or the mean, op="mean") of t over the group's ranks, as a new
    tensor on t's device."""
    if group is None:
        return t.clone()
    staged = _host_staged(t, group)
    buf = (t.detach().to("cpu") if staged else t.detach()).clone()
    dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
    if staged:
        buf = buf.to(t.device)
    if op == "mean":
        buf = buf / dist.get_world_size(group)
    return buf


def all_gather(t, group):
    """The group's ranks' tensors concatenated along dim 0, in rank
    order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _host_staged(t, group):
        parts = [torch.empty_like(src, device="cpu") for _ in range(n)]
        dist.all_gather(parts, src.to("cpu"), group=group)
        return torch.cat(parts).to(t.device)
    if dist.get_backend(group) == dist.Backend.GLOO:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts)
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def broadcast(t, src: int = 0, group=None):
    """Rank src's t (src a global rank) on every rank of the group (the
    world by default), bytes for bytes whatever the dtype."""
    if not dist.is_initialized():
        return t
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    staged = _host_staged(t, group)
    buf = flat.to("cpu") if staged else flat.clone()
    dist.broadcast(buf, src, group=group)
    if staged:
        buf = buf.to(t.device)
    return buf.view(t.dtype).reshape(t.shape)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over
    the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)
