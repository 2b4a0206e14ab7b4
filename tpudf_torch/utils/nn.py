"""Small numeric helpers shared across heads and blocks."""

import dataclasses
import math
from typing import Callable

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(x):
    """jax.nn.gelu(approximate=True), term for term."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def mm(x, w):
    """f32-exact product of the expert heads. JAX promotes a bf16 x f32
    product to f32 by itself; torch.matmul refuses mixed dtypes, so both
    operands are cast to the promoted type here. On CUDA this needs TF32
    off for matmuls, which is PyTorch's default."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


@dataclasses.dataclass(frozen=True)
class GlobalRows:
    """The draws of a global batch of which this process holds rows
    [start, start + n): in place of a torch.Generator, the head's dropout
    (`rand_rows`) and mixup (train/losses.py) draw the whole batch's
    numbers from `generator`, which every rank of a data-parallel run
    seeds alike, and keep this rank's rows, so the run draws what one
    process draws for the global batch (JAX's jit sees that batch).
    gather(t): the global batch's rows of a local (n, ...) tensor, in rank
    order (an all-gather over the data axis)."""
    generator: torch.Generator
    total: int
    start: int
    gather: Callable


def rand_rows(shape, generator, device):
    """torch.rand(shape) from a torch.Generator, or this rank's rows of
    the global batch's draw from a GlobalRows."""
    if isinstance(generator, GlobalRows):
        full = torch.rand((generator.total, *shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.start:generator.start + shape[0]]
    return torch.rand(shape, generator=generator, device=device)
