"""Small numeric helpers shared across heads."""

import torch


def mm(x, w):
    """f32-exact product of the expert heads. JAX promotes a bf16 x f32
    product to f32 by itself; torch.matmul refuses mixed dtypes, so both
    operands are cast to the promoted type here. On CUDA this needs TF32
    off for matmuls, which is PyTorch's default."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))
