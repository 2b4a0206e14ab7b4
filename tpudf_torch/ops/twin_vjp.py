"""A kernel made differentiable by the VJP of its plain twin.

The JAX package gives K13, K14 and K4 custom VJPs that apply `jax.vjp` to
their XLA references and use no Pallas kernel in the backward
(tpudf/ops/linear.py, mlp.py, layernorm.py). `with_twin_vjp` does the
same: the forward is the kernel (its wrapper takes the twin for a CPU
tensor), and the backward recomputes the twin from the saved inputs under
autograd and returns `torch.autograd.grad` of it. The products of that
recompute are PyTorch's (cuBLAS on the card): no backward kernel exists to
port.
"""

from __future__ import annotations

import torch


class _TwinVJP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, twin, kwargs, *tensors):
        ctx.twin, ctx.kwargs = twin, kwargs
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.twin(*inputs, **ctx.kwargs)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, needs) if n], grad))
        return (None, None, None, *(next(grads) if n else None
                                    for n in needs))


def with_twin_vjp(kernel, twin, *tensors, **kwargs):
    """kernel(*tensors, **kwargs), differentiable in every tensor (None
    entries allowed) through twin(*tensors, **kwargs). Without a tensor that
    needs a gradient it is the plain kernel call."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _TwinVJP.apply(kernel, twin, kwargs, *tensors)
    return kernel(*tensors, **kwargs)
