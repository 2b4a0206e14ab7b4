"""Pieces the GEMM probes (kernels 15 and 16) share: their domain, the
int8 codes and exact integer products of the twins, the launch of the
quantising int8 GEMM (`csrc/probe_gemm.cu`), and CUDA-event timing.

Constants that the JAX probes write as Python floats (4.0 / 127.0, 127.0 /
4.0) are doubles there, rounded once to f32 where they meet an f32 array
(JAX's weak types); `f32` rounds them the same way here.
"""

from __future__ import annotations

import torch

from tpudf_torch.ops import _build

ROWS = 512          # the JAX probes' row block: grid (M // 512,)
ACT = 4.0           # the GEMM probes' static activation scale of x
QUANT_MODES = {"staticq": 0, "full": 1, "nogelu": 2, "bf16_epi": 3}
PANEL_MAX_K = 1600  # the quantised x panel and two weight stages fit 227 KB
_DOT_SLICE = 1024   # |sum of 1024 products of codes| <= 2^24: exact in f32


def f32(v: float) -> float:
    """The Python double v rounded once to f32 (as a Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


C_ACT = f32(ACT / 127.0)     # the dequant factor 4.0 / 127.0
INV_ACT = f32(127.0 / ACT)   # the quant factor 127.0 / 4.0 (31.75, exact)


def quant_codes(x, inv):
    """clip(round(f32(x) · inv), ±127) as f32 codes (round half to even,
    as jnp.round)."""
    return torch.clamp(torch.round(x.float() * inv), -127, 127)


def int_dot(a, bt):
    """a (M, K) · bt (N, K)ᵀ of integer codes as exact int32: f32 products
    over K slices of 1024 (every partial sum an integer of at most 2^24, so
    exact in any order), added in int32."""
    acc = None
    for k0 in range(0, a.shape[1], _DOT_SLICE):
        part = torch.matmul(a[:, k0:k0 + _DOT_SLICE].float(),
                            bt[:, k0:k0 + _DOT_SLICE].float().T)
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def check_gemm(name, x, w, x_dtype, k_align, *, w_dtype=torch.int8,
               transposed=True, max_k=None):
    """Raise unless the probe GEMM `name` takes x (M, K) of x_dtype and its
    weight w ((N, K) when transposed, else (K, N)) of w_dtype: M a multiple
    of the probes' 512-row block (the JAX grid is M // 512 and would leave
    the rest unwritten), N of the tile's 128, K of k_align (and at most
    max_k)."""
    n, kw = (w.shape if transposed else tuple(reversed(w.shape)))
    m, k = x.shape if x.dim() == 2 else (-1, -1)
    if (x.dim() != 2 or w.dim() != 2 or x.dtype != x_dtype
            or w.dtype != w_dtype or kw != k or m % ROWS or n % 128
            or k % k_align or (max_k is not None and k > max_k)):
        raise ValueError(
            f"{name} takes {x_dtype} x (M, K) and {w_dtype} w "
            f"{'(N, K)' if transposed else '(K, N)'} with M % {ROWS} == 0, "
            f"N % 128 == 0, K % {k_align} == 0"
            f"{'' if max_k is None else f', K <= {max_k}'}; got {x.dtype} "
            f"{tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")


def act_scale(device):
    """The 0-d f32 activation scale (ACT) the kernels read on the card."""
    return torch.full((), ACT, dtype=torch.float32, device=device)


def quant_gemm_cuda(mode, x, wt, s, b, act):
    """bf16 out (M, N) = epilogue(quant(x) · wtᵀ) in one launch of
    `tpudf_i8_gemm_quant` (uncounted: each probe counts its own)."""
    m, k = x.shape
    n = wt.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _build.call("tpudf_i8_gemm_quant", x.contiguous(), wt.contiguous(),
                s.float().contiguous(),
                None if b is None else b.float().contiguous(),
                act if act is not None else act_scale(x.device), out, m, n,
                k, QUANT_MODES[mode])
    return out


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call of fn over `iters` calls after `warmup`, by CUDA
    events around the whole run (the device's time, launches queued back
    to back)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
