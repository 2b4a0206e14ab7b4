"""Pieces the GEMM probes (kernels 15 and 16) share: their domain, the
int8 codes and exact integer products of the twins, the launch of the
quantising int8 GEMM, and CUDA-event timing.

The quantising GEMM (bf16 x quantised at ACT inside it) runs on the int8
wgmma kernel of `csrc/int8_gemm_sm90.cu` in one of two forms, chosen by K
before any launch (`quant_route`):
  one    K <= PANEL_MAX_K (768): ONE launch of `tpudf_i8_gemm_quant`, x's
         codes built once a row tile in shared memory (a panel beside the
         epilogue's slots and three 32 KB weight stages); they never reach
         device memory
  split  PANEL_MAX_K < K <= MAX_K (1600, the domain the probes have always
         taken): `tpudf_quant_rows_i8` writes the codes (M, K), then
         `tpudf_i8_gemm` runs the same epilogue mode on them; bit-equal to
         the one launch where both apply

Constants that the JAX probes write as Python floats (4.0 / 127.0, 127.0 /
4.0) are doubles there, rounded once to f32 where they meet an f32 array
(JAX's weak types); `f32` rounds them the same way here.
"""

from __future__ import annotations

import torch

from tpudf_torch.ops import _build, int8_block

ROWS = 512          # the JAX probes' row block: grid (M // 512,)
ACT = 4.0           # the GEMM probes' static activation scale of x
# the epilogue modes of csrc/gemm_i8.cuh: kEpiProbeStatic, kEpiProbeGelu,
# kEpiBf16, kEpiProbeBf16
QUANT_MODES = {"staticq": 6, "full": 7, "nogelu": 0, "bf16_epi": 8}
MAX_K = 1600        # the quantising GEMMs' K (either form)
PANEL_MAX_K = 768   # one launch: csrc/int8_gemm_sm90.cu kQuantPanelMaxK
QUANT_TILE = 256    # the one launch's tile width (kQuantBN)
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


def quant_route(k):
    """The form of the quantising GEMM at depth k: "one" (one launch, x's
    codes in shared memory) or "split" (the codes' row pass, then the int8
    GEMM)."""
    return "one" if k <= PANEL_MAX_K else "split"


def quant_units(m, n, sms=int8_block.H100_SMS):
    """The one launch's persistent walk: per block, its units in order as
    (row tile, its column tiles of QUANT_TILE in the order it runs them).
    A unit is a row tile and a run of its column tiles (K5's split,
    `int8_block.k5_splits`, over QUANT_TILE-wide tiles); block b takes
    units b, b + grid, ..., builds a unit's panel at its start, and runs
    unit u's run from its tile u % (run length)."""
    tiles = -(-n // QUANT_TILE)
    s = int8_block.k5_splits(m, tiles * int8_block.K5_TILE, sms)
    units = -(-m // int8_block.K5_TILE) * s
    grid = min(units, sms)
    walk = []
    for blk in range(grid):
        mine = []
        for u in range(blk, units, grid):
            t0, t1 = (u % s) * tiles // s, (u % s + 1) * tiles // s
            mine.append((u // s, [t0 + (i + u) % (t1 - t0)
                                  for i in range(t1 - t0)]))
        walk.append(mine)
    return walk


def _quant_args(wt, s, b, act, device):
    return (wt.contiguous(), s.float().contiguous(),
            None if b is None else b.float().contiguous(),
            act if act is not None else act_scale(device))


def quant_gemm_cuda(mode, x, wt, s, b, act):
    """bf16 out (M, N) = epilogue(quant(x) · wtᵀ) in the form
    `quant_route(K)` picks (uncounted: each probe counts its own)."""
    m, k = x.shape
    n = wt.shape[0]
    if quant_route(k) == "split":
        return quant_gemm_split(mode, x, wt, s, b, act)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _build.call("tpudf_i8_gemm_quant", x.contiguous(),
                *_quant_args(wt, s, b, act, x.device), out, m, n, k,
                QUANT_MODES[mode])
    return out


def quant_gemm_split(mode, x, wt, s, b, act):
    """The split form at any K of the domain: the codes' row pass
    (`tpudf_quant_rows_i8`), then the int8 GEMM in the same epilogue mode
    (uncounted)."""
    m, k = x.shape
    n = wt.shape[0]
    args = _quant_args(wt, s, b, act, x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    _build.call("tpudf_quant_rows_i8", x.contiguous(), args[-1], codes, m, k)
    _build.call("tpudf_i8_gemm", codes, *args, None, out, None, None, m, n, k,
                QUANT_MODES[mode])
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
