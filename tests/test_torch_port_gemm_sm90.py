"""The bf16 GEMM of K13, K14 and kernel 15 on wgmma and TMA
(tpudf_torch/csrc/bf16_gemm_sm90.cu): its domain, its twins at the edges
of its tiles against the JAX package, and a numpy model of its order, on
the CPU.

  (a) the domain  `check_bf16_gemm` takes bf16 (M, K) @ (K, N) with N %
      128 == 0 and K % 32 == 0 at any M >= 1, and nothing else, over a
      grid of (M, K, N) and dtypes; K13's and K14's checks refuse what it
      refuses
  (b) the twins  K13's three forms (LN + QKV, bias + residual, bias +
      GELU) and K14 against `_fused_linear_pallas` and `_mlp_block_pallas`
      in interpret mode (their kernel bodies, called directly: JAX's own
      wrapper sends K % 128 != 0 to XLA) in bf16 at the kernel's ragged
      edges: M = 300 rows (two tiles of 128 and a part), K = 800 (K % 64
      == 32: the last 64-deep step half zeros) and N % 256 == 128 (a half
      tile), within atol 1e-2 + rtol 2^-7 (f32 sums in another order
      before one bf16 rounding)
  (c) the order  `gemm_tile_model`: the kernel's arithmetic in its order
      (A and W zero-filled to whole 128 x 256 tiles and 64-deep K steps,
      as TMA delivers them; f32 sums over four k16 steps a stage; the
      columns past N of a half tile computed from whatever the stage
      held, here NaN, and never stored; f = acc + bias, the epilogue, one
      bf16 rounding) equals the f32 twin within 2e-3 in every mode
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.ops.linear import _fused_linear_pallas
from tpudf.ops.mlp import _mlp_block_pallas
from tpudf_torch.ops import linear
from tpudf_torch.ops.mlp import check_mlp_block_fused, mlp_block_fused
from tpudf_torch.utils.nn import gelu_tanh

BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
TILE_M, TILE_N, STEP_K = 128, 256, 64


# ------------------------------------------------------------ (a) domain

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_gemm_domain_on_a_grid(dtype):
    """The wrapper takes exactly bf16 (M, K) @ (K, N) with N % 128 == 0
    and K % 32 == 0, whatever M; K13's check takes what it takes."""
    taken = 0
    for m in (1, 7, 128, 300, 108544):
        for k in (16, 32, 96, 768, 800, 3072, 4352, 4304):
            for n in (64, 128, 384, 640, 768, 2304, 4304):
                w = torch.empty((k, n), dtype=torch.bfloat16, device="meta")
                want = (dtype == torch.bfloat16 and n % 128 == 0
                        and k % 32 == 0)
                try:
                    linear.check_bf16_gemm(dtype, m, k, w)
                    got = True
                except ValueError:
                    got = False
                assert got == want, (m, k, n, dtype)
                x = torch.empty((m, k), dtype=dtype, device="meta")
                try:
                    linear.check_linear_fused(x, w)
                    got13 = True
                except ValueError:
                    got13 = False
                assert got13 == want, (m, k, n, dtype)
                taken += got
    assert taken == (0 if dtype != torch.bfloat16 else 5 * 6 * 5)


def test_gemm_refuses_a_weight_of_another_dtype_or_depth():
    bf = torch.bfloat16
    w = torch.empty((768, 2304), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        linear.check_bf16_gemm(bf, 300, 768, w)
    w = torch.empty((800, 2304), dtype=bf, device="meta")
    with pytest.raises(ValueError):
        linear.check_bf16_gemm(bf, 300, 768, w)
    with pytest.raises(ValueError):
        linear.check_linear_fused(torch.empty((4, 768), dtype=bf),
                                  torch.empty((768, 768), dtype=bf),
                                  residual=torch.empty((4, 768), dtype=bf),
                                  activation="gelu")
    mp = {"fc1_w": torch.empty((384, 640), dtype=bf),
          "fc2_w": torch.empty((640, 400), dtype=bf)}
    with pytest.raises(ValueError):
        check_mlp_block_fused(torch.empty((2, 3, 384), dtype=bf), mp)


# ------------------------------------------------------------ (b) twins

def _bf(a):
    """The same bf16 values on both sides."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _f(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


_FORMS = {"ln": dict(ln=True), "residual": dict(res=True),
          "gelu": dict(activation="gelu")}


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("m,k,n", [(300, 800, 384), (300, 768, 640)])
def test_k13_twin_matches_pallas_interpret_at_tile_edges(form, m, k, n):
    rng = np.random.default_rng(k + n)
    d = {"x": _f(rng, m, k), "w": _f(rng, k, n, std=k ** -0.5),
         "b": _f(rng, n, std=0.1), "g": 1 + _f(rng, k, std=0.1),
         "beta": _f(rng, k, std=0.1), "res": _f(rng, m, n)}
    kw = _FORMS[form]
    ln_j = ((jnp.asarray(d["g"]), jnp.asarray(d["beta"]))
            if kw.get("ln") else None)
    ln_t = ((torch.from_numpy(d["g"]), torch.from_numpy(d["beta"]))
            if kw.get("ln") else None)
    want = _fused_linear_pallas(
        _bf(d["x"])[0], _bf(d["w"])[0], jnp.asarray(d["b"]), ln_j,
        _bf(d["res"])[0] if kw.get("res") else None, 1e-6,
        activation=kw.get("activation"), interpret=True)
    got = linear.linear_fused(
        _bf(d["x"])[1], _bf(d["w"])[1], torch.from_numpy(d["b"]), ln=ln_t,
        residual=_bf(d["res"])[1] if kw.get("res") else None,
        activation=kw.get("activation"))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_STEP)


def test_k14_twin_matches_pallas_interpret_at_tile_edges():
    """K14 at 300 rows, width 384 and hidden 640: both products end in a
    half tile (N % 256 == 128)."""
    rng = np.random.default_rng(14)
    m, w, inter = 300, 384, 640
    d = {"x": _f(rng, m, w), "g": 1 + _f(rng, w, std=0.1),
         "beta": _f(rng, w, std=0.1), "w1": _f(rng, w, inter, std=w ** -0.5),
         "b1": _f(rng, inter, std=0.1),
         "w2": _f(rng, inter, w, std=inter ** -0.5),
         "b2": _f(rng, w, std=0.1)}
    c = lambda k: _bf(d[k])[0]
    f = lambda k: jnp.asarray(d[k])
    want = _mlp_block_pallas(c("x"), f("g"), f("beta"), c("w1"), f("b1"),
                             c("w2"), f("b2"), 1e-6, interpret=True)
    ln = {"scale": torch.from_numpy(d["g"]),
          "bias": torch.from_numpy(d["beta"])}
    mp = {"fc1_w": _bf(d["w1"])[1], "fc1_b": torch.from_numpy(d["b1"]),
          "fc2_w": _bf(d["w2"])[1], "fc2_b": torch.from_numpy(d["b2"])}
    got = mlp_block_fused(_bf(d["x"])[1], ln, mp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_STEP)


# ------------------------------------------------------------ (c) order

def gemm_tile_model(a, w, bias, mode, res=None):
    """The kernel's arithmetic in its order, in numpy f32: returns the f32
    epilogue values before the bf16 rounding, (M, N)."""
    m, k = a.shape
    n = w.shape[1]
    mp = -(-m // TILE_M) * TILE_M
    np_ = -(-n // TILE_N) * TILE_N
    kp = -(-k // STEP_K) * STEP_K
    ap = np.zeros((mp, kp), np.float32)      # rows past M, K tail: zeros
    ap[:m, :k] = a
    wp = np.full((kp, np_), np.nan, np.float32)   # never-loaded columns
    wp[:, :n] = 0.0
    wp[:k, :n] = w
    out = np.empty((m, n), np.float32)
    for m0 in range(0, mp, TILE_M):
        for n0 in range(0, np_, TILE_N):
            acc = np.zeros((TILE_M, TILE_N), np.float32)
            for k0 in range(0, kp, STEP_K):
                for ks in range(0, STEP_K, 16):
                    kk = k0 + ks
                    acc += (ap[m0:m0 + TILE_M, kk:kk + 16]
                            @ wp[kk:kk + 16, n0:n0 + TILE_N])
            rows = min(TILE_M, m - m0)
            cols = min(TILE_N, n - n0)
            if rows > 0 and cols > 0:
                out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    f = out + (bias if bias is not None else np.float32(0.0))
    if mode == linear.GEMM_GELU:
        f = gelu_tanh(torch.from_numpy(f)).numpy()
    elif mode == linear.GEMM_RESIDUAL:
        f = f + res
    return f


@pytest.mark.parametrize("mode,with_bias", [(0, True), (0, False), (1, True),
                                            (2, True)])
@pytest.mark.parametrize("m,k,n", [(300, 800, 384), (130, 96, 640)])
def test_gemm_tile_model_equals_f32_twin(mode, with_bias, m, k, n):
    rng = np.random.default_rng(m + k + n + mode)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    a, w = bf(_f(rng, m, k)), bf(_f(rng, k, n, std=k ** -0.5))
    bias = _f(rng, n, std=0.1) if with_bias else None
    res = bf(_f(rng, m, n)) if mode == 2 else None
    model = gemm_tile_model(a, w, bias, mode, res)
    assert np.isfinite(model).all()
    t = torch.from_numpy
    twin = linear.linear_fused_reference(
        t(a), t(w), None if bias is None else t(bias),
        residual=None if res is None else t(res),
        activation="gelu" if mode == 1 else None)
    np.testing.assert_allclose(model, twin.numpy(), atol=2e-3, rtol=2e-3)
    # the launch's twin rounds the same values once to bf16
    got = linear.linear_fused_reference(
        t(a).to(torch.bfloat16), t(w).to(torch.bfloat16),
        None if bias is None else t(bias),
        residual=None if res is None else t(res).to(torch.bfloat16),
        activation="gelu" if mode == 1 else None)
    np.testing.assert_allclose(got.float().numpy(),
                               t(model).to(torch.bfloat16).float().numpy(),
                               **BF16_STEP)
