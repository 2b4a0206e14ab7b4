"""Parity of the port's probes (kernels 15, 16 and 17, `tpudf_torch/probes/`)
with the JAX probe scripts they mirror, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side runs the probes' own kernel bodies in Pallas interpret mode
(`pl.pallas_call` patched to interpret=True; nothing in scripts/ is
edited), at shrunken sizes: kernel 15 at (M, K, N) = (1024, 128, 256) with
its 512-row block (the module's M, K, N and ROWS patched), kernel 16's
five bodies through `make`'s pallas_call at the same size, kernel 17 at
(1, 300, 768) (2 heads of 128; the second 256-row query block is padded)
and (2, 256, 768). The port's wrappers get CPU tensors and take their
twins. Tolerances:
  codes      the int8 codes of x (amax 4) and of q, k, v (amax 3), and
             the host-rounded constants of kernel 17: exactly equal
  pure       k_pure's int32: exactly equal
  int8_kernel, k_nogelu, k_noquant: within one bf16 step of the larger
             magnitude (exact int32 sums; an FMA contraction of acc·cs + b
             by XLA may move the f32 value by an ulp before the rounding)
  bf16_kernel the same, plus 1e-6 absolute: f32 sums of 128 products in
             another order differ by a few f32 ulps of the terms (~1e-7),
             more than a bf16 step of an output that cancels to near 0
  k_full     the same, plus 1e-6 absolute: GELU's f32 rounding (XLA's
             CPU tanh is an approximation a few ulps from torch's, and
             1 + tanh cancels in GELU's negative tail)
  k_bf16_epi within two bf16 steps: XLA's CPU backend may keep f32
             between the fused bf16 ops (xla_allow_excess_precision),
             where the port rounds to bf16 after each op, as the TPU does
  17         9b's rule (tests/test_torch_port_large.py): within one bf16
             step, except in rows where a probability code p·127/ap lies
             within 1e-3 of a rounding tie (exp and the row sum round apart
             in the two frameworks); at most 1 % of the rows depart
Refusals: kernel 17 at head_dim 64, every probe GEMM at M % 512 != 0, and
each probe's main() where no card is visible.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpudf_torch.probes import common
from tpudf_torch.probes import micro_attn_static as P17
from tpudf_torch.probes import micro_epilogue as P16
from tpudf_torch.probes import micro_pallas_int8 as P15

_scripts = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if _scripts not in sys.path:
    sys.path.insert(0, _scripts)

import micro_attn_static as J17  # noqa: E402
import micro_epilogue as J16  # noqa: E402
import micro_pallas_int8 as J15  # noqa: E402

M, K, N = 1024, 128, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side, as the other port files
    run it (torch's pool costs more than it saves at these sizes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    """The probes' pallas_call in interpret mode, at the shrunken sizes."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    for mod in (J15, J16):
        for name, v in (("M", M), ("K", K), ("N", N), ("ROWS", 512)):
            monkeypatch.setattr(mod, name, v)


def _bf16(a):
    """a rounded to bf16, as the f32 values both sides read."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _np(x):
    return x.float().numpy() if x.dtype != torch.int32 else x.numpy()


def _bf16_step(v):
    """The spacing of bf16 values at magnitude v (one step)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 1e-30))) - 7)


def _assert_steps(got, want, steps, atol=0.0):
    err = np.abs(got - want)
    lim = steps * _bf16_step(np.maximum(np.abs(got), np.abs(want))) + atol
    assert np.isfinite(got).all()
    assert (err <= lim).all(), f"max excess {np.max(err - lim):.3e}"


def _gemm_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x_bf": _bf16(rng.standard_normal((M, K))),
            "w_bf": _bf16(rng.standard_normal((K, N)) * 0.03),
            "w8": rng.integers(-127, 128, (K, N)).astype(np.int8),
            "x_i8": rng.integers(-127, 128, (M, K)).astype(np.int8),
            "s": (rng.random(N) * 0.01 + 0.01).astype(np.float32),
            "b": rng.random(N).astype(np.float32)}


# ---------------------------------------------------------------- codes


@pytest.mark.parametrize("amax", [4.0, 3.0])
def test_quant_codes_equal_jax(amax):
    """The probes' quantiser: clip(round(f32(x) · 127/amax), ±127), with
    ties (x · 127/amax at k + 0.5) among the inputs."""
    rng = np.random.default_rng(1)
    x = _bf16(np.concatenate([rng.standard_normal(4096) * amax,
                              (np.arange(-300, 300) + 0.5) * amax / 127.0]))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jnp.bfloat16).astype(
        jnp.float32) * (127.0 / amax)), -127, 127))
    inv = common.INV_ACT if amax == 4.0 else P17.static_scales(1.0)["inv_q"]
    got = common.quant_codes(torch.from_numpy(x).to(torch.bfloat16), inv)
    np.testing.assert_array_equal(got.numpy(), want)


def test_static_constants_round_as_jax():
    """Kernel 17's constants and 16's 4/127: Python doubles rounded once to
    f32, as JAX rounds a weak-typed constant against an f32 array."""
    scale = 128 ** -0.5
    one = jnp.ones((), jnp.float32)
    c = P17.static_scales(scale)
    want = {"inv_q": 127.0 / 3.0, "inv_k": 127.0 / 3.0, "inv_v": 127.0 / 3.0,
            "fac": (3.0 * 3.0) / (127.0 * 127.0) * scale,
            "cv": 3.0 / (127.0 * 127.0)}
    for k, v in want.items():
        assert c[k] == float(one * v), k
    assert common.C_ACT == float(one * (4.0 / 127.0))
    assert common.C_ACT == float(np.float32(4.0) / np.float32(127.0))


# ---------------------------------------------------------------- 15


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_k15_matches_pallas_interpret(kind, interpret):
    t = _gemm_inputs(15)
    x = jnp.asarray(t["x_bf"], jnp.bfloat16)
    xt = torch.from_numpy(t["x_bf"]).to(torch.bfloat16)
    if kind == "bf16":
        want = J15.run_bf16(x, jnp.asarray(t["w_bf"], jnp.bfloat16))
        got = P15.bf16_matmul(xt, torch.from_numpy(t["w_bf"]).to(
            torch.bfloat16))
    else:
        want = J15.run_int8(x, jnp.asarray(t["w8"]), jnp.asarray(t["s"]))
        got = P15.int8_matmul_staticq(
            xt, torch.from_numpy(t["w8"].T.copy()), torch.from_numpy(t["s"]))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _assert_steps(_np(got), np.asarray(want, np.float32), 1,
                  1e-6 if kind == "bf16" else 0.0)


# ---------------------------------------------------------------- 16

_J16 = {"full": (J16.k_full, jnp.bfloat16),
        "nogelu": (J16.k_nogelu, jnp.bfloat16),
        "bf16_epi": (J16.k_bf16_epi, jnp.bfloat16),
        "noquant": (J16.k_noquant, jnp.bfloat16),
        "pure": (J16.k_pure, jnp.int32)}


def _make_call(kernel, out_dtype, x, w, s, b):
    """`make`'s pallas_call (scripts/micro_epilogue.py:75-88), unchained:
    grid (M // ROWS,), x in row blocks, w, s and b whole."""
    rows = J16.ROWS
    return pl.pallas_call(
        kernel,
        grid=(M // rows,),
        in_specs=[pl.BlockSpec((rows, K), lambda i: (i, 0)),
                  pl.BlockSpec((K, N), lambda i: (0, 0)),
                  pl.BlockSpec((N,), lambda i: (0,)),
                  pl.BlockSpec((N,), lambda i: (0,))],
        out_specs=pl.BlockSpec((rows, N), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), out_dtype))(x, w, s, b)


@pytest.mark.parametrize("variant", P16.VARIANTS)
def test_k16_matches_pallas_interpret(variant, interpret):
    t = _gemm_inputs(16)
    quantised = variant in P16.QUANTISED
    x = t["x_bf"] if quantised else t["x_i8"]
    kernel, odt = _J16[variant]
    want = np.asarray(_make_call(
        kernel, odt, jnp.asarray(x, jnp.bfloat16 if quantised else jnp.int8),
        jnp.asarray(t["w8"]), jnp.asarray(t["s"]), jnp.asarray(t["b"])))
    xt = torch.from_numpy(x)
    got = P16.fc1_matmul(variant, xt.to(torch.bfloat16) if quantised else xt,
                         torch.from_numpy(t["w8"].T.copy()),
                         torch.from_numpy(t["s"]), torch.from_numpy(t["b"]))
    assert got.shape == (M, N)
    if variant == "pure":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.bfloat16
    steps, atol = {"full": (1, 1e-6), "bf16_epi": (2, 0.0)}.get(variant,
                                                                (1, 0.0))
    _assert_steps(_np(got), want.astype(np.float32), steps, atol)


# ---------------------------------------------------------------- 17


def _p8_ties(qkv, heads, hd, scale):
    """(B, S, heads): whether a row's probability code p·127/ap before
    rounding lies within 1e-3 of a tie for any key, from the probe's
    formulas (in f32, as the twin computes them)."""
    t = torch.from_numpy(qkv)
    b, s, _ = t.shape
    w = heads * hd
    c = P17.static_scales(scale)
    q, k = (common.quant_codes(t[..., i * w:(i + 1) * w].reshape(
        b, s, heads, hd).transpose(1, 2), c["inv_q" if i == 0 else "inv_k"])
        for i in range(2))
    p = torch.softmax((q @ k.transpose(-1, -2)) * c["fac"], dim=-1)
    pre = p * (127.0 / (p.amax(-1, keepdim=True) + 1e-20))
    frac = pre - torch.floor(pre)
    return ((frac - 0.5).abs() < 1e-3).any(-1).transpose(1, 2).numpy()


@pytest.mark.parametrize("b,s", [(1, 300), (2, 256)])
def test_k17_matches_pallas_interpret(b, s, interpret):
    heads, hd = 2, 128
    scale = hd ** -0.5
    qkv = _bf16(np.random.default_rng(s).standard_normal(
        (b, s, 3 * heads * hd)))
    fn = J17.static_variant()(heads, hd, scale)
    want = np.asarray(fn(jnp.asarray(qkv, jnp.bfloat16)), np.float32)
    got = P17.attention_qkv_int8_static(
        torch.from_numpy(qkv).to(torch.bfloat16), heads, hd, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, heads * hd)
    got = _np(got)
    assert np.isfinite(got).all()
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(b, s, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(qkv, heads, hd, scale)).any()
    assert bad.mean() <= 0.01


# ---------------------------------------------------------------- refusals


def test_k17_refuses_head_dim_64():
    qkv = torch.zeros((1, 64, 3 * 2 * 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 128"):
        P17.attention_qkv_int8_static(qkv, 2, 64)


@pytest.mark.parametrize("kernel", ["15-bf16", "15-int8"]
                         + [f"16-{v}" for v in P16.VARIANTS])
def test_probe_gemms_refuse_a_ragged_m(kernel):
    """M = 1000 is no multiple of the probes' 512-row block: the JAX grid
    (M // 512) would leave rows unwritten; the port raises."""
    x_bf = torch.zeros((1000, K), dtype=torch.bfloat16)
    x_i8 = torch.zeros((1000, K), dtype=torch.int8)
    wt = torch.zeros((N, K), dtype=torch.int8)
    s = b = torch.zeros(N)
    with pytest.raises(ValueError, match="M % 512 == 0"):
        if kernel == "15-bf16":
            P15.bf16_matmul(x_bf, torch.zeros((K, N), dtype=torch.bfloat16))
        elif kernel == "15-int8":
            P15.int8_matmul_staticq(x_bf, wt, s)
        else:
            v = kernel[3:]
            P16.fc1_matmul(v, x_bf if v in P16.QUANTISED else x_i8, wt, s, b)


@pytest.mark.parametrize("mod", [P15, P16, P17])
def test_probe_main_needs_a_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
