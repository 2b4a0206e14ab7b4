"""The int8 GEMM on wgmma and TMA (tpudf_torch/csrc/int8_gemm_sm90.cu, the
launch behind `tpudf_i8_gemm`): a numpy model of its tile, that model
against the port's twins and JAX's Pallas kernel bodies, and the wrapper's
domain, on the CPU.

  (a) the domain  `check_i8_gemm` takes int8 (M, K) x (N, K) with N % 128
      == 0 and K % 64 == 0 at any M >= 1, and nothing else; K2's and the
      int32 product's checks refuse what it refuses
  (b) the model  `i8_tile_model`: the kernel's arithmetic in its order: A
      and the weight zero-filled to whole 128-row tiles and 128-deep K
      slices, as TMA delivers them; exact int32 sums of four k32 steps a
      slice; at N % 256 == 128 the 256-wide tile's far 128 columns summed
      from a stage holding another tile's codes and never stored; the
      epilogue per mode in f32 op by op (acc * ((act / 127) * col_scale)
      + bias, then GELU and the int8 quant with act_out, or the residual
      added and one bf16 rounding); the sum of out^2 of each row from its
      quad's four threads (each over its columns in the passes' order),
      reduced by xor shuffles 1 then 2, the column tiles' sums added: it
      equals the port's twin epilogue bit for bit in the bf16, residual
      and int32 modes, and the sums of out^2 within rtol 1e-4; the int8
      codes but for at most 1e-5 of them, by one (the twin's 127 / act_out
      is torch's reciprocal times 127, one rounding more than the IEEE
      division of the kernel and of JAX)
  (c) JAX  K2 (`tpudf/ops/mlp.py:92,116` `_kernel_int8`,
      `_kernel_int8_ss`) and probe 16 (`scripts/micro_epilogue.py:59,67`
      `k_noquant`, `k_pure`) in Pallas interpret mode (their kernel bodies
      through pl.pallas_call) at M 300, K 1152 and N = 1152 (N % 256 ==
      128: the half tile) against the model: K2 within 5e-2 (PERF.md §6:
      int8 ties), its sums of out^2 within rtol 1e-4 of its own output's;
      k_pure equal, k_noquant within one bf16 step
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.ops import mlp as J_mlp
from tpudf_torch.ops import int8_block, layernorm, quant
from tpudf_torch.utils.nn import gelu_tanh

import scripts.micro_epilogue as J16

TILE_M, SLICE_K = 128, 128
BF16, GELU_I8, RESIDUAL, I32 = 0, 1, 2, 3


# ------------------------------------------------------------ (a) domain

def test_i8_gemm_domain_on_a_grid():
    """The wrapper takes N % 128 == 0 and K % 64 == 0 at any M, and K2's
    and the int32 product's checks refuse what it refuses."""
    taken = 0
    for k in (32, 64, 96, 768, 832, 1152, 4304, 4352):
        for n in (64, 128, 384, 640, 768, 1152, 2304, 4304, 4352):
            wt = torch.empty((n, k), dtype=torch.int8, device="meta")
            want = n % 128 == 0 and k % 64 == 0
            try:
                int8_block.check_i8_gemm(k, wt)
                got = True
            except ValueError:
                got = False
            assert got == want, (k, n)
            a8 = torch.empty((300, k), dtype=torch.int8, device="meta")
            try:
                quant.check_int8_acc(a8, {"q": wt.t()})
                got32 = True
            except ValueError:
                got32 = False
            assert got32 == want, (k, n)
            taken += got
    assert taken == 5 * 7
    with pytest.raises(ValueError):      # a weight of another depth
        int8_block.check_i8_gemm(768, torch.empty((768, 832),
                                                  dtype=torch.int8))


# ------------------------------------------------------------ (b) model

def _codes(rng, *shape):
    return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)


def i8_tile_model(a8, wt, mode, cs=None, bias=None, act=None, res=None,
                  act_out=None, tile_n=256, seed=0):
    """The kernel's arithmetic in its order (numpy): returns (out, sum of
    out^2 per row or None)."""
    m, k = a8.shape
    n = wt.shape[0]
    mp = -(-m // TILE_M) * TILE_M
    kp = -(-k // SLICE_K) * SLICE_K
    np_ = -(-n // tile_n) * tile_n
    a = np.zeros((mp, kp), np.int64)
    a[:m, :k] = a8
    w = np.zeros((np_, kp), np.int64)
    w[:n, :k] = wt
    # a half tile's far columns: the stage holds another tile's codes
    w[n:] = _codes(np.random.default_rng(seed), np_ - n, kp)
    # exact int32 sums, a 128-deep slice (four k32 steps) at a time, in
    # float64 on torch's one intra-op thread: every partial sum is an
    # integer below 2^53, so each product is exact and the order of the
    # steps within a slice cannot show
    a, w = torch.from_numpy(a).double(), torch.from_numpy(w).double()
    acc = torch.zeros((mp, np_), dtype=torch.float64)
    for s0 in range(0, kp, SLICE_K):
        acc += a[:, s0:s0 + SLICE_K] @ w[:, s0:s0 + SLICE_K].T
    acc = acc.numpy()
    assert np.abs(acc).max() < 2 ** 31
    acc = acc[:m, :n].astype(np.int64).astype(np.int32)
    if mode == I32:
        return acc, None
    f32 = np.float32
    a_div = f32(f32(act) / f32(127.0))
    csn = (a_div * cs.astype(f32)).astype(f32)
    f = ((acc.astype(f32) * csn).astype(f32) + bias.astype(f32)).astype(f32)
    if mode == BF16:
        return _bf16(f), None
    if mode == GELU_I8:
        g = gelu_tanh(torch.from_numpy(f)).numpy()
        inv = f32(f32(127.0) / f32(act_out))
        return np.clip(np.rint((g * inv).astype(f32)), -127,
                       127).astype(np.int8), None
    y = _bf16((res.astype(f32) + f).astype(f32))
    # sum of out^2: thread t of a row's quad holds columns 8 j + 2 t, + 1
    # of each 8; it adds y0^2 + y1^2 of its pairs in column order within a
    # tile; the quad reduces by xor 1, then xor 2; the tiles add up
    ss = np.zeros(m, f32)
    for n0 in range(0, n, tile_n):
        part = np.zeros((m, 4), f32)
        for j in range(0, min(tile_n, n - n0), 8):
            for t in range(4):
                c = n0 + j + 2 * t
                y0, y1 = y[:, c], y[:, c + 1]
                part[:, t] = (part[:, t] + (y0 * y0 + y1 * y1)).astype(f32)
        q = (part[:, [0, 2]] + part[:, [1, 3]]).astype(f32)   # xor 1
        ss = (ss + (q[:, 0] + q[:, 1])).astype(f32)            # xor 2
    return y, ss


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _twin(acc, mode, cs, bias, act, res, act_out):
    """The port's twin epilogue (torch) on exact int32 sums."""
    t = lambda a: torch.from_numpy(np.asarray(a))
    f = t(acc).float() * ((t(act) / 127.0) * t(cs)) + t(bias)
    if mode == BF16:
        return f.to(torch.bfloat16).float().numpy()
    if mode == GELU_I8:
        return quant.quant_rows(gelu_tanh(f), t(act_out)).numpy()
    return (t(res).float() + f).to(torch.bfloat16).float().numpy()


_EDGES = [(300, 1152, 1152, 256), (300, 832, 384, 256), (129, 768, 640, 128),
          (40, 4352, 768, 256)]


@pytest.mark.parametrize("mode", [BF16, GELU_I8, RESIDUAL, I32])
@pytest.mark.parametrize("m,k,n,tile_n", _EDGES)
def test_tile_model_equals_twin(m, k, n, tile_n, mode):
    rng = np.random.default_rng(m + k + n + mode)
    a8, wt = _codes(rng, m, k), _codes(rng, n, k)
    cs = (rng.random(n) * 1e-3 + 1e-3).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    act, act_out = np.float32(4.0), np.float32(3.0)
    res = _bf16(rng.normal(0, 1, (m, n)))
    got, ss = i8_tile_model(a8, wt, mode, cs, bias, act, res, act_out,
                            tile_n)
    acc = quant.int8_mm(torch.from_numpy(a8), torch.from_numpy(wt).t())
    if mode == I32:
        np.testing.assert_array_equal(got, acc.numpy())
        return
    want = _twin(acc.numpy(), mode, cs, bias, act, res, act_out)
    if mode == GELU_I8:
        diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5
        return
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))
    if mode == RESIDUAL:
        own = (want.astype(np.float64) ** 2).sum(-1)
        np.testing.assert_allclose(ss, own, rtol=1e-4)


# ------------------------------------------------------------ (c) JAX

M, K, N = 300, 1152, 1152


@pytest.mark.parametrize("emit_sumsq", [False, True])
def test_k2_pallas_body_matches_the_model(emit_sumsq):
    """K2's Pallas kernel body (one program over all M rows) against LN +
    quant (the twin's) and the model's fc1 (GELU + quant) and fc2
    (residual, sum of out^2)."""
    rng = np.random.default_rng(12)
    w, inter = K, N
    x = _bf16(rng.normal(0, 1, (M, w)))
    g = (1 + rng.normal(0, 0.1, w)).astype(np.float32)
    b = rng.normal(0, 0.1, w).astype(np.float32)

    def qw(a, c):                     # the port's quantize_weight (JAX's)
        wq = quant.quantize_weight(torch.from_numpy(
            rng.normal(0, a ** -0.5, (a, c)).astype(np.float32)))
        return wq["q"].numpy(), wq["scale"].numpy()

    w1, s1 = qw(w, inter)
    w2, s2 = qw(inter, w)
    b1 = rng.normal(0, 0.1, inter).astype(np.float32)
    b2 = rng.normal(0, 0.1, w).astype(np.float32)
    a1, a2 = np.float32(4.0), np.float32(3.0)
    kern = J_mlp._kernel_int8_ss if emit_sumsq else J_mlp._kernel_int8
    out_shape = [jax.ShapeDtypeStruct((M, w), jnp.bfloat16)]
    if emit_sumsq:
        out_shape.append(jax.ShapeDtypeStruct((M, 128), jnp.float32))
    outs = pl.pallas_call(functools.partial(kern, eps=1e-6),
                          out_shape=out_shape, interpret=True)(
        jnp.asarray(x, jnp.bfloat16), g[None], b[None], w1, s1[None],
        b1[None], w2, s2[None], b2[None], jnp.asarray([a1]),
        jnp.asarray([a2]))
    want = np.asarray(outs[0], np.float32)
    # the port: LN + quant (K8's twin), then the model's two launches
    h8 = layernorm.layer_norm_quant_reference(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g),
        torch.from_numpy(b), torch.tensor(a1)).numpy()
    hid, _ = i8_tile_model(h8, w1.T.copy(), GELU_I8, s1, b1, a1,
                           act_out=a2)
    got, ss = i8_tile_model(hid, w2.T.copy(), RESIDUAL, s2, b2, a2, x)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(ss, (got.astype(np.float64) ** 2).sum(-1),
                               rtol=1e-4)
    if emit_sumsq:
        own = np.asarray(outs[1], np.float32)[:, 0]
        np.testing.assert_allclose(own, (want.astype(np.float64) ** 2)
                                   .sum(-1), rtol=1e-4)


@pytest.mark.parametrize("variant", ["pure", "noquant"])
def test_probe16_pallas_body_matches_the_model(variant):
    """Probe 16's `k_pure` and `k_noquant` bodies (one program over all M
    rows) against the model in kEpiI32 and kEpiBf16 at act 4."""
    rng = np.random.default_rng(16)
    x8, w = _codes(rng, M, K), _codes(rng, K, N)
    s = (rng.random(N) * 0.01 + 0.01).astype(np.float32)
    b = rng.random(N).astype(np.float32)
    body = {"pure": J16.k_pure, "noquant": J16.k_noquant}[variant]
    dt = jnp.int32 if variant == "pure" else jnp.bfloat16
    want = np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((M, N), dt), interpret=True)(
        x8, w, s[None], b[None]))
    mode = I32 if variant == "pure" else BF16
    got, _ = i8_tile_model(x8, w.T.copy(), mode, s, b, np.float32(4.0))
    if variant == "pure":
        np.testing.assert_array_equal(got, want)
        return
    want = want.astype(np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(
        np.abs(got), np.abs(want)), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()
