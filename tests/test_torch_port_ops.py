"""Parity of tpudf_torch's ops with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Each
kernel's plain twin (what a kernel wrapper runs on a CPU tensor) is held
against the JAX reference form, and against the Pallas kernel in interpret
mode where its geometry allows (W=128, 2 heads of 64, S in {32, 64}):
  K1, K2  atol=rtol=2e-3 vs the reference form; 5e-2 vs interpret (the
          kernel rounds qkv and p to bf16); int8 codes equal except at
          rounding ties; Σout² rtol 1e-3
  K3      rtol 1e-5 vs the reference form; 2e-4 vs interpret (separable
          stencil reassociation)
  K4      within one bf16 step
The card-only tests are in tests/test_torch_port_gpu.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.ops import int8_block as J_int8
from tpudf.ops import layernorm as J_ln
from tpudf.ops import mlp as J_mlp
from tpudf.ops import quant as J_quant
from tpudf.ops import srm as J_srm
from tpudf.ops import tome as J_tome
from tpudf.ops.fft_features import extract_freq_vector as j_freq
from tpudf_torch.ops import int8_block, layernorm, mlp, quant, srm, tome
from tpudf_torch.ops.fft_features import extract_freq_vector

W, HEADS, HD, INTER = 128, 2, 64, 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(v):
    a = np.abs(np.asarray(v, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def _attn_inputs(rng, b, s):
    qkv_wq = J_quant.quantize_weight(
        jnp.asarray(rng.normal(0, 0.05, (W, 3 * W)), jnp.float32))
    out_wq = J_quant.quantize_weight(
        jnp.asarray(rng.normal(0, 0.05, (W, W)), jnp.float32))
    return {
        "x": rng.normal(0, 1, (b, s, W)).astype(np.float32),
        "ln": {"scale": rng.normal(1, 0.1, (W,)).astype(np.float32),
               "bias": rng.normal(0, 0.1, (W,)).astype(np.float32)},
        "qkv_wq": {k: np.asarray(v) for k, v in qkv_wq.items()},
        "qkv_b": rng.normal(0, 0.1, (3 * W,)).astype(np.float32),
        "out_wq": {k: np.asarray(v) for k, v in out_wq.items()},
        "out_b": rng.normal(0, 0.1, (W,)).astype(np.float32),
        "lb": rng.normal(0, 0.5, (b, s)).astype(np.float32),
    }


@pytest.mark.parametrize("b,s,with_bias", [(4, 32, True), (2, 64, False)])
def test_k1_twin_matches_jax(b, s, with_bias):
    d = _attn_inputs(np.random.default_rng(11 + s), b, s)
    lb = d["lb"] if with_bias else None
    jargs = (jnp.asarray(d["x"]), {k: jnp.asarray(v) for k, v in d["ln"].items()},
             {k: jnp.asarray(v) for k, v in d["qkv_wq"].items()},
             jnp.asarray(d["qkv_b"]),
             {k: jnp.asarray(v) for k, v in d["out_wq"].items()},
             jnp.asarray(d["out_b"]), 3.0, 2.0)
    jlb = None if lb is None else jnp.asarray(lb)
    def jax_k1(interpret):
        fn = lambda *a: J_int8.attn_sublayer_int8(*a, HEADS, HD, logit_bias=jlb,
                                                  interpret=interpret)
        return np.asarray(jax.jit(fn)(*jargs))

    ref, interp = jax_k1(False), jax_k1(True)
    got = int8_block.attn_sublayer_int8(
        _t(d["x"]), _tree_t(d["ln"]), _tree_t(d["qkv_wq"]), _t(d["qkv_b"]),
        _tree_t(d["out_wq"]), _t(d["out_b"]), torch.tensor(3.0),
        torch.tensor(2.0), HEADS, HD,
        logit_bias=None if lb is None else _t(lb))
    np.testing.assert_allclose(_np(got), ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(got), interp, atol=5e-2, rtol=5e-2)


def test_int8_codes_match_jax_except_ties():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (256, W)).astype(np.float32)
    g = rng.normal(1, 0.1, (W,)).astype(np.float32)
    b = rng.normal(0, 0.1, (W,)).astype(np.float32)
    a = 3.0
    x32 = jnp.asarray(x)
    mu = jnp.mean(x32, -1, keepdims=True)
    var = jnp.maximum(jnp.mean(x32 * x32, -1, keepdims=True) - mu * mu, 0.0)
    y = (x32 - mu) * jax.lax.rsqrt(var + 1e-6) * g + b
    pre = np.asarray(y * (127.0 / jnp.float32(a)))
    want = np.asarray(J_int8._quant_rows(y, jnp.float32(a)))
    got = quant.quant_rows(int8_block.ln_rows_f32(_t(x), _t(g), _t(b), 1e-6),
                           torch.tensor(a)).numpy()
    tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5) < 1e-3
    diff = got != want
    assert not (diff & ~tie).any()
    assert diff.mean() < 1e-3


@pytest.mark.parametrize("s", [32, 64])
def test_k2_twin_matches_jax(s):
    rng = np.random.default_rng(20 + s)
    x = rng.normal(0, 1, (2, s, W)).astype(np.float32)
    ln = {"scale": rng.normal(1, 0.1, (W,)).astype(np.float32),
          "bias": rng.normal(0, 0.1, (W,)).astype(np.float32)}
    qw = lambda a, c: {k: np.asarray(v) for k, v in J_quant.quantize_weight(
        jnp.asarray(rng.normal(0, 0.05, (a, c)), jnp.float32)).items()}
    mq = {"fc1_w": qw(W, INTER),
          "fc1_b": rng.normal(0, 0.1, (INTER,)).astype(np.float32),
          "fc2_w": qw(INTER, W),
          "fc2_b": rng.normal(0, 0.1, (W,)).astype(np.float32)}
    jmq = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else jnp.asarray(v))
           for k, v in mq.items()}
    jln = {k: jnp.asarray(v) for k, v in ln.items()}
    sc = {"fc1": 3.0, "fc2": 2.0}
    def jax_k2(interpret):
        return jax.jit(lambda *a: J_mlp.mlp_block_fused_int8(
            *a, emit_sumsq=True, interpret=interpret))(x, jln, jmq, sc)

    (ref, ref_ss), (interp, interp_ss) = jax_k2(False), jax_k2(True)
    got, got_ss = mlp.mlp_block_fused_int8(
        _t(x), _tree_t(ln), _tree_t(mq),
        {"fc1": torch.tensor(3.0), "fc2": torch.tensor(2.0)}, emit_sumsq=True)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(got), np.asarray(interp), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(_np(got_ss), np.asarray(ref_ss), rtol=1e-3)
    np.testing.assert_allclose(_np(got_ss), np.asarray(interp_ss), rtol=1e-3)
    plain = mlp.mlp_block_fused_int8(
        _t(x), _tree_t(ln), _tree_t(mq),
        {"fc1": torch.tensor(3.0), "fc2": torch.tensor(2.0)})
    np.testing.assert_array_equal(_np(plain), _np(got))


def test_k3_twin_matches_jax():
    rng = np.random.default_rng(5)
    base = rng.random((64, 128)).astype(np.float32)
    gray = np.stack([base, base[::-1], base[:, ::-1], base * 0.5 + 0.25])
    ref = np.asarray(J_srm.srm_raw_moments(jnp.asarray(gray)))
    interp = np.asarray(J_srm.srm_raw_moments(jnp.asarray(gray),
                                              interpret=True))
    got = srm.srm_raw_moments(_t(gray)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got, interp, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(
        srm.srm_features(_t(gray)).numpy(),
        np.asarray(J_srm.srm_features(jnp.asarray(gray))), rtol=1e-4,
        atol=1e-6)


@pytest.mark.parametrize("rows", [64, 200])
def test_k4_twin_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = (rng.normal(0.5, 3.0, (rows, W))).astype(np.float32)
    s = rng.normal(1, 0.1, (W,)).astype(np.float32)
    b = rng.normal(0, 0.1, (W,)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(J_ln.layer_norm_fused(xb, jnp.asarray(s), jnp.asarray(b)),
                     np.float32)
    interp = np.asarray(J_ln.layer_norm_fused(
        xb, jnp.asarray(s), jnp.asarray(b), interpret=True), np.float32)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = layernorm.layer_norm_fused(tx, _t(s), _t(b))
    assert got.dtype == torch.bfloat16
    for want in (ref, interp):
        assert (np.abs(_np(got) - want) <= _bf16_ulp(want)).all()


def test_freq_vector_matches_jax():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:128, 0:128] / 128.0
    img = 0.5 + 0.3 * np.sin(9 * xx) * np.cos(5 * yy)
    gray = np.stack([img + 0.05 * rng.standard_normal(img.shape),
                     rng.random(img.shape)]).astype(np.float32)
    ref = np.asarray(jax.jit(j_freq)(gray))
    got = extract_freq_vector(_t(gray)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("with_sumsq", [False, True])
def test_merge_step_matches_jax(with_sumsq):
    rng = np.random.default_rng(13)
    x = rng.normal(0, 1, (2, 64, 64)).astype(np.float32)
    sizes = rng.integers(1, 5, (2, 64)).astype(np.float32)
    ss = (x.astype(np.float32) ** 2).sum(-1) if with_sumsq else None
    jx, js = jax.jit(J_tome.merge_step, static_argnums=2)(
        x, sizes, 16, None if ss is None else jnp.asarray(ss))
    tx, ts = tome.merge_step(_t(x), _t(sizes), 16,
                             sumsq=None if ss is None else _t(ss))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


def test_merge_schedule_and_floor_match_jax():
    for n, layers, r in ((256, 12, 96), (576, 24, 96), (64, 2, 96),
                         (1024, 27, 32)):
        floor = tome.deployed_floor(n)
        assert floor == J_tome.deployed_floor(n)
        assert tome.merge_schedule(n, layers, r, floor) == \
            J_tome.merge_schedule(n, layers, r, floor)
    assert tome.merge_schedule(256, 12, 96, 32)[:5] == (96, 80, 40, 8, 0)


def test_quantize_weight_matches_jax():
    w = np.random.default_rng(2).normal(0, 0.05, (96, 40)).astype(np.float32)
    w[:, 3] = 0.0
    jq = J_quant.quantize_weight(jnp.asarray(w))
    tq = quant.quantize_weight(_t(w))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))


def test_port_imports_no_jax_and_no_tpudf():
    pkg = Path(__file__).resolve().parents[1] / "tpudf_torch"
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpudf)(\.|\s|$)", re.M)
    offenders = [str(p) for p in pkg.rglob("*.py") if bad.search(p.read_text())]
    assert offenders == []
    smoke = pkg.parent / "chip_smoke.py"
    assert not bad.search(smoke.read_text())
