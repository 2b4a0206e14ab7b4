"""Parity of the port's float-tower kernels' twins, float tower and data
pipeline with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
  K13  twin vs `linear._reference` at f32: atol=rtol=2e-3; vs
       `_fused_linear_pallas(interpret=True)` at W=128 in bf16 (LN,
       residual and GELU forms): within one bf16 step (rtol 2^-7) plus
       atol 1e-2, because the f32 sums run in another order before the
       one bf16 rounding
  K14  twin vs `mlp._reference` at f32: 2e-3; vs
       `_mlp_block_pallas(interpret=True)` in bf16: as K13
  K9   twin vs `_attention_qkv_pallas(interpret=True)` at W=128, 2 heads
       of 64, S in {32, 64}, bf16: as K13 (p is rounded to bf16 in both);
       vs `_reference_qkv` with a per-key bias at f32: 2e-3
  tower  `siglip_forward` under F32_POLICY at test-64 and at base-256
       widths cut to 2 layers, on seeded numpy parameters in JAX's tree
       (`numpy_params`): pooled within 2e-3
  pipeline  every function at s=32 within 1e-5 (rot90 and flip exact);
       `pad_to_bucket` equal
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.data import pipeline as J_pipe
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.models.siglip import siglip_forward as j_siglip
from tpudf.ops.attention import _attention_qkv_pallas, _reference_qkv
from tpudf.ops.linear import _fused_linear_pallas
from tpudf.ops.linear import _reference as j_linear_ref
from tpudf.ops.mlp import _mlp_block_pallas
from tpudf.ops.mlp import _reference as j_mlp_ref
from tpudf.serve.engine import pad_to_bucket as j_pad_to_bucket
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.data import pipeline as P
from tpudf_torch.models.siglip import CONFIGS, siglip_forward
from tpudf_torch.ops.attention import attention_qkv_reference
from tpudf_torch.ops.linear import linear_fused, linear_fused_reference
from tpudf_torch.ops.mlp import mlp_block_fused, mlp_block_reference
from tpudf_torch.serve.engine import pad_to_bucket

W, HEADS, HD, INTER = 128, 2, 64, 256
BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side of these tests: at their
    sizes torch's thread pool costs more than it saves (on one thread the
    port's test files take about a third less process CPU). Imported by
    the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf(a):
    """The same bf16 values on both sides."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _linear_data(seed, n=200, din=W, dout=2 * W):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return {"x": f(n, din), "w": f(din, dout, std=din ** -0.5),
            "b": f(dout, std=0.1), "g": 1 + f(din, std=0.1),
            "beta": f(din, std=0.1), "res": f(n, dout)}


_FORMS = {"ln": dict(ln=True), "residual": dict(res=True),
          "gelu": dict(activation="gelu")}


def _jax_linear(fn, d, form, cast):
    kw = _FORMS[form]
    ln = (jnp.asarray(d["g"]), jnp.asarray(d["beta"])) if kw.get("ln") \
        else None
    res = cast(d["res"]) if kw.get("res") else None
    return fn(cast(d["x"]), cast(d["w"]), jnp.asarray(d["b"]), ln, res, 1e-6,
              activation=kw.get("activation"))


def _torch_linear(d, form, cast):
    kw = _FORMS[form]
    ln = ((torch.from_numpy(d["g"]), torch.from_numpy(d["beta"]))
          if kw.get("ln") else None)
    res = cast(d["res"]) if kw.get("res") else None
    return linear_fused(cast(d["x"]), cast(d["w"]), torch.from_numpy(d["b"]),
                        ln=ln, residual=res, activation=kw.get("activation"))


@pytest.mark.parametrize("form", list(_FORMS))
def test_k13_twin_matches_jax_reference_f32(form):
    d = _linear_data(0)
    want = _jax_linear(j_linear_ref, d, form, jnp.asarray)
    got = _torch_linear(d, form, torch.from_numpy)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("form", list(_FORMS))
def test_k13_twin_matches_pallas_interpret_bf16(form):
    d = _linear_data(1)
    want = _jax_linear(
        lambda *a, activation=None: _fused_linear_pallas(
            *a, activation=activation, interpret=True),
        d, form, lambda a: _bf(a)[0])
    got = _torch_linear(d, form, lambda a: _bf(a)[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_STEP)


def _mlp_data(seed, n=200):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    return {"x": f(n, W), "g": 1 + f(W, std=0.1), "beta": f(W, std=0.1),
            "w1": f(W, INTER, std=W ** -0.5), "b1": f(INTER, std=0.1),
            "w2": f(INTER, W, std=INTER ** -0.5), "b2": f(W, std=0.1)}


def _torch_mlp(d, cast):
    ln = {"scale": torch.from_numpy(d["g"]),
          "bias": torch.from_numpy(d["beta"])}
    mp = {"fc1_w": cast(d["w1"]), "fc1_b": torch.from_numpy(d["b1"]),
          "fc2_w": cast(d["w2"]), "fc2_b": torch.from_numpy(d["b2"])}
    return mlp_block_fused(cast(d["x"]), ln, mp)


def test_k14_twin_matches_jax_reference_f32():
    d = _mlp_data(2)
    want = j_mlp_ref(*(jnp.asarray(d[k]) for k in
                       ("x", "g", "beta", "w1", "b1", "w2", "b2")), 1e-6)
    got = _torch_mlp(d, torch.from_numpy)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def test_k14_twin_matches_pallas_interpret_bf16():
    d = _mlp_data(3)
    c = lambda k: _bf(d[k])[0]
    f = lambda k: jnp.asarray(d[k])
    want = _mlp_block_pallas(c("x"), f("g"), f("beta"), c("w1"), f("b1"),
                             c("w2"), f("b2"), 1e-6, interpret=True)
    got = _torch_mlp(d, lambda a: _bf(a)[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_STEP)


def test_k14_twin_is_the_composition_of_k13():
    """K14 = K13(LN, GELU) then K13(residual): the same arithmetic."""
    d = _mlp_data(4)
    x, w1, w2 = (_bf(d[k])[1] for k in ("x", "w1", "w2"))
    g, beta = torch.from_numpy(d["g"]), torch.from_numpy(d["beta"])
    h = linear_fused_reference(x, w1, torch.from_numpy(d["b1"]),
                               ln=(g, beta), activation="gelu")
    want = linear_fused_reference(h, w2, torch.from_numpy(d["b2"]),
                                  residual=x)
    b1, b2 = torch.from_numpy(d["b1"]), torch.from_numpy(d["b2"])
    got = mlp_block_reference(x, {"scale": g, "bias": beta},
                              {"fc1_w": w1, "fc1_b": b1, "fc2_w": w2,
                               "fc2_b": b2})
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("s", [32, 64])
def test_k9_twin_matches_pallas_interpret_bf16(s):
    rng = np.random.default_rng(s)
    qkv = rng.standard_normal((2, s, 3 * W)).astype(np.float32)
    jq, tq = _bf(qkv)
    want = _attention_qkv_pallas(jq, HEADS, HD, HD ** -0.5, interpret=True)
    got = attention_qkv_reference(tq, HEADS, HD)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_STEP)


def test_k9_twin_matches_jax_reference_with_bias_f32():
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((2, 40, 3 * W)).astype(np.float32)
    bias = np.log(rng.integers(1, 6, (2, 40))).astype(np.float32)
    want = _reference_qkv(jnp.asarray(qkv), HEADS, HD, HD ** -0.5,
                          jnp.asarray(bias))
    got = attention_qkv_reference(torch.from_numpy(qkv), HEADS, HD,
                                  logit_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def numpy_params(init, seed):
    """Seeded numpy parameters in the tree of the JAX init call `init()`,
    of which only the shapes are taken (no JAX random op runs): weights
    N(0, 1/fan_in) with fan_in the second-last axis, LN scales
    1 + N(0, 0.05²), biases N(0, 0.05²), the position embedding and the
    MAP probe N(0, 0.02²)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1 + np.float32(0.05) * n
        if name in ("bias", "b") or name.endswith("_b"):
            return np.float32(0.05) * n
        if name in ("pos", "probe"):
            return np.float32(0.02) * n
        return n * np.float32(s.shape[-2] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


@pytest.mark.parametrize("cfg_name,batch", [("test-64", 2), ("base-256", 1)])
def test_float_tower_matches_jax_f32(cfg_name, batch):
    """The port's float block (K13 → K9 → K13 → K14 twins) and its tower
    against JAX's `_block_apply_impl` float path, 2 layers."""
    jcfg = dataclasses.replace(J_CONFIGS[cfg_name], layers=2)
    cfg = dataclasses.replace(CONFIGS[cfg_name], layers=2)
    params = numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg), 0)
    s = cfg.image_size
    px = np.random.default_rng(1).uniform(-1, 1, (batch, s, s, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: j_siglip(p, x, jcfg, J_F32)["pooled"])(
        params, px)
    got = siglip_forward(params_from_numpy(params, "cpu"),
                         torch.from_numpy(px), cfg, F32_POLICY)["pooled"]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=0)


# ---------------------------------------------------------------- pipeline

def _pipe_case(name, x):
    """(JAX result, port result) of one pipeline function on x."""
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cases = {
        "normalize_siglip": lambda m, a: m.normalize_siglip(a),
        "rgb_to_gray": lambda m, a: m.rgb_to_gray(a),
        "multicrops": lambda m, a: m.make_multicrops(a)[0],
        "multicrop_weights": lambda m, a: m.make_multicrops(a)[1],
        "patch_grid": lambda m, a: m.make_patch_grid(a, 4),
        "rot90_view": lambda m, a: m.rot90_view(a),
        "tta_views": lambda m, a: m.tta_views(a, vflip=True, rot=True),
        "center_crop": lambda m, a: m.center_crop(a, 20),
        "resize_bilinear_up": lambda m, a: m.resize_bilinear(a, 48),
        "resize_bilinear_down": lambda m, a: m.resize_bilinear(a, 20),
        "resize_bicubic_up": lambda m, a: m.resize_bicubic(a, 48),
        "resize_bicubic_down": lambda m, a: m.resize_bicubic(a, 20),
        "preprocess_bicubic": lambda m, a: m.preprocess_for_siglip(a, 24),
        "preprocess_bilinear": lambda m, a: m.preprocess_for_siglip(
            a, 40, method="bilinear"),
    }
    fn = cases[name]
    return np.asarray(fn(J_pipe, jx)), _np(fn(P, tx))


@pytest.mark.parametrize("name", [
    "normalize_siglip", "rgb_to_gray", "multicrops", "multicrop_weights",
    "patch_grid", "rot90_view", "tta_views", "center_crop",
    "resize_bilinear_up", "resize_bilinear_down", "resize_bicubic_up",
    "resize_bicubic_down", "preprocess_bicubic", "preprocess_bilinear"])
def test_pipeline_matches_jax(name):
    x = np.random.default_rng(9).random((2, 32, 32, 3)).astype(np.float32)
    want, got = _pipe_case(name, x)
    assert got.shape == want.shape
    if name in ("rot90_view", "tta_views", "center_crop"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rot90_and_flip_match_jnp():
    x = np.random.default_rng(10).random((2, 6, 5, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        torch.rot90(t, 1, dims=(1, 2)).numpy(),
        np.asarray(jnp.rot90(jnp.asarray(x), k=1, axes=(1, 2))))
    np.testing.assert_array_equal(torch.flip(t, dims=(2,)).numpy(),
                                  np.asarray(jnp.flip(jnp.asarray(x), axis=2)))


def test_normalize_uint8_matches_jax():
    x = np.random.default_rng(11).integers(0, 256, (2, 8, 8, 3), np.uint8)
    np.testing.assert_allclose(
        _np(P.normalize_siglip(torch.from_numpy(x))),
        np.asarray(J_pipe.normalize_siglip(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("b,max_batch", [(1, None), (3, None), (5, 4),
                                         (8, None), (6, 16)])
def test_pad_to_bucket_matches_jax(b, max_batch):
    x = np.random.default_rng(b).integers(0, 256, (b, 4, 4, 3), np.uint8)
    np.testing.assert_array_equal(pad_to_bucket(x, max_batch),
                                  j_pad_to_bucket(x, max_batch))
