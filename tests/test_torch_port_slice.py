"""Parity of the tpudf_torch detect-core slice with the JAX package, on the
CPU, under F32_POLICY (the point is the algorithm; bf16 rounds at other
places in the two frameworks).

The JAX side composes `__graft_entry__.entry()`'s forward with the policy as
a parameter: static-W8A8 tower + ToMe at the deployed r=96 / floor S/8, MAP
head, v5 head, 24-d frequency vector, frequency MLP, Linear(2→1) fusion,
CORAL. Its float parameters are the port's seeded init with random biases
and LN parameters; JAX calibrates and quantises them, and the trees cross to
the port through `tpudf_torch.convert`. Geometries: `test-64` (W=64, 2 layers, one
merge of 32 tokens) and base-256 widths cut to 2 layers (one merge of 96).
Tolerance: atol 2e-3 on pooled, z_sig, z_freq, p_blend and risk_probs with
a float tower; with the W8A8 tower see `_W8A8_ATOL` for pooled and z_sig;
pooled cosine >= 0.999 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.calib.coral import CoralCutpoints as JCuts
from tpudf.calib.coral import coral_blend as j_coral_blend
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models.freq_mlp import apply_freq_mlp as j_freq_mlp
from tpudf.models.freq_mlp import init_freq_mlp as j_init_freq
from tpudf.models.fusion import apply_fusion_linear as j_fusion
from tpudf.models.fusion import init_fusion_linear as j_init_fusion
from tpudf.models.heads import apply_binary_head as j_head
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.models.siglip import siglip_forward as j_siglip
from tpudf.ops.fft_features import extract_freq_vector as j_freq
from tpudf.ops.quant import calibrate_siglip_act_scales as j_calibrate
from tpudf.ops.quant import quantize_siglip_static as j_quantize
from tpudf.ops.tome import DEPLOYED_TOME_R, deployed_floor as j_floor
from tpudf_torch.calib.coral import CoralCutpoints
from tpudf_torch.convert import params_from_numpy, params_to_numpy
from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.entry import (ENTRY_KEYS, DetectCore, build, detect_core,
                               init_params)
from tpudf_torch.models.siglip import CONFIGS, siglip_forward

GRAY = (0.299, 0.587, 0.114)


_SETUPS = {}


def _jitter(tree, rng, path=()):
    """Random biases and LN parameters in place of init's zeros and ones,
    so that the slice exercises every bias and LN affine."""
    if isinstance(tree, dict):
        return {k: _jitter(v, rng, path + (k,)) for k, v in tree.items()}
    if path[-1] in ("bias", "scale", "b") or path[-1].endswith("_b"):
        return (tree + rng.normal(0, 0.05, tree.shape)).astype(tree.dtype)
    return tree


def _setup(cfg_name, layers=2):
    """Float and static-W8A8 numpy parameters of a geometry, cached for the
    module. The float tree is the port's seeded init (its layout is held to
    JAX's by test_init_layout_matches_jax); calibration and quantisation are
    JAX's, jitted as entry() does."""
    key = (cfg_name, layers)
    if key not in _SETUPS:
        jcfg = dataclasses.replace(J_CONFIGS[cfg_name], layers=layers)
        cfg = dataclasses.replace(CONFIGS[cfg_name], layers=layers)
        floats = _jitter(params_to_numpy(init_params(
            torch.Generator().manual_seed(3), cfg)), np.random.default_rng(3))
        calib = np.random.default_rng(5).uniform(
            -1, 1, (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        quantized = jax.jit(lambda bb, px: j_quantize(
            bb, j_calibrate(bb, jcfg, px, J_F32), jcfg))(floats["backbone"],
                                                         calib)
        _SETUPS[key] = (jcfg, cfg, floats,
                        {**floats, "backbone": _numpy_tree(quantized)})
    return _SETUPS[key]


def _jax_slice(params, pixels, cfg):
    """entry()'s forward under F32_POLICY."""
    px = jnp.asarray(pixels, jnp.float32)
    out = j_siglip(params["backbone"], (px - 0.5) / 0.5, cfg, J_F32,
                   tome_r=DEPLOYED_TOME_R, tome_floor=j_floor(cfg.num_patches))
    pooled = out["pooled"]
    z_sig = j_head(params["head"], pooled)
    gray = jnp.einsum("bhwc,c->bhw", px, jnp.asarray(GRAY, jnp.float32))
    z_freq = j_freq_mlp(params["freq"], j_freq(gray))
    z_fused = j_fusion(params["fusion"], jax.nn.sigmoid(z_sig),
                       jax.nn.sigmoid(z_freq))
    co = j_coral_blend(z_fused, JCuts.default())
    return {"pooled": pooled, "z_sig": z_sig, "z_freq": z_freq,
            "p_blend": co["p_blend"], "risk_probs": co["risk_probs"],
            "sizes": out["sizes"]}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# Tolerances. Where the tower is float, every output holds atol 2e-3. In
# the W8A8 tower, the two frameworks round the f32 layer-norm statistics
# differently in the last bit, so a value sitting on a rounding tie of the
# int8 quant takes the neighbouring code in one of them; one such code
# moves its row by about one int8 step through the next projection, and a
# moved token can change one ToMe merge partner. At base-256 width that
# moved pooled features by up to 3.4e-2 and z_sig by up to 9.3e-3 (measured
# over pixel seeds 4-6) while the pooled cosine stays above 0.999; test-64
# holds ~1e-6 at these seeds but showed such a flip (pooled 1.2e-2) with
# other parameters. The calibrated outputs (p_blend, risk_probs) and the
# frequency branch keep atol 2e-3.
_W8A8_ATOL = {"pooled": 5e-2, "z_sig": 2e-2, "z_freq": 2e-3,
              "p_blend": 2e-3, "risk_probs": 2e-3}


@pytest.mark.parametrize("cfg_name,tower", [("test-64", "w8a8"),
                                            ("base-256", "w8a8"),
                                            ("test-64", "float")])
def test_slice_matches_jax_f32(cfg_name, tower):
    jcfg, cfg, jfloat, jquant = _setup(cfg_name)
    jp = jquant if tower == "w8a8" else jfloat
    pixels = np.random.default_rng(4).random(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: _jax_slice(p, x, jcfg))(jp, pixels)

    params = params_from_numpy(jp, "cpu")
    got = detect_core(params, torch.from_numpy(pixels), cfg,
                      CoralCutpoints.default(), F32_POLICY)
    for key, atol in _W8A8_ATOL.items():
        atol = atol if tower == "w8a8" else 2e-3
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=0, err_msg=key)
    a, b = got["pooled"].numpy(), np.asarray(want["pooled"])
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b,
                                                                        axis=-1)
    assert cos.min() >= 0.999
    # ToMe really merged: 64 → 32 tokens (test-64), 256 → 160 (base-256)
    tower_out = siglip_forward(params["backbone"],
                               (torch.from_numpy(pixels) - 0.5) / 0.5, cfg,
                               F32_POLICY, tome_r=DEPLOYED_TOME_R,
                               tome_floor=j_floor(cfg.num_patches))
    assert tower_out["sizes"].shape == want["sizes"].shape
    np.testing.assert_allclose(tower_out["sizes"].sum(-1).numpy(),
                               cfg.num_patches)


def test_calibration_matches_jax_f32():
    from tpudf_torch.ops.quant import calibrate_siglip_act_scales
    jcfg, cfg, jfloat, _ = _setup("test-64")
    bb = jfloat["backbone"]
    px = np.random.default_rng(8).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda b, x: j_calibrate(b, jcfg, x, J_F32))(bb, px)
    got = calibrate_siglip_act_scales(params_from_numpy(bb, "cpu"),
                                      cfg, torch.from_numpy(px), F32_POLICY)
    for k in ("qkv", "out", "fc1", "fc2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


def test_bridge_round_trips_every_leaf():
    tree = _setup("test-64")[3]
    params = params_from_numpy(tree, "cpu")
    qkv = params["backbone"]["blocks"]["attn"]["qkv_w"]
    assert qkv["q"].dtype == torch.int8
    assert torch.equal(qkv["qT"], qkv["q"].transpose(-1, -2))
    back = params_to_numpy(params)
    flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        out = flat_out[path]
        assert out.dtype == leaf.dtype and out.shape == leaf.shape, path
        np.testing.assert_array_equal(out, leaf)


@pytest.mark.parametrize("cfg_name", ["test-64", "base-256"])
def test_init_layout_matches_jax(cfg_name):
    """The port's seeded init has JAX's tree: same paths, shapes, dtypes."""
    jcfg = dataclasses.replace(J_CONFIGS[cfg_name], layers=2)
    cfg = dataclasses.replace(CONFIGS[cfg_name], layers=2)
    key = jax.random.key(0)
    want = jax.eval_shape(lambda k: {
        "backbone": j_init_siglip(k, jcfg),
        "head": j_init_head(k, jcfg.width), "freq": j_init_freq(k),
        "fusion": j_init_fusion(k)}, key)
    got = params_to_numpy(init_params(torch.Generator().manual_seed(0), cfg))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        assert (flat_got[path].shape, flat_got[path].dtype) == \
            (leaf.shape, leaf.dtype), path


def test_build_detect_core_on_cpu():
    """build() at test-64: DetectCore.forward is detect_core, outputs are
    well formed, and no kernel launches on the CPU."""
    model = build("cpu", seed=0, cfg_name="test-64", calib_images=2)
    assert isinstance(model, DetectCore)
    px = torch.rand((3, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    LAUNCHES.reset()
    out = model(px.to(torch.bfloat16))
    assert LAUNCHES.snapshot() == {}
    assert tuple(out) == ENTRY_KEYS
    assert out["risk_probs"].shape == (3, 5)
    assert all(torch.isfinite(v).all() for v in out.values())
    assert ((out["p_blend"] >= 0) & (out["p_blend"] <= 1)).all()
    torch.testing.assert_close(out["risk_probs"].sum(-1), torch.ones(3))
    again = detect_core(model.param_tree(), px.to(torch.bfloat16), model.cfg,
                        model.cuts)
    for k in ENTRY_KEYS:
        torch.testing.assert_close(out[k], again[k], atol=0, rtol=0)
