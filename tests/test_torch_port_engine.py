"""Parity of the port's serving engine with the JAX `DetectEngine`, on the
CPU, under F32_POLICY.

One numpy tree (backbone, head, frequency MLP, fusion or None, CORAL
cutpoints), made with numpy from a seed in the JAX init's tree, drives
both engines through `tpudf_torch.convert`. The float engine is
`tests/test_engine.py`'s configuration (test-32), with
fusion and with the MoE fallback: every output key of `predict_batch` and
`predict_batch_fast` within atol 2e-3 (`patch_probs`, `embed_feat` and
`risk_probs` included), `risk_idx` equal. The W8A8 engine is test-64
quantised as the JAX engine's `quantize()` does it (its calibration and
quantisation on its default noise batch, jitted), with the deployed ToMe
and patch-ToMe schedules; it holds the W8A8 slice's tolerances
(tests/test_torch_port_slice.py: rounding ties of the int8 quant) on the
pooled-feature outputs and 2e-3 on the calibrated ones. Every engine
variant costs one JAX jit per path, at B=2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.calib.coral import CoralCutpoints as JCuts
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.data.pipeline import normalize_siglip as j_normalize
from tpudf.models.freq_mlp import init_freq_mlp as j_init_freq
from tpudf.models.fusion import init_fusion_linear as j_init_fusion
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.ops.quant import calibrate_siglip_act_scales as j_calibrate
from tpudf.ops.quant import quantize_siglip_static as j_quantize
from tpudf.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                            deployed_floor, deployed_patch_floor)
from tpudf.serve.engine import DetectEngine as JEngine
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.serve.engine import (FAST_SCALARS, FULL_SCALARS,
                                      DetectEngine)

_ENGINES = {}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg_name(variant):
    return "test-64" if variant == "w8a8" else "test-32"


def _tree(variant):
    """The seeded numpy float tree of one variant."""
    jcfg = J_CONFIGS[_cfg_name(variant)]
    k = jax.random.key(0)
    return numpy_params(lambda: {
        "backbone": j_init_siglip(k, jcfg),
        "head": j_init_head(k, jcfg.width),
        "freq": j_init_freq(k),
        "fusion": None if variant == "moe" else j_init_fusion(k)}, 0)


def _engines(variant):
    """(JAX engine, port engine) of one variant, cached for the module."""
    if variant in _ENGINES:
        return _ENGINES[variant]
    cfg_name = _cfg_name(variant)
    jcfg = J_CONFIGS[cfg_name]
    tree = _tree(variant)
    sched = {}
    if variant == "w8a8":
        n = jcfg.num_patches
        sched = dict(tome_r=DEPLOYED_TOME_R, tome_floor=deployed_floor(n),
                     patch_tome_r=DEPLOYED_PATCH_TOME_R,
                     patch_tome_floor=deployed_patch_floor(n))
    jeng = JEngine(cfg=jcfg, cuts=JCuts.default(), policy=J_F32, **tree,
                   **sched)
    if variant == "w8a8":
        # DetectEngine.quantize() without images, jitted
        s = jcfg.image_size
        calib = j_normalize(jnp.asarray(
            np.random.default_rng(0).random((16, s, s, 3)), jnp.float32))
        jeng.backbone = jax.jit(lambda bb, px: j_quantize(
            bb, j_calibrate(bb, jcfg, px, J_F32), jcfg))(tree["backbone"],
                                                         calib)
        tree["backbone"] = jeng.backbone
    p = params_from_numpy({**_numpy(tree), "cuts": jeng.cuts}, "cpu")
    eng = DetectEngine(cfg=CONFIGS[cfg_name], policy=F32_POLICY, **p,
                       **sched)
    _ENGINES[variant] = (jeng, eng)
    return _ENGINES[variant]


# (pooled-feature outputs, calibrated outputs): see the module docstring
_ATOL = {"float": (2e-3, 2e-3), "moe": (2e-3, 2e-3), "w8a8": (5e-2, 2e-3)}
_FEATURE_KEYS = ("embed_feat", "z_sig")


@pytest.mark.parametrize("variant", ["float", "moe", "w8a8"])
@pytest.mark.parametrize("fast", [False, True])
def test_engine_matches_jax(variant, fast):
    jeng, eng = _engines(variant)
    s = eng.cfg.image_size
    px = np.random.default_rng(4).integers(0, 256, (2, s, s, 3), np.uint8)
    if fast:
        want, got = jeng.predict_batch_fast(px), eng.predict_batch_fast(px)
    else:
        want, got = jeng.predict_batch(px), eng.predict_batch(px)
    assert set(got) == set(want)
    scalars = FAST_SCALARS if fast else FULL_SCALARS
    assert set(scalars) <= set(got)
    feat_atol, atol = _ATOL[variant]
    for key in got:
        assert got[key].shape == want[key].shape, key
        if key == "risk_idx":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(
                got[key], want[key], rtol=0, err_msg=key,
                atol=feat_atol if key in _FEATURE_KEYS else atol)


def test_engine_quantize_calibrates_like_jax():
    """quantize() without images calibrates on the same noise batch as the
    JAX engine (np.random.default_rng(0)), so the scales agree with
    calibrate_siglip_act_scales on that batch."""
    jeng, _ = _engines("w8a8")
    p = params_from_numpy({"backbone": _tree("w8a8")["backbone"]}, "cpu")
    eng = DetectEngine(cfg=CONFIGS["test-64"], backbone=p["backbone"],
                       head=None, freq=None, fusion=None, cuts=None,
                       policy=F32_POLICY).quantize()
    got = eng.backbone["blocks"]["act_scales"]
    want = jeng.backbone["blocks"]["act_scales"]
    for k in ("qkv", "out", "fc1", "fc2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    qkv = eng.tower["blocks"]["attn"]["qkv_w"]       # kernel layout added
    assert (qkv["qT"] == qkv["q"].transpose(-1, -2)).all()


@pytest.mark.parametrize("variant", ["float", "w8a8"])
def test_pooled_features_are_the_detect_paths(variant):
    """pooled_features() gives the features the detect path uses: its full
    image view (main view 20), normalised, is predict_batch's embed_feat,
    with one tower forward (float) and with a patch schedule (w8a8)."""
    _, eng = _engines(variant)
    s, w = eng.cfg.image_size, eng.cfg.width
    px = np.random.default_rng(4).integers(0, 256, (2, s, s, 3), np.uint8)
    feats = eng.pooled_features(px)
    assert feats["main"].shape == (2, 21, w)
    assert feats["patch"].shape == (2, 32, w)
    embed = feats["main"][:, 20].float()
    embed = embed / (torch.linalg.vector_norm(embed, dim=-1, keepdim=True)
                     + 1e-6)
    np.testing.assert_allclose(embed.numpy(), eng.predict_batch(px)
                               ["embed_feat"], atol=1e-6, rtol=0)
    assert eng.pooled_features(px, fast=True)["views"].shape == (2, 2, w)


def test_engine_on_cpu_launches_no_kernel():
    _, eng = _engines("float")
    px = np.zeros((1, 32, 32, 3), np.uint8)
    LAUNCHES.reset()
    eng.predict_batch(px)
    assert LAUNCHES.snapshot() == {}
