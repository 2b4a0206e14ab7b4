"""Parity of the port's weights-in path and plain attention with the JAX
package, on the CPU. Inputs are made with numpy from a seed and handed to
both packages; the port runs its twins, JAX its Pallas kernels in
interpret mode where it has one. Tolerances:
  11, 12  `attention` / `attention_bshd` vs `_attention_pallas` /
      `_attention_pallas_bshd(interpret=True)`, q k v of std 1.5, at (B, H,
      Sq, Skv, D) = (1, 2, 100, 100, 64) (ragged keys), (1, 2, 3, 100, 64)
      (Sq != Skv) and (1, 2, 64, 64, 72): f32 atol 5e-4 + rtol 1e-3 (JAX's
      own bound), bf16 atol 1e-2 + rtol 2^-7 (f32 sums in another order
      before one bf16 rounding); gradients vs `jax.vjp` of JAX's reference,
      f32, 1e-5
  _mha  Sq = 1 and Sq = 5, with and without a logit bias, vs JAX's `_mha`
      at W = 64, 2 heads, f32: 2e-3
  interpolation  `_bicubic_matrix` and `interpolate_pos` vs JAX's: rtol
      1e-6; vs F.interpolate(mode="bicubic", align_corners=False), HF's
      semantics: atol 1e-6 + rtol 1e-5 (its own f32 sums); the tower (f32)
      at 48 px on test-32's 2 x 2 table: 2e-3; calibration there: rtol 1e-5
  conversion  `from_hf_state_dict`, `from_open_clip_state_dict` (with and
      without the attention-pool head) and `from_reference_mtl_state_dict`
      vs JAX's on the same dicts: every leaf bit-equal; `_detect_kind` and
      `_infer_config` equal; the port's tower on a converted random-init
      `transformers.SiglipVisionModel` (test-32 at 32 and 48 px, test-64)
      vs its `pooler_output` and `last_hidden_state`: 2e-3; the MTL bundle
      vs the reference torch assembly: cls 5e-5, seg 5e-4 (JAX's own); the
      convert CLI from `.safetensors` and `.pt` round-trips bit for bit;
      `train_mtl --backbone_ckpt` trains a step from a converted file
  repairs  at W = 144, 2 heads of 72, MLP 200 (heads and hidden not
      lane-aligned): (R1) the bf16 tower's `tower_params` tree (f32 policy)
      vs JAX's float tower: 2e-3; (R2) the dynamic-int8 tree pre-padded
      once (`quantize_siglip(params, cfg)`) vs JAX's unpadded dynamic
      tower, bf16: 0.0625 (PR 4's dynamic tolerance); (R3) a static tree
      quantised without cfg vs JAX's, bf16: tokens 0.125, pooled 0.075 (PR
      4's); unpadded trees padded in the graph give the pre-padded tree's
      output bit for bit; and at so400m-512's full width (one layer), every
      shape the float, dynamic and static trees hand to the bf16 GEMM (K13,
      K14), the int8 GEMM, K1, K2 and K9 passes the precondition those
      wrappers check on the card (the same functions)
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_convert_openclip import _make_state_dicts
from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tests.test_torch_port_train import sid_dataset  # noqa: F401
from tests.test_torch_port_variants import _np, _t, persist_every_compile  # noqa: F401
from tpudf.core.precision import DEFAULT_POLICY as J_POLICY
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models import convert as J_convert
from tpudf.models import siglip as J_siglip
from tpudf.models.segformer import MTLConfig as JMTLConfig
from tpudf.ops import attention as J_attn
from tpudf.ops import quant as J_quant
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.models import convert as P_convert
from tpudf_torch.models import siglip as P_siglip
from tpudf_torch.models.segformer import MTLConfig, mtl_forward
from tpudf_torch.ops import attention, int8_block, linear, mlp, quant
from tpudf_torch.ops.routes import TWINS

transformers = pytest.importorskip("transformers")

# width, layers, heads, MLP, image, patch: heads of 72, hidden 200
MISALIGNED = (144, 2, 2, 200, 32, 16)


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


def _bf16(a):
    """a rounded to bf16, as the f32 values both sides read."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _leaves(tree, prefix=()):
    """{path: numpy array} of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, prefix + (i,)))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


def _bit_equal(port_tree, jax_tree):
    got, want = _leaves(port_tree), _leaves(jax_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert np.array_equal(got[k], want[k]), k


def _same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


# ------------------------------------------------------ kernels 11 and 12

_PLAIN = [(1, 2, 100, 100, 64), (1, 2, 3, 100, 64), (1, 2, 64, 64, 72)]


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _PLAIN)
def test_plain_attention_twins_match_pallas_interpret(shape, dtype, bshd):
    b, h, sq, skv, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(0, 1.5, (b, h, n, d)).astype(np.float32)
               for n in (sq, skv, skv))
    if bshd:
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    jfn = (J_attn._attention_pallas_bshd if bshd else
           J_attn._attention_pallas)
    want = jfn(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
               d ** -0.5, interpret=True)
    fn = attention.attention_bshd if bshd else attention.attention
    got = fn(*(_t(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    atol, rtol = (5e-4, 1e-3) if dtype == "float32" else (1e-2, 2 ** -7)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("bshd", [False, True])
def test_plain_attention_gradient_matches_jax(bshd):
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(0, 1.0, (1, 2, n, 72)).astype(np.float32)
                  for n in (7, 11, 11, 7))
    if bshd:
        q, k, v, g = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v, g))
    jref = J_attn._reference_bshd if bshd else J_attn.attention_reference
    _, vjp = jax.vjp(lambda a, b_, c: jref(a, b_, c, 72 ** -0.5),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    fn = attention.attention_bshd if bshd else attention.attention
    got = torch.autograd.grad(fn(*ts), ts, _t(g))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b_), atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------------------------ _mha

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("sq", [1, 5])
def test_mha_matches_jax(sq, bias):
    rng = np.random.default_rng(sq + 2 * bias)
    w, heads = 64, 2
    f = lambda *s, std=1.0: rng.normal(0, std, s).astype(np.float32)
    args = [f(2, sq, w), f(2, 9, w), heads, f(w, 3 * w, std=w ** -0.5),
            f(3 * w, std=0.1), f(w, w, std=w ** -0.5), f(w, std=0.1)]
    lb = np.log(rng.integers(1, 5, (2, 9))).astype(np.float32) if bias \
        else None
    want = J_siglip._mha(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args], policy=J_F32,
                         logit_bias=None if lb is None else jnp.asarray(lb))
    got = P_siglip._mha(*[_t(a) if isinstance(a, np.ndarray) else a
                          for a in args],
                        logit_bias=None if lb is None else _t(lb))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=0)


# --------------------------------------------------------- interpolation

@pytest.mark.parametrize("src,dst", [(2, (3, 3)), (4, (2, 2)),
                                     (24, (16, 16)), (16, (12, 20))])
def test_interpolate_pos_matches_jax_and_torch(src, dst):
    for n in dst:
        m = P_siglip._bicubic_matrix(src, n)
        assert m.dtype == np.float64
        np.testing.assert_allclose(m.astype(np.float32),
                                   np.asarray(J_siglip._bicubic_matrix(src,
                                                                       n)),
                                   rtol=1e-6)
    pos = np.random.default_rng(src).normal(0, 0.02, (src * src, 8)).astype(
        np.float32)
    got = _np(P_siglip.interpolate_pos(_t(pos), src, dst))
    want = np.asarray(J_siglip.interpolate_pos(jnp.asarray(pos), src, dst))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    grid = _t(pos).reshape(1, src, src, 8).permute(0, 3, 1, 2)
    hf = F.interpolate(grid, size=dst, mode="bicubic", align_corners=False)
    np.testing.assert_allclose(
        got, _np(hf.permute(0, 2, 3, 1).reshape(-1, 8)), atol=1e-6,
        rtol=1e-5)


def test_tower_and_calibration_at_another_size_match_jax():
    """test-32 (a 2 x 2 position table) on 48 px images (3 x 3 patches)."""
    jcfg = J_siglip.CONFIGS["test-32"]
    cfg = P_siglip.CONFIGS["test-32"]
    params = numpy_params(lambda: J_siglip.init_siglip(jax.random.key(0),
                                                       jcfg), 3)
    px = np.random.default_rng(4).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: J_siglip.siglip_forward(
        p, x, jcfg, J_F32)["pooled"])(params, px)
    tp = params_from_numpy(params, "cpu")
    got = P_siglip.siglip_forward(tp, _t(px), cfg, F32_POLICY)["pooled"]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=0)
    want = jax.jit(lambda p, x: J_quant.calibrate_siglip_act_scales(
        p, jcfg, x, J_F32))(params, px)
    got = quant.calibrate_siglip_act_scales(tp, cfg, _t(px), F32_POLICY)
    for k in ("qkv", "out", "fc1", "fc2"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ conversion

def _hf_model(geometry):
    image, patch = {"test-32": (32, 16), "test-64": (64, 8)}[geometry]
    hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=image, patch_size=patch)
    torch.manual_seed(0)
    return transformers.SiglipVisionModel(hf_cfg).eval(), hf_cfg


@pytest.mark.parametrize("geometry,size", [("test-32", 32), ("test-32", 48),
                                           ("test-64", 64)])
def test_hf_conversion_matches_jax_and_transformers(geometry, size):
    model, hf_cfg = _hf_model(geometry)
    sd = model.state_dict()
    cfg = P_convert.config_from_hf(hf_cfg)
    _same_config(cfg, J_convert.config_from_hf(hf_cfg))
    params = P_convert.from_hf_state_dict(sd, cfg)
    _bit_equal(params, J_convert.from_hf_state_dict(sd, J_convert.config_from_hf(
        hf_cfg)))
    assert P_convert._detect_kind(sd) == J_convert._detect_kind(sd) == "hf"
    _same_config(P_convert._infer_config(sd), J_convert._infer_config(sd))
    px = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(pixel_values=_t(px.transpose(0, 3, 1, 2).copy()),
                    interpolate_pos_encoding=size != hf_cfg.image_size)
        got = P_siglip.siglip_forward(params, _t(px), cfg, F32_POLICY)
    np.testing.assert_allclose(_np(got["pooled"]), _np(ref.pooler_output),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(_np(got["tokens"]),
                               _np(ref.last_hidden_state), atol=2e-3, rtol=0)


def _with_attn_pool(oc, w, inter, seed=1):
    """An open_clip dict with timm's AttentionPoolLatent head."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {**oc, "trunk.attn_pool.latent": f(1, 1, w),
            "trunk.attn_pool.q.weight": f(w, w),
            "trunk.attn_pool.q.bias": f(w),
            "trunk.attn_pool.kv.weight": f(2 * w, w),
            "trunk.attn_pool.kv.bias": f(2 * w),
            "trunk.attn_pool.proj.weight": f(w, w),
            "trunk.attn_pool.proj.bias": f(w),
            "trunk.attn_pool.norm.weight": f(w),
            "trunk.attn_pool.norm.bias": f(w),
            "trunk.attn_pool.mlp.fc1.weight": f(inter, w),
            "trunk.attn_pool.mlp.fc1.bias": f(inter),
            "trunk.attn_pool.mlp.fc2.weight": f(w, inter),
            "trunk.attn_pool.mlp.fc2.bias": f(w)}


@pytest.mark.parametrize("head", [False, True])
def test_open_clip_conversion_matches_jax(head):
    hf, oc = _make_state_dicts()
    jcfg = J_convert._infer_config(oc)
    cfg = P_convert._infer_config(oc)
    _same_config(cfg, jcfg)
    if head:
        oc = _with_attn_pool(oc, cfg.width, cfg.mlp_dim)
    else:
        cfg = dataclasses.replace(cfg, with_head=False)
        jcfg = dataclasses.replace(jcfg, with_head=False)
    assert P_convert._detect_kind(oc) == J_convert._detect_kind(oc) \
        == "open_clip"
    params = P_convert.from_open_clip_state_dict(oc, cfg)
    _bit_equal(params, J_convert.from_open_clip_state_dict(oc, jcfg))
    assert ("head" in params) == head


def _torch_mtl():
    from tests.test_mtl_convert import TorchMTL
    hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=32, patch_size=16)
    torch.manual_seed(0)
    return TorchMTL(hf_cfg).eval(), hf_cfg


def test_mtl_conversion_matches_jax_and_reference():
    m, hf_cfg = _torch_mtl()
    sd = m.state_dict()
    assert P_convert._detect_kind(sd) == J_convert._detect_kind(sd) == "mtl"
    enc = {k.split("encoder.", 1)[1]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    _same_config(P_convert._infer_config(enc), J_convert._infer_config(enc))
    cfg = MTLConfig(backbone=P_convert.config_from_hf(hf_cfg),
                    seg_layers=(0, -1), embed_dim=16)
    jcfg = JMTLConfig(backbone=J_convert.config_from_hf(hf_cfg),
                      seg_layers=(0, -1), embed_dim=16)
    params = P_convert.from_reference_mtl_state_dict(sd, cfg)
    _bit_equal(params, J_convert.from_reference_mtl_state_dict(sd, jcfg))
    px = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        cls_ref, seg_ref = m(_t(px.transpose(0, 3, 1, 2).copy()))
        cls_got, seg_got = mtl_forward(params, _t(px), cfg, F32_POLICY)
    np.testing.assert_allclose(_np(cls_got), _np(cls_ref), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(_np(seg_got), _np(seg_ref), atol=5e-4,
                               rtol=5e-4)


def _write(sd, path):
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file
        save_file({k: _np(v) for k, v in sd.items()}, path)
    else:
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)


@pytest.mark.parametrize("src", ["hf.safetensors", "hf.pt", "open_clip.pt",
                                 "mtl.pt"])
def test_convert_cli_round_trip(src, tmp_path, capsys):
    from tpudf_torch.train.checkpoint import restore_checkpoint
    kind = src.split(".")[0]
    argv = []
    if kind == "hf":
        sd = _hf_model("test-32")[0].state_dict()
        cfg = P_convert._infer_config(sd)
        want = P_convert.from_hf_state_dict(sd, cfg)
    elif kind == "open_clip":
        sd = _make_state_dicts()[1]
        cfg = P_convert._infer_config(sd)
        want = P_convert.from_open_clip_state_dict(sd, cfg)
    else:
        sd = _torch_mtl()[0].state_dict()
        enc = {k.split("encoder.", 1)[1]: v for k, v in sd.items()
               if k.startswith("encoder.")}
        cfg = P_convert._infer_config(enc)
        want = P_convert.from_reference_mtl_state_dict(
            sd, MTLConfig(backbone=cfg, seg_layers=(0, -1), embed_dim=16))
        argv = ["--seg_layers", "0,-1", "--embed_dim", "16"]
    path = str(tmp_path / src)
    _write(sd, path)
    out = str(tmp_path / "out")
    P_convert.main(["--src", path, "--out", out] + argv)
    n = sum(a.size for a in _leaves(want).values())
    assert capsys.readouterr().out.strip() == (
        f"[convert] kind={kind} params={n / 1e6:.1f}M -> {out}")
    side = json.load(open(os.path.join(out, "config.json")))
    want_side = {"kind": kind, "backbone": dataclasses.asdict(cfg)}
    if kind == "mtl":
        want_side.update(seg_layers=[0, -1], embed_dim=16)
    assert side == want_side
    got = restore_checkpoint(os.path.join(out, "params"))
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    assert all(np.array_equal(g[k], w[k]) for k in w)


def test_train_mtl_and_engine_from_backbone_ckpt(sid_dataset, tmp_path):  # noqa: F811
    """`train_mtl --backbone_ckpt` (one step at test-32) starts from the
    converted tower: its frozen embeddings are the file's; build_engine
    with backbone_ckpt serves from it."""
    from tpudf_torch.cli.train_mtl import main
    from tpudf_torch.entry import build_engine
    from tpudf_torch.train.checkpoint import restore_checkpoint
    sd = _hf_model("test-32")[0].state_dict()
    ckpt = str(tmp_path / "siglip.pt")
    _write(sd, ckpt)
    want = P_convert.from_hf_state_dict(sd, P_siglip.CONFIGS["test-32"])
    save = tmp_path / "run"
    main(["--data_dir", sid_dataset, "--save_dir", str(save),
          "--model_size", "test-32", "--image_size", "32",
          "--backbone_ckpt", ckpt, "--seg_layers", "0", "-1",
          "--embed_dim", "16", "--freeze_below", "1", "--epochs", "1",
          "--batch_size", "8", "--seg_loss", "bce_dice", "--device", "cpu"])
    state = restore_checkpoint(str(save / "best"))
    assert state["step"] == 1
    for k, v in want["embed"].items():
        assert torch.equal(state["params"]["backbone"]["embed"][k], v), k
    eng = build_engine("cpu", cfg_name="test-32", backbone_ckpt=ckpt)
    assert torch.equal(eng.backbone["blocks"]["attn"]["qkv_w"],
                       want["blocks"]["attn"]["qkv_w"])
    out = eng.predict_batch(np.zeros((2, 32, 32, 3), np.uint8))
    assert np.isfinite(out["p_blend"]).all()


# --------------------------------------------------------------- repairs

def _misaligned():
    jcfg = J_siglip.SigLIPConfig(*MISALIGNED)
    cfg = P_siglip.SigLIPConfig(*MISALIGNED)
    params = numpy_params(lambda: J_siglip.init_siglip(jax.random.key(0),
                                                       jcfg), 6)
    px = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    return jcfg, cfg, params, px


def test_r1_float_tower_params_match_jax():
    jcfg, cfg, params, px = _misaligned()
    want = jax.jit(lambda p, x: J_siglip.siglip_forward(p, x, jcfg, J_F32))(
        params, px)
    tp = P_siglip.tower_params(params_from_numpy(params, "cpu"),
                               torch.float32)
    assert tp["blocks"]["mlp"]["fc1_w"].shape[-1] == 256
    assert tp["blocks"]["mlp"]["fc2_w"].shape[-2] == 256
    got = P_siglip.siglip_forward(tp, _t(px), cfg, F32_POLICY)
    for k in ("tokens", "pooled"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=2e-3, rtol=0, err_msg=k)


def _bf16_forward(jtree, jcfg, ttrees, cfg, px):
    want = jax.jit(lambda p, x: J_siglip.siglip_forward(p, x, jcfg,
                                                        J_POLICY))(jtree, px)
    with torch.no_grad():
        got = [P_siglip.siglip_forward(
            P_siglip.tower_params(t, torch.bfloat16), _t(px), cfg)
            for t in ttrees]
    return want, got


def test_r2_dynamic_tree_matches_jax():
    jcfg, cfg, params, px = _misaligned()
    jq = J_quant.quantize_siglip(params)
    tp = params_from_numpy(params, "cpu")
    padded = quant.quantize_siglip(tp, cfg)
    assert padded["blocks"]["attn"]["qkv_w"]["q"].shape[-1] == 3 * 2 * 128
    assert padded["blocks"]["mlp"]["fc1_w"]["q"].shape[-1] == 256
    want, (got, unpadded) = _bf16_forward(jq, jcfg, [
        padded, quant.quantize_siglip(tp)], cfg, px)
    for k in ("tokens", "pooled"):
        assert torch.equal(got[k], unpadded[k]), k
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k], np.float32),
                                   atol=0.0625, rtol=0, err_msg=k)


def test_r3_static_tree_without_cfg_matches_jax():
    jcfg, cfg, params, px = _misaligned()
    scales = jax.jit(lambda p, x: J_quant.calibrate_siglip_act_scales(
        p, jcfg, x))(params, px)
    jq = J_quant.quantize_siglip_static(params, scales)
    tp = params_from_numpy(params, "cpu")
    ts = {k: _t(np.asarray(v)) for k, v in scales.items()}
    want, (got, prepadded) = _bf16_forward(jq, jcfg, [
        quant.quantize_siglip_static(tp, ts),
        quant.quantize_siglip_static(tp, ts, cfg)], cfg, px)
    for k, atol in (("tokens", 0.125), ("pooled", 0.075)):
        assert torch.equal(got[k], prepadded[k]), k
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k], np.float32),
                                   atol=atol, rtol=0, err_msg=k)


def _checked(seen):
    """TWINS whose K13, K14, K9, K1, K2 and int8-GEMM entries first run
    the precondition the CUDA wrapper checks, on the same arguments."""
    def spy(name, check, twin):
        def f(*a, **kw):
            check(*a, **kw)
            seen.add(name)
            return twin(*a, **kw)
        return f

    return dataclasses.replace(
        TWINS,
        linear_fused=spy("K13", lambda x, w, b, residual=None,
                         activation=None, **_: linear.check_linear_fused(
                             x, w, residual, activation),
                         TWINS.linear_fused),
        mlp_block_fused=spy("K14", lambda x, ln, p, *_:
                            mlp.check_mlp_block_fused(x, p),
                            TWINS.mlp_block_fused),
        attention_qkv=spy("K9", lambda qkv, heads, d, *_, **__:
                          attention.check_attention_shape("K9", qkv, heads,
                                                          d),
                          TWINS.attention_qkv),
        int8_acc=spy("int8 GEMM", quant.check_int8_acc, TWINS.int8_acc),
        attn_sublayer_int8=spy(
            "K1", lambda x, ln, wq, qb, ow, *a, **_:
            int8_block.check_attn_sublayer_int8(x, wq, ow, a[3], a[4]),
            TWINS.attn_sublayer_int8),
        mlp_block_fused_int8=spy(
            "K2", lambda x, ln, p, *_, **__:
            mlp.check_mlp_block_fused_int8(x, p), TWINS.mlp_block_fused_int8))


@pytest.mark.parametrize("tree,kernels", [
    ("float", {"K13", "K9", "K14"}),
    ("dynamic", {"int8 GEMM", "K9"}),
    ("dynamic without cfg", {"int8 GEMM", "K9"}),
    ("static without cfg", {"K1", "K2"})])
def test_so400m_trees_meet_the_card_preconditions(tree, kernels):
    """One so400m-512 layer at full width (heads of 72, MLP 4304) on a 64
    px image: every shape the tree hands to the kernels passes their
    wrappers' checks (on the parent the float MLP, the dynamic block's
    heads and hidden, and an un-prepadded static tree raised)."""
    cfg = dataclasses.replace(P_siglip.CONFIGS["so400m-512"], layers=1,
                              image_size=64)
    p = P_siglip.init_siglip(torch.Generator().manual_seed(0), cfg)
    px = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(
        1)) * 2 - 1
    if tree == "dynamic":
        p = quant.quantize_siglip(p, cfg)
    elif tree == "dynamic without cfg":
        p = quant.quantize_siglip(p)
    elif tree == "static without cfg":
        p = quant.quantize_siglip_static(
            p, quant.calibrate_siglip_act_scales(p, cfg, px))
    seen = set()
    with torch.no_grad():
        out = P_siglip.siglip_forward(
            P_siglip.tower_params(p, torch.bfloat16), px, cfg,
            kernels=_checked(seen))
    assert seen == kernels
    assert torch.isfinite(out["pooled"].float()).all()
