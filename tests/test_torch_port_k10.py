"""K10 over JAX's whole Pallas domain and the trainer at the shapes that
need it, against the JAX package on the CPU.

Inputs and parameters are seeded numpy handed to both packages. Tolerances:
  K10 twin vs `_attention_qkv_bwd_pallas(interpret=True)`, bf16, at S = 576
       (d 64 and d 128, W = 128) and at ragged S = 200: atol 1e-2 + rtol
       2^-7 (f32 sums in another order before one bf16 rounding, as at S =
       32 in tests/test_torch_port_train.py)
  the route  `attention_qkv_bwd_fits` equals JAX's decision (does its
       custom VJP call `_attention_qkv_bwd_pallas`?) at every config's
       training shape, read with `pl.pallas_call` stubbed under
       jax.eval_shape; the twin-VJP route equals autograd through the
       forward's twin exactly
  MTL at 576 tokens  3 steps of `make_mtl_train_step` (W 128, 2 heads of
       64, 2 layers, 192 px in patches of 8, F32) against JAX's: the
       limits of tests/test_torch_port_train.py (metrics 1e-4, step-1
       gradients atol 1e-5 + rtol 1e-3, parameters 0.02 lr)
  R2 at W = 144 (heads of 72, MLP 200)  the same 3 steps and limits, with
       every f32 master and optimizer moment of JAX's shape; so400m-512's
       training compute copy (one layer at full width) passes K14's and
       K13's preconditions with its hidden padded to 4352
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tests.test_torch_port_large import _no_kernel
from tests.test_torch_port_train import (_assert_params_close, _compile,
                                         _get, _paths, _stash_grads)
from tests.test_torch_port_variants import persist_every_compile  # noqa: F401
from tests.test_torch_port_weights import _checked
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models import segformer as J_seg
from tpudf.models.siglip import SigLIPConfig as JSigLIPConfig
from tpudf.ops import attention as J_attn
from tpudf.train.mtl import make_mtl_train_step as j_make_step
from tpudf.train.steps import make_optimizer as j_make_optimizer
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.precision import DEFAULT_POLICY, F32_POLICY
from tpudf_torch.models import segformer as T_seg
from tpudf_torch.models import siglip as P_siglip
from tpudf_torch.models.siglip import CONFIGS, SigLIPConfig
from tpudf_torch.ops import attention
from tpudf_torch.train.mtl import (make_freeze_mask, make_mtl_train_step,
                                   trainable_leaves)
from tpudf_torch.train.steps import make_optimizer

BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
LR, STEPS = 1e-3, 3


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


# ---------------------------------------------------------------- K10

@pytest.mark.parametrize("s,heads,hd", [(576, 2, 64), (576, 1, 128),
                                        (200, 2, 64)])
def test_k10_twin_matches_pallas_interpret_long(s, heads, hd):
    rng = np.random.default_rng(s + hd)
    w = heads * hd
    qkv = (rng.standard_normal((1, s, 3 * w)) * 1.5).astype(np.float32)
    g = rng.standard_normal((1, s, w)).astype(np.float32)
    want = _attention_qkv_bwd_pallas_bf16(qkv, g, heads, hd)
    assert attention.attention_qkv_bwd_fits(s, w, hd)
    got = attention.attention_qkv_bwd(torch.from_numpy(qkv).bfloat16(),
                                      torch.from_numpy(g).bfloat16(),
                                      heads, hd)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16_STEP)


def _attention_qkv_bwd_pallas_bf16(qkv, g, heads, hd):
    out = J_attn._attention_qkv_bwd_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), heads,
        hd, hd ** -0.5, interpret=True)
    return np.asarray(out, np.float32)


# every config's training shape: (name, S, JAX's W and head_dim, the
# port's W and head_dim after its pad of heads that are not lane-aligned)
_TRAIN_SHAPES = [
    ("base-256", 256, (768, 64), (768, 64)),
    ("base-384", 576, (768, 64), (768, 64)),
    ("large-384 at 256 px", 256, (1024, 64), (1024, 64)),
    ("large-384 at 384 px", 576, (1024, 64), (1024, 64)),
    ("large-384 at 512 px", 1024, (1024, 64), (1024, 64)),
    ("so400m-512", 1024, (1152, 72), (2048, 128)),
    ("test-32", 4, (64, 32), (64, 32)),
    ("test-64", 64, (64, 32), (64, 32)),
    ("W 128 at 576 tokens", 576, (128, 64), (128, 64)),
    ("W 144 heads of 72", 16, (144, 72), (256, 128)),
    ("ragged S 200", 200, (128, 64), (128, 64)),
    ("S 60", 60, (128, 64), (128, 64)),
    ("S 1560 at W 128", 1560, (128, 128), (128, 128)),
    ("S 1568 at W 128", 1568, (128, 128), (128, 128)),
]


def _jax_calls_pallas_bwd(monkeypatch, s, w, hd):
    """Whether the VJP of JAX's `attention_qkv` at qkv (1, s, 3w) calls
    `_attention_qkv_bwd_pallas` (traced under jax.eval_shape, the Pallas
    calls stubbed)."""
    called = []
    orig = J_attn._attention_qkv_bwd_pallas
    monkeypatch.setattr(J_attn.pl, "pallas_call", _no_kernel)
    monkeypatch.setattr(J_attn, "_attention_qkv_bwd_pallas",
                        lambda *a, **k: called.append(1) or orig(*a, **k))
    heads = w // hd
    sds = jax.ShapeDtypeStruct
    jax.eval_shape(lambda q, g: jax.vjp(lambda t: J_attn.attention_qkv(
        t, heads, hd, interpret=True), q)[1](g),
        sds((1, s, 3 * w), jnp.bfloat16), sds((1, s, w), jnp.bfloat16))
    monkeypatch.setattr(J_attn, "_attention_qkv_bwd_pallas", orig)
    return bool(called)


@pytest.mark.parametrize("name,s,jax_geo,port_geo", _TRAIN_SHAPES,
                         ids=[t[0] for t in _TRAIN_SHAPES])
def test_k10_route_matches_jax(name, s, jax_geo, port_geo, monkeypatch):
    """The port's decision, taken as `_float_block` asks for it (at the
    padded width and head_dim, with JAX's own head_dim where it padded),
    equals JAX's, and TPUDF_PALLAS_ATTN_BWD=0 turns the kernel off."""
    want = _jax_calls_pallas_bwd(monkeypatch, s, *jax_geo)
    w_run, d_run = port_geo
    heads = jax_geo[0] // jax_geo[1]
    assert w_run == heads * d_run
    assert _port_takes_k10(s, heads, d_run, jax_geo[1]) == want
    monkeypatch.setenv("TPUDF_PALLAS_ATTN_BWD", "0")
    assert not _port_takes_k10(s, heads, d_run, jax_geo[1])
    if name == "large-384 at 384 px":     # the path this route opens
        assert want


def _port_takes_k10(s, heads, d_run, d_jax):
    """Whether `attention_qkv_bwd` takes K10's route (on the CPU its twin)
    for qkv (1, s, 3 heads d_run): spied on K10's twin."""
    called = []
    orig = attention.attention_qkv_bwd_reference
    attention.attention_qkv_bwd_reference = \
        lambda *a, **k: called.append(1) or orig(*a, **k)
    try:
        w = heads * d_run
        attention.attention_qkv_bwd(
            torch.zeros((1, s, 3 * w)), torch.zeros((1, s, w)), heads, d_run,
            jax_head_dim=None if d_jax == d_run else d_jax)
    finally:
        attention.attention_qkv_bwd_reference = orig
    return bool(called)


def test_twin_vjp_route_is_autograd_of_the_twin():
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 3 * 144)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 16, 144)).astype(
        np.float32))
    assert not attention.attention_qkv_bwd_fits(16, 144, 72)
    got = attention.attention_qkv_bwd(qkv, g, 2, 72)
    assert torch.equal(got, attention.attention_qkv_bwd_twin_vjp(qkv, g, 2,
                                                                 72))
    x = qkv.clone().requires_grad_(True)
    attention.attention_qkv_reference(x, 2, 72).backward(g)
    assert torch.equal(got, x.grad)


# ---------------------------------------------------------------- MTL steps

def _geometry(name):
    """(JAX MTLConfig, port MTLConfig, image size) of a test geometry."""
    w, heads, mlp, size, patch = {"576 tokens": (128, 2, 256, 192, 8),
                                  "W 144": (144, 2, 200, 32, 8)}[name]
    kw = dict(width=w, layers=2, heads=heads, mlp_dim=mlp, image_size=size,
              patch_size=patch)
    return (J_seg.MTLConfig(backbone=JSigLIPConfig(**kw), seg_layers=(0, -1),
                            embed_dim=16),
            T_seg.MTLConfig(backbone=SigLIPConfig(**kw), seg_layers=(0, -1),
                            embed_dim=16), size)


def _batch(size, seed=9, b=2):
    rng = np.random.default_rng(seed)
    return {"pixels": rng.uniform(-1, 1, (b, size, size, 3)).astype(
                np.float32),
            "cls": rng.integers(0, 3, b).astype(np.int32),
            "mask": (rng.random((b, size, size)) > 0.6).astype(np.float32),
            "has_mask": np.array([1, 1], np.float32)[:b]}


def _jax_run(jcfg, tree, batch):
    opt = optax.chain(_stash_grads(), j_make_optimizer(
        LR, warmup_steps=1, total_steps=10))
    init_fn, step = j_make_step(jcfg, opt, J_F32, freeze_below=1,
                                seg_loss="bce_dice")
    state = jax.jit(init_fn)(tree)
    step = _compile(step, state, batch, jax.random.key(0), 1.0, 0.75)
    metrics, grads = [], None
    for i in range(STEPS):
        state, m = step(state, batch, jax.random.key(i), 1.0, 0.75)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = jax.tree.map(np.asarray, state.opt_state[0])
    return (metrics, grads, jax.tree.map(np.asarray, state.params),
            state.opt_state)


def _port_run(cfg, tree, batch):
    params = params_from_numpy(tree, "cpu")
    init_fn, step = make_mtl_train_step(
        cfg, make_optimizer(LR, warmup_steps=1, total_steps=10), F32_POLICY,
        freeze_below=1, seg_loss="bce_dice")
    state = init_fn(params)
    tb = {k: torch.from_numpy(v).long() if k == "cls"
          else torch.from_numpy(v) for k, v in batch.items()}
    metrics, grads = [], None
    for i in range(STEPS):
        state, m = step(state, tb, None, 1.0, 0.75)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {id(leaf): _np(leaf.grad) for leaf, _ in
                     trainable_leaves(state.params,
                                      *make_freeze_mask(state.params, cfg,
                                                        1))}
    return metrics, grads, state


@pytest.mark.parametrize("name", ["576 tokens", "W 144"])
def test_mtl_steps_match_jax(name):
    """3 MTL steps against JAX: at 576 tokens the port's CPU route is K10's
    twin (JAX's fit holds); at W = 144 the twin's VJP, the heads padded to
    128 and the MLP hidden padded 200 → 256 in the compute copy (R2),
    while the f32 masters and AdamW's moments keep JAX's shapes."""
    jcfg, cfg, size = _geometry(name)
    d, s = cfg.backbone.head_dim, cfg.backbone.num_patches
    assert attention.attention_qkv_bwd_fits(s, cfg.backbone.width, d) == (
        name == "576 tokens")
    tree = numpy_params(lambda: J_seg.init_mtl(jax.random.key(0), jcfg), 8)
    batch = _batch(size)
    j_metrics, j_grads, j_params, j_opt = _jax_run(jcfg, tree, batch)
    t_metrics, t_grads, state = _port_run(cfg, tree, batch)
    for jm, tm in zip(j_metrics, t_metrics):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=1e-4, err_msg=k)
    leaves = trainable_leaves(state.params, *make_freeze_mask(
        state.params, cfg, 1))
    trainable = {id(leaf): r for leaf, r in leaves}
    for path, leaf in _paths(state.params):
        init = np.asarray(_get(tree, path))
        final = _np(leaf)
        assert final.shape == init.shape, path
        if id(leaf) not in trainable:
            np.testing.assert_array_equal(final, init, err_msg=str(path))
            continue
        r = trainable[id(leaf)]
        np.testing.assert_array_equal(final[:r], init[:r], err_msg=str(path))
        g1 = np.asarray(_get(j_grads, path))
        _assert_params_close(final, np.asarray(_get(j_params, path)), g1,
                             0.02, str(path))
        np.testing.assert_allclose(t_grads[id(leaf)][r:], g1[r:], atol=1e-5,
                                   rtol=1e-3, err_msg=str(path))
    if name == "W 144":
        # AdamW's moments: one per trainable leaf, each of the master's
        # trainable rows' shape
        for (leaf, r), mu in zip(leaves, state.opt_state["mu"]):
            assert mu.shape == leaf[r:].shape
        assert state.params["backbone"]["blocks"]["mlp"]["fc1_w"].shape == \
            (2, 144, 200)


def test_so400m_training_copy_meets_the_card_preconditions():
    """One so400m-512 layer at full width as the trainer holds it (f32
    masters, autograd on): its compute copy reaches K13 and K14 with the
    MLP hidden padded to 4352 and the heads to 128, the backward is routed
    to the twin's VJP (JAX's fit fails: 32 MiB against 12), and the
    gradient reaches the unpadded masters."""
    cfg = dataclasses.replace(CONFIGS["so400m-512"], layers=1, image_size=64,
                              with_head=False)
    p = P_siglip.init_siglip(torch.Generator().manual_seed(0), cfg)
    fc1 = p["blocks"]["mlp"]["fc1_w"].requires_grad_(True)
    px = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(
        1)) * 2 - 1
    seen = set()
    out = P_siglip.siglip_forward(p, px, cfg, DEFAULT_POLICY,
                                  kernels=_checked(seen))
    out["tokens"].float().sum().backward()
    assert seen == {"K13", "K9", "K14"}
    assert not attention.attention_qkv_bwd_fits(1024, 1152, 72)
    assert not attention.attention_qkv_bwd_fits(1024, 16 * 128, 128)
    assert fc1.grad.shape == (1, 1152, 4304)
    assert torch.isfinite(fc1.grad).all()
