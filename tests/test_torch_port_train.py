"""Parity of the port's multi-task training with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
parameters are seeded numpy in the JAX init's tree (`numpy_params`, no
eager JAX init). Tolerances:
  K10  twin vs `_attention_qkv_bwd_pallas(interpret=True)` at W=128, 2
       heads of 64, S=32, bf16: atol 1e-2 + rtol 2^-7 (f32 sums in another
       order before one bf16 rounding, as K9's twin); vs
       `jax.vjp(_reference_qkv)` at f32: 2e-3 (as tests/test_attention.py
       holds the TPU kernel); the autograd Function's gradient vs autograd
       through `attention_qkv_reference` at f32: 1e-5
  K13, K14, K4  gradients through their autograd Functions vs autograd
       through the twins at f32: 1e-5 (the same twin, recomputed)
  losses  every loss's value and gradient vs JAX at f32: 1e-5 (the
       morphology's tied windows included)
  decoder  `apply_segformer_decoder` vs JAX at embed_dim 16, a 4x4 grid
       up to 32: outputs and gradients 1e-4
  the slice  `make_mtl_train_step` at test-32, F32 policy, seg_layers
       (0, -1), embed_dim 16, freeze_below=1, B=4, the bce_dice seg loss
       (tests/test_cli_mtl.py's; the combined loss is held above), lr 1e-3
       with warmup_steps=1 (the first step's lr is 0), 3 steps against JAX's
       step: loss and metrics 1e-4 at each step; the trainable gradients at
       step 1 atol 1e-5 + rtol 1e-3; the parameters after 3 steps within
       0.02 lr, except where the step-1 gradient is below 1e-6 (zero in
       exact arithmetic, e.g. the key bias's: Adam turns its float noise
       into steps of up to lr either way), there within lr per step with a
       learning rate; frozen parameters exactly unchanged. With the int8
       frozen prefix: the loss 1e-3 and the parameters 0.1 lr (int8
       rounding ties move the prefix's taps)
The JAX side compiles two train steps (float and int8 prefix).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models import segformer as J_seg
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.ops.attention import _attention_qkv_bwd_pallas, _reference_qkv
from tpudf.train import losses as J_losses
from tpudf.train.mtl import make_mtl_train_step as j_make_step
from tpudf.train.mtl import quantize_frozen_prefix as j_quantize_prefix
from tpudf.train.steps import make_optimizer as j_make_optimizer
from tpudf_torch.convert import params_from_numpy, params_to_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.models import segformer as T_seg
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.ops import attention, layernorm, linear, mlp
from tpudf_torch.ops.routes import TWINS
from tpudf_torch.train import losses as T_losses
from tpudf_torch.train.mtl import (make_mtl_train_step, quantize_frozen_prefix,
                                   trainable_leaves, make_freeze_mask)
from tpudf_torch.train.steps import make_optimizer

W, HEADS, HD = 128, 2, 64
BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
LR, STEPS = 1e-3, 3
NOISE_GRAD = 1e-6


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf(t, grad=True):
    return torch.from_numpy(np.array(t)).requires_grad_(grad)


def _compile(fn, *args):
    """jax.jit(fn) compiled for args without LLVM's optimisation passes:
    these graphs run one to three times, so compile time dominates (the
    train step: 3.3 s at level 0, 4.4 s by default, the same loss)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


# ---------------------------------------------------------------- K10

def _k10_data(seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, 3 * W)).astype(np.float32),
            rng.standard_normal((b, s, W)).astype(np.float32))


def test_k10_twin_matches_pallas_interpret_bf16():
    qkv, g = _k10_data(0)
    want = _attention_qkv_bwd_pallas(jnp.asarray(qkv, jnp.bfloat16),
                                     jnp.asarray(g, jnp.bfloat16), HEADS, HD,
                                     HD ** -0.5, interpret=True)
    got = attention.attention_qkv_bwd(torch.from_numpy(qkv).bfloat16(),
                                      torch.from_numpy(g).bfloat16(),
                                      HEADS, HD)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_STEP)


def test_k10_twin_matches_jax_vjp_f32():
    qkv, g = _k10_data(1, s=40)
    want = jax.jit(lambda t, ct: jax.vjp(
        lambda u: _reference_qkv(u, HEADS, HD, HD ** -0.5), t)[1](ct)[0])(
            qkv, g)
    got = attention.attention_qkv_bwd_reference(
        torch.from_numpy(qkv), torch.from_numpy(g), HEADS, HD)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def test_attention_function_grad_matches_autograd_of_twin():
    qkv, g = _k10_data(2, s=24)
    grads = []
    for fn in (attention.attention_qkv_vjp,
               attention.attention_qkv_reference):
        x = _leaf(qkv)
        (fn(x, HEADS, HD) * torch.from_numpy(g)).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- K13, K14, K4 gradients

def _grad_case(name, rng):
    """(kernel call, twin call, inputs) of one kernel at f32."""
    f = lambda *s, std=1.0: _leaf((rng.standard_normal(s) * std)
                                  .astype(np.float32))
    x, g, b = f(20, W), 1 + f(W, std=0.1), f(W, std=0.1)
    if name == "K4":
        return (layernorm.layer_norm_fused, layernorm.layer_norm_reference,
                (x, g, b), {})
    if name == "K14":
        p = {"fc1_w": f(W, 2 * W, std=W ** -0.5), "fc1_b": f(2 * W, std=0.1),
             "fc2_w": f(2 * W, W, std=(2 * W) ** -0.5), "fc2_b": f(W, std=0.1)}
        return (lambda *a: mlp.mlp_block_fused(a[0], {"scale": a[1],
                                                      "bias": a[2]}, p),
                lambda *a: mlp.mlp_block_reference(a[0], {"scale": a[1],
                                                          "bias": a[2]}, p),
                (x, g, b, *p.values()), {})
    w, bias = f(W, 2 * W, std=W ** -0.5), f(2 * W, std=0.1)
    kw = {"K13-ln": dict(ln=(g, b)), "K13-gelu": dict(activation="gelu"),
          "K13-res": dict(residual=f(20, 2 * W))}[name]
    tensors = (x, w, bias, *kw.get("ln", ()), kw.get("residual"))
    return (lambda *a: linear.linear_fused(x, w, bias, **kw),
            lambda *a: linear.linear_fused_reference(x, w, bias, **kw),
            tuple(t for t in tensors if t is not None), {})


@pytest.mark.parametrize("name", ["K4", "K13-ln", "K13-gelu", "K13-res",
                                  "K14"])
def test_kernel_function_grad_matches_twin_autograd(name):
    fn, twin, inputs, _ = _grad_case(name, np.random.default_rng(3))
    grads = []
    for call in (fn, twin):
        out = call(*inputs)
        cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
            out.shape).astype(np.float32))
        grads.append([_np(t) for t in torch.autograd.grad(
            (out * cot).sum(), inputs)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- losses

_LOSSES = ["bce_with_logits", "focal_loss", "boundary_aware_loss",
           "morphological_loss", "iou_loss", "dice_loss", "bce_dice_loss",
           "combined_segmentation_loss", "softmax_ce", "dilate_erode",
           "dice_iou_from_logits"]


def _loss_inputs():
    rng = np.random.default_rng(5)
    # logits on a 0.5 grid: the morphology's windows hold ties
    logits = (np.round(rng.standard_normal((3, 16, 16)) * 2) / 2).astype(
        np.float32)
    targets = np.zeros((3, 16, 16), np.float32)
    targets[:, 4:11, 3:12] = 1.0
    targets[1] = (rng.random((16, 16)) > 0.6).astype(np.float32)
    cls_logits = rng.standard_normal((5, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 5)
    return logits, targets, cls_logits, labels


def _loss_fn(mod, name, logits, targets, cls_logits, labels):
    """The value of one loss (a scalar, or a tuple of arrays)."""
    if name == "softmax_ce":
        return mod.softmax_ce(cls_logits, labels, 3, label_smoothing=0.1)
    if name == "bce_with_logits":
        return mod.bce_with_logits(logits, targets, pos_weight=2.0)
    if name == "dilate_erode":
        return (mod.opening(logits), mod.closing(logits),
                mod.dilate(logits, 5), mod.erode(logits, 5))
    if name == "dice_iou_from_logits":
        return mod.dice_iou_from_logits(logits, targets)
    return getattr(mod, name)(logits, targets)


_JAX_LOSSES = {}


def _jax_losses():
    """Every loss's value and gradient w.r.t. its logits, one jit."""
    if not _JAX_LOSSES:
        def all_losses(logits, targets, cls_logits, labels):
            out = {}
            for name in _LOSSES:
                def f(lg, cl):
                    v = _loss_fn(J_losses, name, lg, targets, cl, labels)
                    s = v if not isinstance(v, tuple) else sum(
                        jnp.sum(t * (1.0 + jnp.arange(t.size).reshape(t.shape)
                                     / t.size)) for t in v[:2])
                    return s, v
                if name == "dice_iou_from_logits":
                    out[name] = (f(logits, cls_logits)[1], None)
                    continue
                (_, v), g = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(logits,
                                                             cls_logits)
                out[name] = (v, g)
            return out
        args = _loss_inputs()
        _JAX_LOSSES.update(_compile(all_losses, *args)(*args))
    return _JAX_LOSSES


@pytest.mark.parametrize("name", _LOSSES)
def test_loss_matches_jax_f32(name):
    want, want_grads = _jax_losses()[name]
    logits, targets, cls_logits, labels = _loss_inputs()
    lg, cl = _leaf(logits), _leaf(cls_logits)
    v = _loss_fn(T_losses, name, lg, torch.from_numpy(targets), cl,
                 torch.from_numpy(labels))
    vals = v if isinstance(v, tuple) else (v,)
    wants = want if isinstance(want, tuple) else (want,)
    for a, b in zip(vals, wants):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    if want_grads is None:
        return
    s = v if not isinstance(v, tuple) else sum(
        (t * (1.0 + torch.arange(t.numel()).reshape(t.shape) / t.numel()))
        .sum() for t in v[:2])
    got = torch.autograd.grad(s, (lg, cl), allow_unused=True)
    for a, b in zip(got, want_grads):
        a = np.zeros_like(np.asarray(b)) if a is None else _np(a)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- decoder

def test_decoder_matches_jax_values_and_grads():
    jcfg, _ = _mtl_cfgs()
    params = numpy_params(lambda: J_seg.init_segformer_decoder(
        jax.random.key(0), jcfg), 6)
    rng = np.random.default_rng(7)
    hidden = [rng.standard_normal((2, 16, 64)).astype(np.float32)
              for _ in range(2)]
    cot = rng.standard_normal((2, 32, 32)).astype(np.float32)

    def jf(p, hs):
        out = J_seg.apply_segformer_decoder(p, hs, (4, 4), 32)
        return jnp.sum(out * cot), out
    (_, want), (gp, gh) = _compile(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True), params, hidden)(params, hidden)
    tp = params_from_numpy(params, "cpu")
    leaves = [t.requires_grad_(True) for t in _flat(tp)]
    hs = [_leaf(h) for h in hidden]
    out = T_seg.apply_segformer_decoder(tp, hs, (4, 4), 32)
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-4)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                leaves + hs)
    wants = jax.tree.leaves(gp) + list(gh)
    assert len(grads) == len(wants)
    for a, b in zip(grads, wants):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


# ---------------------------------------------------------------- the slice

def _mtl_cfgs():
    jcfg = J_seg.MTLConfig(backbone=J_CONFIGS["test-32"], seg_layers=(0, -1),
                           embed_dim=16)
    cfg = T_seg.MTLConfig(backbone=CONFIGS["test-32"], seg_layers=(0, -1),
                          embed_dim=16)
    return jcfg, cfg


def _mtl_tree():
    jcfg, _ = _mtl_cfgs()
    return numpy_params(lambda: J_seg.init_mtl(jax.random.key(0), jcfg), 8)


def _batch(seed=9, b=4):
    rng = np.random.default_rng(seed)
    return {"pixels": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
            "cls": rng.integers(0, 3, b).astype(np.int32),
            "mask": (rng.random((b, 32, 32)) > 0.6).astype(np.float32),
            "has_mask": np.array([1, 0, 1, 1] * (b // 4), np.float32)}


def _t_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "cls"
            else torch.from_numpy(v) for k, v in batch.items()}


def _stash_grads():
    """An optax transformation that keeps the gradients it is given."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_run(tree, batch, frozen_q=None):
    """(per-step metrics, step-1 gradients, final params) of JAX's step."""
    jcfg, _ = _mtl_cfgs()
    opt = optax.chain(_stash_grads(), j_make_optimizer(
        LR, warmup_steps=1, total_steps=10))
    init_fn, step = j_make_step(jcfg, opt, J_F32, freeze_below=1,
                                seg_loss="bce_dice", frozen_q=frozen_q)
    state = jax.jit(init_fn)(tree)
    step = _compile(step, state, batch, jax.random.key(0), 1.0, 0.75)
    metrics, grads = [], None
    for i in range(STEPS):
        state, m = step(state, batch, jax.random.key(i), 1.0, 0.75)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = jax.tree.map(np.asarray, state.opt_state[0])
    return metrics, grads, jax.tree.map(np.asarray, state.params)


def _port_run(tree, batch, frozen_q=None, accum_steps=1):
    _, cfg = _mtl_cfgs()
    params = params_from_numpy(tree, "cpu")
    init_fn, step = make_mtl_train_step(
        cfg, make_optimizer(LR, warmup_steps=1, total_steps=10), F32_POLICY,
        freeze_below=1, seg_loss="bce_dice", frozen_q=frozen_q,
        accum_steps=accum_steps)
    state = init_fn(params)
    metrics, grads = [], None
    tb = _t_batch(batch)
    for i in range(STEPS):
        state, m = step(state, tb, None, 1.0, 0.75)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {id(leaf): _np(leaf.grad)
                     for leaf, _ in _trainable(state.params)}
    return metrics, grads, state.params


def _trainable(params):
    _, cfg = _mtl_cfgs()
    return trainable_leaves(params, *make_freeze_mask(params, cfg, 1))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_params_close(got, want, grad1, lr_units, msg):
    """Within lr_units · lr, except where the step-1 gradient is below
    NOISE_GRAD (a gradient that is zero in exact arithmetic, such as that
    of the key bias, whose float noise Adam turns into steps of up to lr
    either way): there within one lr per step that had a learning rate."""
    tol = np.where(np.abs(grad1) < NOISE_GRAD, LR * (STEPS - 1),
                   lr_units * LR)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{msg}: {int(bad.sum())} of {bad.size} "
                           f"parameters off, max "
                           f"{float(np.abs(got - want).max()):.3e}")


def _check_slice(tree, want, got, metric_tol, param_lr_units):
    j_metrics, j_grads, j_params = want
    t_metrics, t_grads, t_params = got
    for jm, tm in zip(j_metrics, t_metrics):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=metric_tol,
                                       err_msg=k)
    trainable = {id(leaf) for leaf, _ in _trainable(t_params)}
    for path, leaf in _paths(t_params):
        init = np.asarray(_get(tree, path))
        final = _np(leaf)
        frozen_rows = 1 if path[:2] == ("backbone", "blocks") else 0
        if id(leaf) not in trainable:            # the embeddings
            np.testing.assert_array_equal(final, init, err_msg=str(path))
            continue
        np.testing.assert_array_equal(final[:frozen_rows],
                                      init[:frozen_rows], err_msg=str(path))
        g1 = np.asarray(_get(j_grads, path))
        _assert_params_close(final, np.asarray(_get(j_params, path)), g1,
                             param_lr_units, str(path))
        np.testing.assert_allclose(t_grads[id(leaf)][frozen_rows:],
                                   np.asarray(_get(j_grads, path))
                                   [frozen_rows:], atol=1e-5, rtol=1e-3,
                                   err_msg=str(path))


def test_mtl_train_step_matches_jax_f32():
    tree, batch = _mtl_tree(), _batch()
    _check_slice(tree, _jax_run(tree, batch), _port_run(tree, batch),
                 metric_tol=1e-4, param_lr_units=0.02)


def test_mtl_train_step_int8_prefix_matches_jax():
    tree, batch = _mtl_tree(), _batch()
    jcfg, cfg = _mtl_cfgs()
    calib = batch["pixels"]
    jq = _compile(lambda p, px: j_quantize_prefix(p, jcfg, px, J_F32, 1),
                  tree, calib)(tree, calib)
    tq = quantize_frozen_prefix(params_from_numpy(tree, "cpu"), cfg,
                                torch.from_numpy(calib), F32_POLICY, 1)
    for k in ("qkv", "out", "fc1", "fc2"):
        np.testing.assert_allclose(_np(tq["act_scales"][k]),
                                   np.asarray(jq["act_scales"][k]),
                                   rtol=1e-5, err_msg=k)
    _check_slice(tree, _jax_run(tree, batch, jq), _port_run(tree, batch, tq),
                 metric_tol=1e-3, param_lr_units=0.1)


# ---------------------------------------------------------------- port only

def test_accumulation_matches_one_batch():
    """accum_steps=2 over two micro-batches of 2 equals accum_steps=1 on
    the 4 (each micro-batch holds as many masks, so the masked seg means
    agree)."""
    tree = _mtl_tree()
    batch = _batch(10)
    batch["has_mask"] = np.array([1, 0, 1, 0], np.float32)
    one = _port_run(tree, batch)
    two = _port_run(tree, batch, accum_steps=2)
    for a, b in zip(one[0], two[0]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    for (path, x), (_, y) in zip(_paths(one[2]), _paths(two[2])):
        g1 = one[1].get(id(x))
        g1 = np.ones_like(_np(x)) if g1 is None else g1
        _assert_params_close(_np(x), _np(y), g1, 0.02, str(path))


def test_mtl_params_round_trip_through_convert():
    tree = _mtl_tree()
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_frozen_prefix_must_cover_the_frozen_layers():
    _, cfg = _mtl_cfgs()
    params = params_from_numpy(_mtl_tree(), "cpu")
    tq = quantize_frozen_prefix(params, cfg, torch.zeros((2, 32, 32, 3)),
                                F32_POLICY, 1)
    with pytest.raises(ValueError, match="same freeze boundary"):
        T_seg.mtl_forward(params, torch.zeros((1, 32, 32, 3)), cfg,
                          F32_POLICY, stop_grad_below=2, frozen_blocks_q=tq)
    with pytest.raises(ValueError):
        make_optimizer(kind="sgd")


def test_schedule_matches_optax():
    port = make_optimizer(LR, warmup_steps=3, total_steps=12).schedule
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, 3, 12)
    np.testing.assert_allclose([port(i) for i in range(15)],
                               np.asarray(jax.jit(ref)(np.arange(15))),
                               rtol=1e-6, atol=1e-12)


def test_twins_route_trains_like_kernels_on_cpu():
    """On CPU tensors KERNELS run the twins, so the two routes agree."""
    tree, batch = _mtl_tree(), _batch(11)
    _, cfg = _mtl_cfgs()
    losses = []
    for ks in (None, TWINS):
        kw = {} if ks is None else {"kernels": ks}
        init_fn, step = make_mtl_train_step(
            cfg, make_optimizer(LR, warmup_steps=1), F32_POLICY,
            freeze_below=1, **kw)
        state = init_fn(params_from_numpy(tree, "cpu"))
        _, m = step(state, _t_batch(batch), None, 1.0, 0.5)
        losses.append(float(m["loss"]))
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)


@pytest.fixture(scope="module")
def sid_dataset(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("sid")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        (root / split / "images").mkdir(parents=True)
        (root / split / "masks").mkdir(parents=True)
        rows = []
        for i in range(8):
            label, name = i % 3, f"{i}.png"
            Image.fromarray((rng.random((32, 32, 3)) * 255).astype(
                np.uint8)).save(root / split / "images" / name)
            if label == 2:
                mask = np.zeros((32, 32), np.uint8)
                mask[8:24, 8:24] = 255
                Image.fromarray(mask).save(root / split / "masks" / name)
            rows.append({"name": name, "label": label})
        with open(root / split / "labels.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["name", "label"])
            w.writeheader()
            w.writerows(rows)
    return str(root)


@pytest.mark.parametrize("int8", [False, True])
def test_port_cli_trains_one_epoch(sid_dataset, tmp_path, int8):
    from tpudf_torch.cli.train_mtl import main
    from tpudf_torch.train.checkpoint import load_metrics, restore_checkpoint
    save = tmp_path / "run"
    main(["--data_dir", sid_dataset, "--save_dir", str(save),
          "--model_size", "test-32", "--image_size", "32",
          "--seg_layers", "0", "-1", "--embed_dim", "16",
          "--freeze_below", "1", "--epochs", "1", "--batch_size", "4",
          "--seg_loss", "bce_dice", "--device", "cpu"]
         + (["--int8_frozen"] if int8 else []))
    rows = list(csv.DictReader(open(save / "training_log.csv")))
    assert len(rows) == 1 and "val_dice" in rows[0]
    state = restore_checkpoint(str(save / "best"))
    assert state["step"] == 2 and state["epoch"] == 0
    assert load_metrics(str(save / "best"))["epoch"] == 0


def test_port_cli_needs_a_data_dir(monkeypatch):
    """Without --data_dir and without SID_Set (a stand-in `datasets` whose
    load_dataset raises, so nothing reaches the network) the CLI exits."""
    import sys
    import types

    from tpudf_torch.cli.train_mtl import main

    def load_dataset(*a, **k):
        raise FileNotFoundError("saberzl/SID_Set is not cached")

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=load_dataset))
    with pytest.raises(SystemExit, match="provide --data_dir"):
        main(["--device", "cpu", "--model_size", "test-32",
              "--image_size", "32"])


def test_build_mtl_trainer_takes_the_tree_of_its_config():
    """build_mtl_trainer trains the tree `mtl_params` builds from the same
    config (its state's masters equal the tree) and refuses one of another
    embed_dim or depth."""
    from tpudf_torch.entry import build_mtl_trainer, mtl_params
    kw = dict(cfg_name="test-32", embed_dim=16, seg_layers=(0, -1))
    tree = mtl_params("cpu", seed=3, **kw)
    state, _, _ = build_mtl_trainer(tree, freeze_below=1, **kw)
    for (path, a), (_, b) in zip(_paths(state.params), _paths(tree)):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="the config"):
        build_mtl_trainer(tree, cfg_name="test-32", embed_dim=32,
                          seg_layers=(0, -1))
    with pytest.raises(ValueError, match="the config"):
        build_mtl_trainer(tree, cfg_name="base-256", embed_dim=16,
                          seg_layers=(0, -1))
