"""Parity of the port's binary classifier trainer with the JAX package, on
the CPU: `binary_forward`, `make_binary_train_step` (v5 and fast heads,
EMA, mixup, the tower trained with the head, remat), Adafactor, the
augmentation ops, the DCT, `FolderImageDataset`, `restore_train_state` and
the `train_binary` CLI.

Inputs and parameters are seeded numpy handed to both packages; where JAX
draws random numbers (mixup's lam and permutation, the augmentation's
flips, jitter and noise), the test draws them with JAX's own key splits and
hands the same numbers to the port's pure applies. Tolerances:
  binary_forward (test-32, F32)  2e-5 (f32 sums in another order)
  3 steps of the binary step (test-32, F32, lr 1e-3 after a warmup of 1
       step; dropout off on both sides, as its bits cannot match): loss,
       acc and grad norm 1e-5 a step; the parameters and the EMA 0.02 lr
       (0.02 lr of Adam's ±lr steps; the EMA is the same formula of them)
  the tower trained with the head (test-32, 3 steps)  loss 1e-4; the
       parameters the MTL trainer's limits (0.02 lr, gradients that are
       zero in exact arithmetic within lr a step); remat's gradients equal
       to those without within 1e-6 (the same recompute)
  dropout  its keep rate within 5e-3 of 1 − rate over 2e5 draws, every
       kept value exactly x / (1 − rate)
  Adafactor vs optax.adafactor after clip_by_global_norm (clipped,
       factored 2-D and 3-D leaves, unfactored leaves, weight decay), 3
       steps: 1e-6
  augment applies fed JAX's draws  1e-6; the JPEG simulation: all but 1e-3
       of the values within 1e-5 (a DCT coefficient at a rounding tie of
       coeff / q may round the other way); the DCT pair 1e-4
  FolderImageDataset  samples, labels and decoded pixels equal
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_cli import image_dataset  # noqa: F401
from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tests.test_torch_port_train import (_assert_params_close, _compile,
                                         _get, _paths, _stash_grads)
from tests.test_torch_port_variants import persist_every_compile  # noqa: F401
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.data import augment as J_aug
from tpudf.data import datasets as J_data
from tpudf.models import heads as J_heads
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.ops import dct as J_dct
from tpudf.train import steps as J_steps
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.data import augment as T_aug
from tpudf_torch.data import datasets as T_data
from tpudf_torch.models import heads as T_heads
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.ops import dct as T_dct
from tpudf_torch.train import steps as T_steps
from tpudf_torch.train.checkpoint import restore_train_state, save_checkpoint

LR, STEPS, B = 1e-3, 3, 4
EMA, ALPHA = 0.9, 0.2


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _strip(head):
    """The fast head without its static entries (JAX's jit and optax take
    only arrays)."""
    out = {k: v for k, v in head.items() if k != "size"}
    if "attn" in out:
        out["attn"] = {k: v for k, v in out["attn"].items() if k != "heads"}
    return out


def _heads(kind):
    """(numpy head tree without statics, the static entries)."""
    if kind == "v5":
        return numpy_params(lambda: J_heads.init_binary_head(
            jax.random.key(0), 64), 3), {}
    return numpy_params(lambda: _strip(J_heads.init_fast_binary_head(
        jax.random.key(0), 64, "small")), 3), {"size": "small", "heads": 4}


def _with_statics(head, statics):
    if not statics:
        return head
    out = {**head, "size": statics["size"]}
    out["attn"] = {**head["attn"], "heads": statics["heads"]}
    return out


@pytest.fixture(scope="module")
def tower():
    jcfg = J_CONFIGS["test-32"]
    return numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg), 5)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"pixels": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
            "labels": np.array([0, 1, 1, 0] * (b // 4), np.float32)}


def _jax_mix_draws(i):
    """lam and the permutation JAX's step draws with rng key(i)."""
    r_mix, _ = jax.random.split(jax.random.key(i))
    r1, r2 = jax.random.split(r_mix)
    return (float(jax.random.beta(r1, ALPHA, ALPHA)),
            np.asarray(jax.random.permutation(r2, B)))


def test_binary_forward_matches_jax(tower):
    head, _ = _heads("v5")
    px = _batch(1)["pixels"]
    want = jax.jit(lambda bb, h, x: J_steps.binary_forward(
        bb, h, x, J_CONFIGS["test-32"], J_F32))(tower, head, px)
    got = T_steps.binary_forward(params_from_numpy(tower, "cpu"),
                                 params_from_numpy(head, "cpu"), _t(px),
                                 CONFIGS["test-32"], F32_POLICY)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def _no_dropout(x, rate, rng):
    return x


@pytest.mark.parametrize("kind", ["v5", "fast"])
def test_binary_train_steps_match_jax(kind, tower, monkeypatch):
    """3 steps with EMA and mixup (JAX's draws fed to the port)."""
    head, statics = _heads(kind)
    monkeypatch.setattr(J_heads, "_dropout", _no_dropout)
    monkeypatch.setattr(T_heads, "_dropout", lambda x, rate, gen: x)
    if statics:
        orig = J_steps.apply_fast_binary_head
        monkeypatch.setattr(J_steps, "apply_fast_binary_head",
                            lambda p, f, rng=None: orig(
                                _with_statics(p, statics), f, rng=rng))
    jopt = J_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    jstep = J_steps.make_binary_train_step(
        J_CONFIGS["test-32"], jopt, J_F32, kind, ema_decay=EMA,
        mixup_alpha=ALPHA)
    state = J_steps.init_train_state(head, jopt, EMA)
    batches = [_batch(10 + i) for i in range(STEPS)]
    jstep = _compile(jstep, state, tower, batches[0], jax.random.key(0))
    want = []
    for i, b in enumerate(batches):
        state, m = jstep(state, tower, b, jax.random.key(i))
        want.append({k: float(v) for k, v in m.items()})

    draws = iter([_jax_mix_draws(i) for i in range(STEPS)])
    monkeypatch.setattr(T_steps, "mixup_draws", lambda gen, n, alpha: (
        lambda lam, perm: (lam, torch.from_numpy(perm.copy()).long()))(
            *next(draws)))
    topt = T_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    tstep = T_steps.make_binary_train_step(
        CONFIGS["test-32"], topt, F32_POLICY, kind, ema_decay=EMA,
        mixup_alpha=ALPHA)
    tstate = T_steps.init_train_state(
        _with_statics(params_from_numpy(head, "cpu"), statics), topt, EMA)
    bb = params_from_numpy(tower, "cpu")
    for i, b in enumerate(batches):
        tstate, m = tstep(tstate, bb, {k: _t(v) for k, v in b.items()},
                          torch.Generator().manual_seed(i))
        for k in want[i]:
            np.testing.assert_allclose(float(m[k]), want[i][k], atol=1e-5,
                                       err_msg=f"step {i} {k}")
    for which, jt in (("params", state.params), ("ema", state.ema)):
        tt = _strip(getattr(tstate, which)) if statics else \
            getattr(tstate, which)
        for path, leaf in _paths(tt):
            np.testing.assert_allclose(_np(leaf), np.asarray(_get(jt, path)),
                                       atol=0.02 * LR, rtol=0,
                                       err_msg=f"{which} {path}")
    if statics:
        assert tstate.params["size"] == "small"


def test_dropout_keep_rate_and_scale():
    x = torch.full((200_000,), 2.0)
    for rate in (0.3, 0.2, 0.05):
        y = T_heads._dropout(x, rate, torch.Generator().manual_seed(1))
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) < 5e-3
        assert torch.all(y[kept] == 2.0 / (1 - rate))
    assert torch.equal(T_heads._dropout(x, 0.3, None), x)
    head = params_from_numpy(_heads("v5")[0], "cpu")
    f = torch.randn((8, 64), generator=torch.Generator().manual_seed(2))
    a = T_heads.apply_binary_head(head, f)
    b = T_heads.apply_binary_head(head, f,
                                  generator=torch.Generator().manual_seed(3))
    assert not torch.allclose(a, b)


def _backbone_run_jax(tower, head, batches):
    jopt = J_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    jopt = optax.chain(_stash_grads(), jopt)
    jstep = J_steps.make_binary_train_step(J_CONFIGS["test-32"], jopt, J_F32,
                                           "v5", train_backbone=True)
    state = J_steps.init_train_state({"backbone": tower, "head": head}, jopt)
    jstep = _compile(jstep, state, None, batches[0], jax.random.key(0))
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, m = jstep(state, None, b, jax.random.key(i))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = jax.tree.map(np.asarray, state.opt_state[0])
    return losses, grads, jax.tree.map(np.asarray, state.params)


def _backbone_run_port(tower, head, batches, remat=False):
    import dataclasses
    cfg = dataclasses.replace(CONFIGS["test-32"], remat=remat)
    opt = T_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    step = T_steps.make_binary_train_step(cfg, opt, F32_POLICY, "v5",
                                          train_backbone=True)
    state = T_steps.init_train_state(
        {"backbone": params_from_numpy(tower, "cpu"),
         "head": params_from_numpy(head, "cpu")}, opt)
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, m = step(state, None, {k: _t(v) for k, v in b.items()}, None)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = [_np(t.grad) for t in T_steps.tensor_leaves(state.params)]
    return losses, grads, state.params


def test_train_backbone_steps_match_jax_and_remat(tower, monkeypatch):
    """The tower trained with the head (no dropout: JAX's step without
    mixup still draws it, so both sides run it off), 3 steps against JAX;
    remat's step-1 gradients equal those without."""
    monkeypatch.setattr(J_heads, "_dropout", _no_dropout)
    head, _ = _heads("v5")
    batches = [_batch(20 + i) for i in range(STEPS)]
    j_losses, j_grads, j_params = _backbone_run_jax(tower, head, batches)
    t_losses, t_grads, t_params = _backbone_run_port(tower, head, batches)
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-4)
    for path, leaf in _paths(t_params):
        g1 = np.asarray(_get(j_grads, path))
        _assert_params_close(_np(leaf), np.asarray(_get(j_params, path)), g1,
                             0.02, str(path))
    r_losses, r_grads, _ = _backbone_run_port(tower, head, batches[:1],
                                              remat=True)
    assert r_losses[0] == pytest.approx(t_losses[0], abs=1e-6)
    for a, b in zip(r_grads, t_grads):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_tome_with_train_backbone_raises():
    with pytest.raises(ValueError, match="frozen-backbone"):
        T_steps.make_binary_train_step(CONFIGS["test-32"], None,
                                       train_backbone=True, tome_r=4)


# ---------------------------------------------------------------- Adafactor

def test_adafactor_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(300, 200), (64, 300), (3, 256, 128), (50,), (128, 128)]
    params = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (3.0 if i == 0
                                                             else 0.01)
              for s in shapes] for i in range(STEPS)]
    jopt = J_steps.make_optimizer(1e-2, weight_decay=1e-3, warmup_steps=1,
                                  total_steps=10, kind="adafactor")
    jp = [jnp.asarray(p) for p in params]
    st = jopt.init(jp)
    upd = jax.jit(jopt.update)
    for g in grads:
        u, st = upd([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)
    topt = T_steps.make_optimizer(1e-2, weight_decay=1e-3, warmup_steps=1,
                                  total_steps=10, kind="adafactor")
    tp = [_t(p) for p in params]
    tst = topt.init(tp)
    norms = []
    for g in grads:
        tst, n = topt.update([_t(x) for x in g], tst, tp)
        norms.append(float(n))
    assert norms[0] > 1.0                     # the global clip acts
    assert "v_row" in tst["moments"][0] and "v" in tst["moments"][1]
    assert "v_row" in tst["moments"][2] and "v" in tst["moments"][3]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        T_steps.make_optimizer(kind="sgd")


# ---------------------------------------------------------------- augment

def _images(seed=5, b=3, s=32):
    return np.random.default_rng(seed).random((b, s, s, 3)).astype(
        np.float32)


def test_augment_applies_match_jax():
    x = _images()
    jx, tx = jnp.asarray(x), _t(x)
    key = jax.random.key(11)
    k = jax.random.split(key, 8)
    bern = lambda kk, p: np.array(jax.random.bernoulli(kk, p, (3,)))
    cases = []
    f = bern(k[0], 0.5)
    cases.append(("hflip", J_aug.random_hflip(k[0], jx),
                  T_aug.hflip_apply(tx, torch.from_numpy(f))))
    cases.append(("vflip", J_aug.random_vflip(k[0], jx),
                  T_aug.vflip_apply(tx, torch.from_numpy(f))))
    rot = np.array(jax.random.randint(k[1], (3,), 0, 4))
    cases.append(("rot90", J_aug.random_rot90(k[1], jx),
                  T_aug.rot90_apply(tx, torch.from_numpy(rot))))
    r1, r2 = jax.random.split(k[2])
    db = jax.random.uniform(r1, (3, 1, 1, 1), minval=-0.2, maxval=0.2)
    dc = 1.0 + jax.random.uniform(r2, (3, 1, 1, 1), minval=-0.2, maxval=0.2)
    cases.append(("brightness/contrast",
                  J_aug.random_brightness_contrast(k[2], jx),
                  T_aug.brightness_contrast_apply(tx, _t(db), _t(dc))))
    s = 1.0 + jax.random.uniform(k[3], (3, 1, 1, 1), minval=-0.2, maxval=0.2)
    cases.append(("saturation", J_aug.random_saturation(k[3], jx),
                  T_aug.saturation_apply(tx, _t(s))))
    cases.append(("blur", J_aug.random_gaussian_blur(k[4], jx, p=0.6),
                  T_aug.blur_apply(tx, torch.from_numpy(bern(k[4], 0.6)))))
    cases.append(("gaussian_blur", J_aug.gaussian_blur(jx, 1.5, 3),
                  T_aug.gaussian_blur(tx, 1.5, 3)))
    n1, n2 = jax.random.split(k[5])
    noise = jax.random.normal(n1, x.shape) * 0.02
    cases.append(("noise", J_aug.random_gaussian_noise(k[5], jx, p=0.6),
                  T_aug.noise_apply(tx, _t(noise), torch.from_numpy(
                      np.array(jax.random.bernoulli(n2, 0.6, (3,)))))))
    cases.append(("clahe", J_aug.clahe_approx(jx), T_aug.clahe_approx(tx)))
    for name, want, got in cases:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=name)


def _jpeg_close(got, want, name):
    off = np.abs(_np(got) - np.asarray(want)) > 1e-5
    assert off.mean() <= 1e-3, (name, off.mean())


def test_jpeg_and_composite_augment_match_jax():
    x = _images(6)
    jx, tx = jnp.asarray(x), _t(x)
    for q in (5, 25, 75):
        _jpeg_close(T_aug.jpeg_simulate(tx, q), J_aug.jpeg_simulate(jx, q),
                    f"jpeg q={q}")
    key = jax.random.key(12)
    r1, r2 = jax.random.split(key)
    pick = np.array(jax.random.randint(r1, (3,), 0, 5))
    do = np.array(jax.random.bernoulli(r2, 0.9, (3,)))
    _jpeg_close(T_aug.jpeg_apply(tx, torch.from_numpy(pick),
                                 torch.from_numpy(do)),
                J_aug.random_jpeg(key, jx, p=0.9), "random_jpeg")
    # the composite, its draws made with JAX's key splits
    k = jax.random.split(jax.random.key(13), 8)
    bern = lambda kk, p: torch.from_numpy(np.array(
        jax.random.bernoulli(kk, p, (3,))))
    u = lambda kk: _t(jax.random.uniform(kk, (3, 1, 1, 1), minval=-0.2,
                                         maxval=0.2))
    b1, b2 = jax.random.split(k[2])
    n1, n2 = jax.random.split(k[5])
    j1, j2 = jax.random.split(k[6])
    draws = {"hflip": bern(k[0], 0.5),
             "rot": torch.from_numpy(np.array(
                 jax.random.randint(k[1], (3,), 0, 4))),
             "bc": (u(b1), 1.0 + u(b2)), "sat": 1.0 + u(k[3]),
             "blur": bern(k[4], 0.3),
             "noise": (_t(jax.random.normal(n1, x.shape) * 0.02),
                       bern(n2, 0.3)),
             "jpeg": (torch.from_numpy(np.array(
                 jax.random.randint(j1, (3,), 0, 5))), bern(j2, 0.5))}
    want = J_aug.train_augment(jax.random.key(13), jx, rot=True, jpeg=True)
    _jpeg_close(T_aug.augment_apply(tx, draws), want, "train_augment")
    g = torch.Generator().manual_seed(0)
    out = T_aug.train_augment(g, tx, rot=True, jpeg=True)
    assert out.shape == tx.shape and 0.0 <= float(out.min()) \
        and float(out.max()) <= 1.0


def test_dct_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 16, 24, 3)).astype(
        np.float32) * 50
    for name, j, t in (("dct2", J_dct.dct2_8x8, T_dct.dct2_8x8),
                       ("idct2", J_dct.idct2_8x8, T_dct.idct2_8x8)):
        np.testing.assert_allclose(_np(t(_t(x))), np.asarray(j(x)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(_np(t(_t(x[..., 0]))),
                                   np.asarray(j(x[..., 0])), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------- data

def test_folder_dataset_matches_jax(image_dataset, tmp_path):  # noqa: F811
    root = tmp_path / "ds"
    os.symlink(image_dataset, root)
    bad = tmp_path / "ds2"
    for cls in ("REAL", "FAKE"):
        (bad / "TRAIN" / cls).mkdir(parents=True)
        (bad / "TRAIN" / cls / "broken.jpg").write_bytes(b"not an image")
    for path, split in ((str(root), "train"), (str(root), "val"),
                        (str(bad), "train")):
        j = J_data.FolderImageDataset(path, split, 24)
        t = T_data.FolderImageDataset(path, split, 24)
        assert t.samples == j.samples and len(t) == len(j)
        for kw in (dict(), dict(shuffle=True, seed=3, drop_last=True)):
            jb = list(j.batches(5, **kw))
            tb = list(t.batches(5, **kw))
            assert len(jb) == len(tb)
            for a, b in zip(jb, tb):
                assert a["paths"] == b["paths"]
                np.testing.assert_array_equal(a["labels"], b["labels"])
                np.testing.assert_array_equal(a["pixels"], b["pixels"])
    assert T_data.list_images(str(root)) == J_data.list_images(str(root))
    with pytest.raises(FileNotFoundError):
        T_data.FolderImageDataset(str(tmp_path), "train")


# ------------------------------------------------------ checkpoint and CLI

@pytest.mark.parametrize("ema", [None, 0.99])
def test_restore_train_state_with_and_without_ema(ema, tmp_path):
    head = params_from_numpy(_heads("v5")[0], "cpu")
    opt = T_steps.make_optimizer(LR)
    state = T_steps.init_train_state(head, opt, ema)
    path = str(tmp_path / "best")
    save_checkpoint(path, state._asdict() | {"epoch": 2}, {"f1": 0.5})
    got = restore_train_state(path)
    assert got["epoch"] == 2 and got["step"] == 0
    assert (got["ema"] is None) == (ema is None)
    for a, b in zip(T_steps.tensor_leaves(got["params"]),
                    T_steps.tensor_leaves(head)):
        assert torch.equal(a, b.detach())
    assert len(got["opt_state"]["mu"]) == len(T_steps.tensor_leaves(head))
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "missing"))


def test_port_binary_cli(image_dataset, tmp_path):  # noqa: F811
    """tests/test_cli.py's invocations through the port: the W8A8 tower
    with the deployed ToMe, EMA and mixup, then --evaluate_only --resume."""
    from tpudf_torch.cli.train_binary import main
    from tpudf_torch.train.checkpoint import load_metrics
    save = str(tmp_path / "run")
    common = ["--data_dir", image_dataset, "--model_size", "test-32",
              "--batch_size", "8", "--device", "cpu", "--int8_backbone",
              "--tome_r"]
    main(common + ["--save_dir", save, "--epochs", "2", "--warmup_steps",
                   "2", "--ema_decay", "0.9", "--mixup_alpha", "0.2"])
    assert os.path.exists(os.path.join(save, "training_log.csv"))
    state = restore_train_state(os.path.join(save, "best"))
    assert state["ema"] is not None and state["step"] >= 2
    assert load_metrics(os.path.join(save, "best"))["epoch"] == \
        state["epoch"]
    main(common + ["--save_dir", save, "--evaluate_only", "--resume",
                   os.path.join(save, "best"), "--head", "v5"])
    main(["--data_dir", image_dataset, "--model_size", "test-32",
          "--batch_size", "8", "--device", "cpu", "--head", "fast",
          "--save_dir", str(tmp_path / "fast"), "--epochs", "1",
          "--no_augment"])
    assert os.path.exists(os.path.join(str(tmp_path / "fast"), "best"))
