"""Parity of the port's expert-stack trainers with the JAX package, on the
CPU: the CORAL fit, the v5 frequency expert and the adaptive fusion head,
`train_freq_mlp` / `train_fusion_head`, the experts CLI's batches and the
CLI itself (tpudf_torch/train/experts.py, tpudf_torch/cli/train_experts.py).

Where JAX draws numbers with numpy (the val split, the epoch orders) the
port draws the same numbers; the initial parameters are JAX's init trees
carried across as numpy (`params=`); the v5 expert's dropout (a jax.random
draw) is off on both sides (each side's apply patched to drop its key or
generator). Tolerances:
  fit_coral_cutpoints, fit_coral (cutpoints, temperature, 50-bin
       histogram), auto_pos_weight, the val split and epoch orders: equal
  apply_freq_mlp_v5, apply_adaptive_fusion: rtol 1e-5
  train_freq_mlp (simple and v5, 5 epochs) and train_fusion_head (20
       epochs) on seeded separable features: every parameter within 1e-5
       of its leaf's largest magnitude, or within 1e-4 lr where that is
       larger (Adam moves a leaf by up to lr a step whatever its gradient's
       size, so a gradient that nearly cancels turns f32 rounding into a
       step of that order: the v5 head's one bias, 7.6e-4 after 20 steps,
       sits 1.39e-8 = 1.4e-5 lr from JAX's; every other leaf is within
       1e-5 relative); each epoch's val AUC within 1e-6, the same best
       epoch
  `_batches`: pixels equal, the gray plane at 64 px → 256 within 1e-6
  the CLI at test-64 on a 16-image folder (the same HF state dict through
       --backbone_ckpt): the 24-d features by tests/test_torch_port_ops.py's
       rule (atol 2e-3, rtol 2e-3); every artifact written by one package
       loads in the other's loaders and evaluates the same there (rtol
       1e-6)
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import tpudf.eval.metrics as J_metrics
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_variants import persist_every_compile  # noqa: F401
from tpudf.calib import coral as J_coral
from tpudf.cli import train_experts as J_cli
from tpudf.models import freq_mlp as J_freq
from tpudf.models import fusion as J_fusion
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.train import experts as J_exp
from tpudf.train import video as J_video
from tpudf_torch.calib import coral as T_coral
from tpudf_torch.cli import train_experts as T_cli
from tpudf_torch.convert import (adaptive_fusion_from_numpy,
                                 freq_mlp_v5_from_numpy)
from tpudf_torch.models import freq_mlp as T_freq
from tpudf_torch.models import fusion as T_fusion
from tpudf_torch.train import experts as T_exp
from tpudf_torch.train import video as T_video
from tpudf_torch.utils import safetensors_io

# 301 samples: a val split of 45 leaves 256 to train on, 4 whole batches of
# 64 (one compile of JAX's step); the fusion head's 320 are 5
N, D = 301, 24


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _features(seed, n=N):
    """Seeded separable features: the first 8 dims shifted by the label."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.5).astype(np.float32)
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[:, :8] += 0.8 * (2 * y[:, None] - 1)
    return x, y


def _leaves_close(got, want, rel, msg="", lr=0.0):
    g = jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy() if torch.is_tensor(t) else t, got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (msg, i)
        tol = max(rel * float(np.abs(b).max()), 1e-4 * lr, 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{msg} leaf {i}: {err:.3e} > {tol:.3e}"


# ---------------------------------------------------------------- CORAL

def test_fit_coral_cutpoints_bit_equal():
    for n in (7, 100, 1001):
        z = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        assert T_coral.fit_coral_cutpoints(z) == J_coral.fit_coral_cutpoints(z)
        q = (0.1, 0.5, 0.99)
        assert (T_coral.fit_coral_cutpoints(z, q)
                == J_coral.fit_coral_cutpoints(z, q))


@pytest.mark.parametrize("with_labels", [True, False])
def test_fit_coral_bit_equal(with_labels):
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(500) * 2).astype(np.float32)
    y = (rng.random(500) < 1 / (1 + np.exp(-z))).astype(np.float32) \
        if with_labels else None
    got, want = T_exp.fit_coral(z, y), J_exp.fit_coral(z, y)
    assert got.cutpoints == want.cutpoints
    assert got.temperature == want.temperature
    np.testing.assert_array_equal(got.bins_histogram, want.bins_histogram)
    assert got.bins_histogram.shape == (50,)


def test_auto_pos_weight_equal():
    for y in ([0, 1, 1, 0, 0], [1, 1, 1], [0, 0], []):
        assert T_video.auto_pos_weight(y) == J_video.auto_pos_weight(y)


# --------------------------------------------------------------- heads

def test_apply_freq_mlp_v5_matches_jax():
    x, _ = _features(1, 64)
    jp = jax.jit(lambda k, f: J_freq.fit_freq_normalizer(
        J_freq.init_freq_mlp_v5(k), f))(jax.random.key(4), x[:40])
    jp["gates"] = jax.numpy.asarray([0.3, -0.2, 0.1, 0.5])
    jp["temp"] = jax.numpy.asarray(1.3)
    tree = _np_tree(jp)
    tp = freq_mlp_v5_from_numpy(tree, "cpu")
    _leaves_close(tp, tree, 0.0, "carried tree")
    got = T_freq.apply_freq_mlp_v5(tp, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(J_freq.apply_freq_mlp_v5)(jp, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    norm = T_freq.fit_freq_normalizer(tp, torch.from_numpy(x[:40]))
    for k in ("norm_mean", "norm_std"):
        np.testing.assert_allclose(norm[k].numpy(), tree[k], rtol=1e-6)
    with pytest.raises(ValueError, match="v5 frequency MLP"):
        freq_mlp_v5_from_numpy({"ln": 0}, "cpu")


def test_freq_mlp_jitter_and_v5_dropout():
    """The simple expert's eval-time jitter is 0.001 · N(0, 1) of the
    generator's draws; the v5 blocks' dropout keeps 1 − 0.05 of the
    values, each scaled by 1 / 0.95."""
    x, _ = _features(2, 8)
    p = T_freq.init_freq_mlp(torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    got = T_freq.apply_freq_mlp(p, xt, torch.Generator().manual_seed(5))
    noise = torch.randn(xt.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, T_freq.apply_freq_mlp(p, xt + 0.001
                                                          * noise))
    h = torch.ones(400, 500)
    from tpudf_torch.models.heads import _dropout
    out = _dropout(h, 0.05, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.95) < 5e-3
    assert torch.equal(out[kept], h[kept] / 0.95)


def test_apply_adaptive_fusion_matches_jax():
    rng = np.random.default_rng(5)
    zf, zs = (rng.standard_normal(128).astype(np.float32) * 3
              for _ in range(2))
    jp = jax.jit(J_fusion.init_adaptive_fusion)(jax.random.key(6))
    jp["temp"] = jax.numpy.asarray(0.8)
    tree = _np_tree(jp)
    tp = adaptive_fusion_from_numpy(tree, "cpu")
    _leaves_close(tp, tree, 0.0, "carried tree")
    got = T_fusion.apply_adaptive_fusion(tp, torch.from_numpy(zf),
                                         torch.from_numpy(zs)).numpy()
    want = np.asarray(jax.jit(J_fusion.apply_adaptive_fusion)(jp, zf, zs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ trainers

def _auc_recorder(calls, fn):
    def rec(labels, scores):
        auc = fn(labels, scores)
        calls.append(float(auc))
        return auc
    return rec


@pytest.mark.parametrize("v5", [False, True], ids=["simple", "v5"])
def test_train_freq_mlp_matches_jax(v5, monkeypatch):
    x, y = _features(7)
    seed, epochs = 3, 5
    init = jax.jit(J_freq.init_freq_mlp_v5 if v5 else J_freq.init_freq_mlp)(
        jax.random.key(seed))
    j_aucs, t_aucs = [], []
    monkeypatch.setattr(J_metrics, "roc_auc",
                        _auc_recorder(j_aucs, J_metrics.roc_auc))
    monkeypatch.setattr(T_exp, "roc_auc", _auc_recorder(t_aucs, T_exp.roc_auc))
    apply_v5 = J_freq.apply_freq_mlp_v5
    monkeypatch.setattr(J_exp, "apply_freq_mlp_v5",
                        lambda p, xb, rng=None: apply_v5(p, xb))
    t_apply_v5 = T_exp.apply_freq_mlp_v5
    monkeypatch.setattr(T_exp, "apply_freq_mlp_v5",
                        lambda p, xb, generator=None: t_apply_v5(p, xb))
    want, want_auc = J_exp.train_freq_mlp(x, y, v5=v5, epochs=epochs,
                                          batch_size=64, seed=seed,
                                          log_fn=lambda m: None)
    got, got_auc = T_exp.train_freq_mlp(x, y, v5=v5, epochs=epochs,
                                        batch_size=64, seed=seed,
                                        log_fn=lambda m: None,
                                        params=_np_tree(init), device="cpu")
    assert len(j_aucs) == len(t_aucs) == epochs
    np.testing.assert_allclose(t_aucs, j_aucs, atol=1e-6)
    assert int(np.argmax(t_aucs)) == int(np.argmax(j_aucs))
    assert abs(got_auc - want_auc) <= 1e-6
    _leaves_close(got, want, 1e-5, "best params", lr=1e-3)


def test_train_fusion_head_matches_jax():
    rng, n = np.random.default_rng(8), 320
    y = (rng.random(n) < 0.5).astype(np.float32)
    zf = (rng.standard_normal(n) + 1.5 * (2 * y - 1)).astype(np.float32)
    zs = (rng.standard_normal(n) * 2 + 0.5 * (2 * y - 1)).astype(np.float32)
    seed = 2
    init = _np_tree(jax.jit(J_fusion.init_adaptive_fusion)(
        jax.random.key(seed)))
    want = J_exp.train_fusion_head(zf, zs, y, epochs=20, batch_size=64,
                                   seed=seed, log_fn=lambda m: None)
    got = T_exp.train_fusion_head(zf, zs, y, epochs=20, batch_size=64,
                                  seed=seed, log_fn=lambda m: None,
                                  params=init, device="cpu")
    _leaves_close(got, want, 1e-5, "fusion head", lr=5e-3)


# ------------------------------------------------------------- the CLI

def _images(root, n, size, seed):
    """n seeded PNGs a class in root/train/{REAL,FAKE} (FAKE brighter)."""
    rng = np.random.default_rng(seed)
    paths = []
    for cls, bias in (("REAL", 0.0), ("FAKE", 0.4)):
        d = os.path.join(root, "train", cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = np.clip(rng.random((size, size, 3)) * 0.6 + bias, 0, 1)
            p = os.path.join(d, f"{i}.png")
            Image.fromarray((arr * 255).astype(np.uint8)).save(p)
            paths.append(p)
    return paths


def test_batches_gray_matches_jax(tmp_path):
    paths = _images(str(tmp_path), 3, 48, 9)
    want = list(J_cli._batches(paths, 64, 4))
    got = list(T_cli._batches(paths, 64, 4, "cpu"))
    assert len(got) == len(want) == 2
    for (tp, tg), (jp, jg) in zip(got, want):
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert tg.shape == jg.shape == (len(jp), 256, 256)
        np.testing.assert_allclose(tg.numpy(), jg, atol=1e-6, rtol=0)
    assert T_cli._gather(str(tmp_path))[0] == J_cli._gather(str(tmp_path))[0]


def _hf_state_dict(cfg, seed):
    """An HF SiglipVisionModel state dict of `cfg` in numpy f32, seeded
    (weights N(0, 1/fan_in), LN scales 1 + N(0, 0.05²), biases
    N(0, 0.05²), position embedding and probe N(0, 0.02²))."""
    rng = np.random.default_rng(seed)
    w, m, p = cfg.width, cfg.mlp_dim, cfg.patch_size
    n = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    sd = {}

    def lin(name, o, i):
        sd[name + ".weight"] = n(o, i, std=i ** -0.5)
        sd[name + ".bias"] = n(o, std=0.05)

    def ln(name):
        sd[name + ".weight"] = 1 + n(w, std=0.05)
        sd[name + ".bias"] = n(w, std=0.05)

    pre = "vision_model."
    sd[pre + "embeddings.patch_embedding.weight"] = n(
        w, 3, p, p, std=(3 * p * p) ** -0.5)
    sd[pre + "embeddings.patch_embedding.bias"] = n(w, std=0.05)
    sd[pre + "embeddings.position_embedding.weight"] = n(
        cfg.num_patches, w, std=0.02)
    for i in range(cfg.layers):
        e = f"{pre}encoder.layers.{i}."
        ln(e + "layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(e + "self_attn." + proj, w, w)
        ln(e + "layer_norm2")
        lin(e + "mlp.fc1", m, w)
        lin(e + "mlp.fc2", w, m)
    ln(pre + "post_layernorm")
    sd[pre + "head.probe"] = n(1, 1, w, std=0.02)
    sd[pre + "head.attention.in_proj_weight"] = n(3 * w, w, std=w ** -0.5)
    sd[pre + "head.attention.in_proj_bias"] = n(3 * w, std=0.05)
    lin(pre + "head.attention.out_proj", w, w)
    ln(pre + "head.layernorm")
    lin(pre + "head.mlp.fc1", m, w)
    lin(pre + "head.mlp.fc2", w, m)
    return sd


def _feature_recorder(box, fn):
    def rec(features, labels, **kw):
        box.append(np.array(features))
        return fn(features, labels, **kw)
    return rec


def _artifacts_cross_load(src, x, p_sig, p_freq):
    """Every artifact in src loads in both packages' loaders and the
    loaded experts compute the same on (x, p_sig, p_freq)."""
    xt = torch.from_numpy(x)
    f = os.path.join(src, "freq_mlp.safetensors")
    np.testing.assert_allclose(
        T_freq.apply_freq_mlp(T_freq.freq_mlp_from_safetensors(f), xt)
        .numpy(), np.asarray(J_freq.apply_freq_mlp(
            J_freq.freq_mlp_from_safetensors(f), x)), rtol=1e-6, atol=1e-6)
    f = os.path.join(src, "freq_mlp_v5.safetensors")
    np.testing.assert_allclose(
        T_freq.apply_freq_mlp_v5(T_freq.freq_mlp_v5_from_safetensors(f), xt)
        .numpy(), np.asarray(J_freq.apply_freq_mlp_v5(
            J_freq.freq_mlp_v5_from_safetensors(f), x)), rtol=1e-6,
        atol=1e-6)
    f = os.path.join(src, "fusion_head.safetensors")
    np.testing.assert_allclose(
        T_fusion.apply_fusion_linear(
            T_fusion.fusion_linear_from_safetensors(f),
            torch.from_numpy(p_sig), torch.from_numpy(p_freq)).numpy(),
        np.asarray(J_fusion.apply_fusion_linear(
            J_fusion.fusion_linear_from_safetensors(f), p_sig, p_freq)),
        rtol=1e-6, atol=1e-6)
    cut, temp = (os.path.join(src, n) for n in ("coral_cutpoints.json",
                                                  "coral_temp.json"))
    tc = T_coral.CoralCutpoints.from_json(cut, temp)
    jc = J_coral.CoralCutpoints.from_json(cut, temp)
    assert tc.cuts == jc.cuts and tc.temperature == jc.temperature
    assert np.load(os.path.join(src, "coral_bins.npy")).shape == (50,)
    with open(os.path.join(src, "experts_summary.json")) as fh:
        assert {"freq_auc", "freq_v5_auc", "fusion_loss", "fused_auc",
                "coral_cutpoints_prob", "coral_temperature"} <= set(
                    json.load(fh))


def test_cli_main_matches_jax(tmp_path, monkeypatch):
    from safetensors.numpy import save_file
    data = str(tmp_path / "data")
    _images(data, 8, 64, 11)
    ckpt = str(tmp_path / "hf.safetensors")
    save_file(_hf_state_dict(J_CONFIGS["test-64"], 12), ckpt)
    j_feats, t_feats = [], []
    monkeypatch.setattr(J_exp, "train_freq_mlp", _feature_recorder(
        j_feats, J_exp.train_freq_mlp))
    monkeypatch.setattr(T_exp, "train_freq_mlp", _feature_recorder(
        t_feats, T_exp.train_freq_mlp))
    common = ["--data_dir", data, "--model_size", "test-64",
              "--backbone_ckpt", ckpt, "--v5", "--freq_epochs", "2",
              "--fusion_steps", "5", "--batch_size", "8"]
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = J_cli.main(common + ["--save_dir", j_dir])
    got = T_cli.main(common + ["--save_dir", t_dir, "--device", "cpu"])
    assert set(got) == set(want)
    assert len(j_feats) == len(t_feats) == 2         # simple, then v5
    assert t_feats[0].shape == (16, 24)
    np.testing.assert_allclose(t_feats[0], j_feats[0], atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(t_feats[0], t_feats[1])
    x = t_feats[0]
    rng = np.random.default_rng(13)
    p_sig, p_freq = (rng.random(16).astype(np.float32) for _ in range(2))
    for src in (j_dir, t_dir):
        _artifacts_cross_load(src, x, p_sig, p_freq)


def test_safetensors_io_matches_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    rng = np.random.default_rng(14)
    sd = {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
          "b": np.arange(7, dtype=np.int64), "c": np.float32([2.5]),
          "d": rng.integers(-128, 127, (2, 2, 3)).astype(np.int8)}
    mine, theirs = str(tmp_path / "m.safetensors"), str(tmp_path / "t")
    safetensors_io.save_file(sd, mine)
    save_file(sd, theirs)
    for got in (load_file(mine), safetensors_io.load_file(theirs),
                safetensors_io.load_file(mine)):
        assert set(got) == set(sd)
        for k in sd:
            assert got[k].dtype == sd[k].dtype
            np.testing.assert_array_equal(got[k], sd[k])


def test_safetensors_io_reads_bf16(tmp_path):
    """A BF16 checkpoint (as published towers ship) widens to f32 exactly,
    through the reader and through the convert CLI's state-dict loader."""
    from safetensors.torch import save_file

    from tpudf_torch.models.convert import _load_state_dict
    gen = torch.Generator().manual_seed(15)
    sd = {"w": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
          "b": torch.tensor([-0.0, 1.5, 3e38, -2e-39]).to(torch.bfloat16),
          "f": torch.randn(3, generator=gen)}
    path = str(tmp_path / "bf16.safetensors")
    save_file(sd, path)
    for got in (safetensors_io.load_file(path), _load_state_dict(path)):
        assert set(got) == set(sd)
        for k, t in sd.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], t.float().numpy())
