"""Parity of the port's video trainer with the JAX package, on the CPU: the
video head, the clip reader and video dataset, the frozen-tower train step
and the train_video CLI (tpudf_torch/models/heads.py `apply_video_head`,
tpudf_torch/data/datasets.py, tpudf_torch/train/video.py,
tpudf_torch/cli/train_video.py).

Backbone and head are JAX's init trees carried across as numpy; the
head's dropout (a jax.random draw) is off on both sides (rng=None,
generator=None) and checked on its own. Tolerances:
  apply_video_head  rtol 1e-5 (and its fc1 / fc2 / fc3 captures)
  dropout  keep rate within 5e-3 of 1 − rate over 2e5 draws at 0.3 and
       0.3 · 0.67, every kept value exactly x / (1 − rate)
  extract_frames on cv2-written mp4v clips  equal uint8 (a clip shorter
       than num_frames repeats frames; an unreadable one is black frames)
  FolderVideoDataset  samples equal, batches (frames, labels, paths) equal
  video_frame_features (test-32, F32)  tests/test_torch_port_float.py's
       tower rule: atol 2e-3
  3 steps of make_video_train_step (test-32, B 2, T 4, F32, lr 1e-3
       after 1 warmup step, pos_weight 1.5): loss and accuracy within 1e-5
       a step, the head's parameters within 1e-5
  the frozen tower: no gradient reaches a backbone leaf
  train_video.main  1 epoch float and --int8_backbone: the ledger row and
       `best` written, `best` restores; with --analysis (1 epoch, float)
       it trains, then writes learning_analysis.json (JAX's battery's keys
       and values on the same evidence, rtol 1e-12: host numpy), the
       dashboard and the figure suite; its activation statistics within
       rtol 2e-2 of JAX's on the same head and bf16 features (the head's
       bf16 L2 norm, mean and LN round differently in torch and XLA: read
       here, one ReLU output of 192 on the other side of 0, sparsity
       0.375 against 0.370, the score 1.0e-2 apart); without matplotlib
       it writes the JSON (JAX's keys), says so and draws nothing
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tests.test_torch_port_variants import persist_every_compile  # noqa: F401
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.data import datasets as J_data
from tpudf.eval import analysis as J_an
from tpudf.models import heads as J_heads
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.train import steps as J_steps
from tpudf.train import video as J_video
from tpudf_torch.cli import train_video as T_cli
from tpudf_torch.convert import params_from_numpy, video_head_from_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.data import datasets as T_data
from tpudf_torch.eval import analysis as T_an
from tpudf_torch.models import heads as T_heads
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.train import steps as T_steps
from tpudf_torch.train import video as T_video
from tpudf_torch.train.checkpoint import restore_checkpoint
from tpudf_torch.train.steps import tensor_leaves

NO_FOLDING = {"xla_disable_hlo_passes": "constant_folding"}
LR, STEPS, B, T = 1e-3, 3, 2, 4
POS_W = 1.5


def _np(t):
    return t.detach().float().numpy()


def _head_tree(seed, dim=64):
    return numpy_params(lambda: J_heads.init_video_head(jax.random.key(0),
                                                        dim), seed)


def test_apply_video_head_matches_jax():
    head = _head_tree(1)
    f = np.random.default_rng(2).standard_normal((3, 5, 64)).astype(
        np.float32)
    tp = video_head_from_numpy(head, "cpu")
    for a, b in zip(jax.tree.leaves(head), tensor_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)
    j_acts, t_acts = {}, {}
    want = J_heads.apply_video_head(head, f, acts=j_acts)
    got = T_heads.apply_video_head(tp, torch.from_numpy(f), acts=t_acts)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert set(t_acts) == set(j_acts) == {"fc1", "fc2", "fc3"}
    for k in j_acts:
        np.testing.assert_allclose(_np(t_acts[k]), np.asarray(j_acts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="video head"):
        video_head_from_numpy({"ln": head["ln"]}, "cpu")


@pytest.mark.parametrize("rate", [0.3, 0.3 * 0.67])
def test_video_head_dropout_rate_and_scale(rate):
    x = torch.ones(400, 500)
    out = T_heads._dropout(x, rate, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5e-3
    assert torch.equal(out[kept], x[kept] / (1 - rate))
    # the head draws both masks from the one generator; without it, none
    tp = video_head_from_numpy(_head_tree(4), "cpu")
    f = torch.randn(4, 3, 64, generator=torch.Generator().manual_seed(5))
    a = T_heads.apply_video_head(tp, f, torch.Generator().manual_seed(6))
    b = T_heads.apply_video_head(tp, f, torch.Generator().manual_seed(6))
    assert torch.equal(a, b)
    assert not torch.equal(a, T_heads.apply_video_head(tp, f))


# ------------------------------------------------------------ the clips

def _write_clip(path, n, h, w, seed):
    import cv2
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), np.uint8))
    vw.release()


def _clip_folder(root, n=2, frames=6, size=40):
    """train / val x REAL / FAKE, n mp4v clips each (a nested folder in
    train/FAKE, as os.walk finds it)."""
    for s, split in enumerate(("train", "val")):
        for c, cls in enumerate(("REAL", "FAKE")):
            d = os.path.join(root, split, cls)
            os.makedirs(os.path.join(d, "sub"), exist_ok=True)
            for i in range(n):
                sub = "sub" if (split, cls, i) == ("train", "FAKE", 0) else ""
                _write_clip(os.path.join(d, sub, f"c{i}.mp4"), frames, size,
                            size + 8, 100 * s + 10 * c + i)
    return root


def test_extract_frames_matches_jax(tmp_path):
    long, short = str(tmp_path / "long.mp4"), str(tmp_path / "short.mp4")
    _write_clip(long, 11, 40, 48, 7)
    _write_clip(short, 3, 40, 48, 8)
    for path, n, size in ((long, 6, 32), (short, 6, 24), (long, 1, 16)):
        want = J_data.extract_frames(path, n, size)
        got = T_data.extract_frames(path, n, size)
        assert got.dtype == np.uint8 and got.shape == (n, size, size, 3)
        np.testing.assert_array_equal(got, want)
    got = T_data.extract_frames(short, 6, 24)
    # 3 frames for 6: linspace indices 0 0 0 1 1 2, each a seek and a read
    assert np.array_equal(got[0], got[2]) and not np.array_equal(got[2],
                                                                 got[3])
    # a clip cv2 cannot read (its index cut off, a missing file) is all
    # black frames, as in JAX
    cut = str(tmp_path / "cut.mp4")
    with open(long, "rb") as f:
        data = f.read()
    with open(cut, "wb") as f:
        f.write(data[:len(data) // 2])
    for path in (cut, str(tmp_path / "none.mp4")):
        got = T_data.extract_frames(path, 2, 8)
        assert got.shape == (2, 8, 8, 3) and not got.any()
        np.testing.assert_array_equal(got, J_data.extract_frames(path, 2, 8))


def test_folder_video_dataset_matches_jax(tmp_path):
    root = _clip_folder(str(tmp_path))
    for split in ("train", "val"):
        jd = J_data.FolderVideoDataset(root, split, 3, 16)
        td = T_data.FolderVideoDataset(root, split, 3, 16)
        assert td.samples == jd.samples and len(td) == 4
        for kw in ({}, {"shuffle": True, "seed": 5}):
            for a, b in zip(td.batches(3, **kw), jd.batches(3, **kw)):
                np.testing.assert_array_equal(a["frames"], b["frames"])
                np.testing.assert_array_equal(a["labels"], b["labels"])
                assert a["paths"] == b["paths"]
    with pytest.raises(FileNotFoundError):
        T_data.FolderVideoDataset(str(tmp_path / "train" / "REAL"))


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def carried():
    jcfg = J_CONFIGS["test-32"]
    return (numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg), 8),
            _head_tree(9))


def _batches():
    rng = np.random.default_rng(10)
    return [{"frames": rng.uniform(-1, 1, (B, T, 32, 32, 3)).astype(
        np.float32), "labels": np.float32([i % 2, 1])} for i in range(STEPS)]


def _jax_steps(backbone, head, batches):
    jcfg = J_CONFIGS["test-32"]
    opt = J_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    init_fn, step = J_video.make_video_train_step(jcfg, opt, J_F32, POS_W)
    state = init_fn(jax.tree.map(jnp.asarray, head))
    jb = jax.tree.map(jnp.asarray, backbone)
    b0 = jax.tree.map(jnp.asarray, batches[0])
    compiled = jax.jit(step).lower(state, jb, b0, None).compile(
        compiler_options=NO_FOLDING)
    metrics = []
    for b in batches:
        state, m = compiled(state, jb, jax.tree.map(jnp.asarray, b), None)
        metrics.append({k: float(v) for k, v in m.items()})
    feats = jax.jit(lambda p, x: J_video.video_frame_features(
        p, x, jcfg, J_F32)).lower(jb, b0["frames"]).compile(
            compiler_options=NO_FOLDING)(jb, b0["frames"])
    return state, metrics, np.asarray(feats)


def test_video_train_step_matches_jax(carried):
    backbone, head = carried
    batches = _batches()
    j_state, j_metrics, j_feats = _jax_steps(backbone, head, batches)

    cfg = CONFIGS["test-32"]
    bb = params_from_numpy(backbone, "cpu")
    for leaf in tensor_leaves(bb):           # would collect any gradient
        leaf.requires_grad_(True)
    feats = T_video.video_frame_features(bb, torch.from_numpy(
        batches[0]["frames"]), cfg, F32_POLICY)
    np.testing.assert_allclose(_np(feats), j_feats, atol=2e-3, rtol=0)
    opt = T_steps.make_optimizer(LR, warmup_steps=1, total_steps=10)
    init_fn, step = T_video.make_video_train_step(cfg, opt, F32_POLICY,
                                                  POS_W)
    state = init_fn(video_head_from_numpy(head, "cpu"))
    for b, jm in zip(batches, j_metrics):
        state, m = step(state, bb, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert abs(float(m["loss"]) - jm["loss"]) <= 1e-5
        assert abs(float(m["acc"]) - jm["acc"]) <= 1e-5
    assert state.step == STEPS
    for leaf in tensor_leaves(bb):
        assert leaf.grad is None             # the tower ran without autograd
    got = tensor_leaves(state.head)
    want = jax.tree.leaves(j_state.head)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=1e-5, rtol=0)
    ev = T_video.make_video_eval_step(cfg, F32_POLICY)
    z = ev(state.head, bb, torch.from_numpy(batches[0]["frames"]))
    assert z.shape == (B,) and z.grad_fn is None


# ------------------------------------------------------------- the CLI

def test_cli_main_float_and_int8(tmp_path):
    root = _clip_folder(str(tmp_path / "clips"), frames=4, size=32)
    for flags in ([], ["--int8_backbone"]):
        save = str(tmp_path / f"run{len(flags)}")
        T_cli.main(["--data_dir", root, "--save_dir", save, "--model_size",
                    "test-32", "--num_frames", "2", "--batch_size", "2",
                    "--epochs", "1", "--device", "cpu"] + flags)
        rows = open(os.path.join(save, "training_log.csv")).read()
        assert len(rows.strip().splitlines()) == 2 and "val_loss" in rows
        best = restore_checkpoint(os.path.join(save, "best"))
        assert {"head", "opt_state", "step", "epoch"} <= set(best)
        assert best["step"] == 2 and best["head"]["fc3"]["w"].shape == (16, 1)


def test_cli_analysis_exits_before_training(tmp_path, monkeypatch):
    """--analysis no longer exits before training: main trains, then
    writes learning_analysis.json (the keys and values of JAX's battery on
    the same evidence), the dashboard and the figure suite, and its
    activation statistics equal JAX's on the same head and features."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen[name] = (a, k, out)
            return out
        monkeypatch.setattr(T_an, name, wrapped)

    for name in ("video_head_activations", "activation_statistics",
                 "learning_memorization_metrics"):
        spy(name, getattr(T_an, name))
    root = _clip_folder(str(tmp_path / "clips"), frames=4, size=32)
    save = str(tmp_path / "run")
    history = T_cli.main(["--data_dir", root, "--save_dir", save,
                          "--model_size", "test-32", "--num_frames", "2",
                          "--batch_size", "2", "--epochs", "1", "--analysis",
                          "--device", "cpu"])
    assert len(history) == 1 and os.path.exists(
        os.path.join(save, "best"))
    (head, feats), _, acts = seen["video_head_activations"]
    assert feats.dtype == torch.bfloat16 and feats.shape == (2, 2, 64)
    j_head = jax.tree.map(lambda t: t.detach().numpy(), head)
    j_acts = J_an.video_head_activations(
        j_head, jnp.asarray(feats.float().numpy(), jnp.bfloat16))
    want = J_an.activation_statistics(j_acts)
    got = seen["activation_statistics"][2]
    for k in ("activation_diversity", "activation_sparsity",
              "feature_learning_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=1e-6)
    (hist,), kw, metrics = seen["learning_memorization_metrics"]
    j_metrics = J_an.learning_memorization_metrics(hist, **kw)
    with open(os.path.join(save, "learning_analysis.json")) as f:
        written = json.load(f)
    assert set(written) == set(j_metrics)
    for k, v in j_metrics.items():
        if isinstance(v, str):
            assert written[k] == v
        else:
            np.testing.assert_allclose(written[k], v, rtol=1e-12)
    assert os.path.getsize(os.path.join(
        save, "learning_vs_memorization.png")) > 0
    assert sorted(os.listdir(os.path.join(save, "figures"))) == sorted(
        os.path.basename(p) for p in ("calibration_curve.png",
                                      "class_comparison.png",
                                      "combined_curves.png",
                                      "confusion_matrix.png",
                                      "confusion_matrix_normalized.png",
                                      "metrics_comparison.png",
                                      "precision_recall_curve.png",
                                      "probability_distribution.png",
                                      "roc_curve.png",
                                      "threshold_analysis.png"))
    assert T_cli.parse_args(["--data_dir", "x"]).device == "cuda"


def test_cli_analysis_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed (the card's machine) --analysis
    writes learning_analysis.json, says so and draws nothing."""
    from tpudf_torch.eval import plots as T_plots
    monkeypatch.setattr(T_plots, "figures_available", lambda: False)
    root = _clip_folder(str(tmp_path / "clips"), frames=4, size=32)
    save = str(tmp_path / "run")
    T_cli.main(["--data_dir", root, "--save_dir", save, "--model_size",
                "test-32", "--num_frames", "2", "--batch_size", "2",
                "--epochs", "1", "--analysis", "--device", "cpu"])
    assert "matplotlib is not installed" in capsys.readouterr().out
    with open(os.path.join(save, "learning_analysis.json")) as f:
        assert set(json.load(f)) == set(J_an.learning_memorization_metrics(
            [{"train_loss": 1.0, "val_loss": 1.0}], np.ones(2), np.ones(2),
            {"activation_diversity": 1.0, "activation_sparsity": 0.0,
             "feature_learning_score": 1.0}))
    assert not os.path.exists(os.path.join(save, "figures"))
    assert not os.path.exists(os.path.join(save,
                                           "learning_vs_memorization.png"))
