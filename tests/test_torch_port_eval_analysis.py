"""Parity of the port's analysis and figure modules with the JAX package,
on the CPU (tpudf_torch/eval/analysis.py, eval/plots.py, eval/visualize.py
and the binary head's `acts` hook, tpudf_torch/models/heads.py).

The same seeded numpy inputs go to both sides. Tolerances:
  the host numpy functions (overfitting score, monitor, temporal
       position, probes, the metric battery, activation statistics,
       roc_points / pr_points, visualize's arrays and table text)
       equal: they are the same numpy code
  head activations (v5 and video heads, test widths, JAX's init trees
       carried as numpy) within 1e-5 (f32 products on both sides)
  mc_dropout_uncertainty with a forward that ignores its generator:
       mean, std and entropy within 1e-12 of JAX's (float64 host math
       on the same logits); with the v5 head, pass i equals the head run
       with torch.Generator().manual_seed(seed * 1000 + i) exactly
  render_inference_report / the dashboard / the curves: the JAX
       package's file names and figure keys
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.eval import analysis as J_an
from tpudf.eval import plots as J_plots
from tpudf.eval import visualize as J_vis
from tpudf.models import heads as J_heads
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.eval import analysis as T_an
from tpudf_torch.eval import plots as T_plots
from tpudf_torch.eval import visualize as T_vis
from tpudf_torch.models import heads as T_heads

DIM = 64


def _history(kind, n):
    if kind == "healthy":
        return [{"train_loss": 1.0 / (e + 1), "val_loss": 1.1 / (e + 1),
                 "train_acc": 0.5 + 0.04 * e, "val_f1": 0.5 + 0.035 * e}
                for e in range(n)]
    return [{"train_loss": 1.0 / (e + 1), "val_loss": 0.5 + 0.1 * e,
             "train_acc": 0.5 + 0.05 * e, "val_f1": 0.55} for e in range(n)]


def _same(a, b):
    """Equal nested results (dicts, lists, floats, arrays, strings)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, float, np.floating)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("kind,n", [("healthy", 10), ("overfit", 10),
                                    ("overfit", 2)])
def test_overfitting_and_monitor_match_jax(kind, n, tmp_path):
    h = _history(kind, n)
    _same(T_an.overfitting_score(h), J_an.overfitting_score(h))
    tm, jm = T_an.TrainingMonitor(patience=2), J_an.TrainingMonitor(
        patience=2)
    for row in h:
        _same(tm.update(row), jm.update(row))


def test_temporal_position_and_probes_match_jax():
    rng = np.random.default_rng(0)
    p, y = rng.random((12, 6)), (np.arange(12) % 2).astype(np.float64)
    _same(T_an.temporal_position_analysis(p, y),
          J_an.temporal_position_analysis(p, y))

    def fit(idx):                 # a deterministic "val AUC" of indices
        return 0.5 + 0.4 * len(idx) / 40 + 0.001 * float(np.sum(idx) % 7)
    _same(T_an.data_efficiency_probe(fit, 40, seed=3),
          J_an.data_efficiency_probe(fit, 40, seed=3))
    labels = (np.arange(30) % 2).astype(np.float64)
    _same(T_an.label_shuffle_probe(lambda l: float(l[:5].mean()), labels, 2),
          J_an.label_shuffle_probe(lambda l: float(l[:5].mean()), labels, 2))


@pytest.mark.parametrize("n", [2, 8])
def test_learning_memorization_metrics_match_jax(n):
    rng = np.random.default_rng(n)
    h = [{"train_loss": float(1 / (e + 1)), "val_loss": float(
        1.2 / (e + 1) + 0.05 * rng.random())} for e in range(n)]
    tp, vp = rng.random(40), rng.random(30)
    acts = {"fc1": rng.standard_normal((4, 8)).clip(0),
            "fc2": rng.standard_normal((4, 3))}
    stats = T_an.activation_statistics(acts)
    _same(stats, J_an.activation_statistics(acts))
    eff = {"curve": [{"auc": 0.6}, {"auc": 0.7}], "verdict": "learning"}
    _same(T_an.learning_memorization_metrics(h, tp, vp, stats, eff),
          J_an.learning_memorization_metrics(h, tp, vp, stats, eff))


def _head(init, seed):
    tree = numpy_params(lambda: init(jax.random.key(0), DIM), seed)
    return tree, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("head", ["binary", "video"])
def test_head_activations_match_jax(head):
    rng = np.random.default_rng(5)
    if head == "binary":
        tree, tp = _head(J_heads.init_binary_head, 1)
        f = rng.standard_normal((6, DIM)).astype(np.float32)
        want = J_an.binary_head_activations(tree, f)
        got = T_an.binary_head_activations(tp, f)
        assert set(got) == {"se_fc1", "se_fc2", "fc1", "fc2", "fc3"}
    else:
        tree, tp = _head(J_heads.init_video_head, 2)
        f = rng.standard_normal((3, 4, DIM)).astype(np.float32)
        want = J_an.video_head_activations(tree, f)
        got = T_an.video_head_activations(tp, f)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    ts, js = (T_an.activation_statistics(got),
              J_an.activation_statistics(want))
    for k in ("activation_diversity", "activation_sparsity",
              "feature_learning_score"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-7)


def test_mc_dropout_without_draws_matches_jax():
    z = np.random.default_rng(6).standard_normal(9).astype(np.float32)
    got = T_an.mc_dropout_uncertainty(lambda x, g: torch.from_numpy(z),
                                      torch.zeros(1), n_passes=4, seed=2)
    want = J_an.mc_dropout_uncertainty(lambda x, k: z, None, n_passes=4,
                                       seed=2)
    assert got["n_passes"] == want["n_passes"] == 4
    for k in ("mean_prob", "std_prob", "entropy"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_mc_dropout_pass_i_draws_seed_times_1000_plus_i():
    _, tp = _head(J_heads.init_binary_head, 7)
    f = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (5, DIM)).astype(np.float32))
    seen = []

    def fwd(x, gen):
        z = T_heads.apply_binary_head(tp, x, generator=gen)
        seen.append(z)
        return z

    out = T_an.mc_dropout_uncertainty(fwd, f, n_passes=3, seed=4)
    for i, z in enumerate(seen):
        ref = T_heads.apply_binary_head(
            tp, f, generator=torch.Generator().manual_seed(4 * 1000 + i))
        torch.testing.assert_close(z, ref, rtol=0, atol=0)
    assert not torch.equal(seen[0], seen[1])        # the passes differ
    assert out["std_prob"].max() > 0


@pytest.mark.parametrize("ties", [False, True])
def test_roc_pr_points_match_jax(ties):
    rng = np.random.default_rng(8)
    y = (rng.random(60) > 0.4).astype(np.float64)
    s = rng.random(60)
    if ties:
        s = np.round(s * 4) / 4
    for fn in ("roc_points", "pr_points"):
        for a, b in zip(getattr(T_plots, fn)(y, s),
                        getattr(J_plots, fn)(y, s)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        T_plots._tie_boundaries(np.sort(s)), J_plots._tie_boundaries(
            np.sort(s)))


def test_render_inference_report_writes_jax_names(tmp_path):
    rng = np.random.default_rng(9)
    y = (np.arange(40) % 2).astype(np.float64)
    p = np.clip(y * 0.3 + rng.random(40) * 0.7, 0, 1)
    methods = {"base": {"accuracy": 0.7, "f1": 0.6},
               "tta": {"accuracy": 0.75, "f1": 0.65}}
    got = T_plots.render_inference_report(y, p, str(tmp_path / "t"),
                                          probs_cal=p ** 1.1,
                                          methods=methods)
    want = J_plots.render_inference_report(y, p, str(tmp_path / "j"),
                                           probs_cal=p ** 1.1,
                                           methods=methods)
    assert set(got) == set(want)
    assert ({k: os.path.basename(v) for k, v in got.items()}
            == {k: os.path.basename(v) for k, v in want.items()})
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    assert all(os.path.getsize(v) > 0 for v in got.values())


def test_dashboard_and_curves_render(tmp_path):
    h = [{"train_loss": 1 / (e + 1), "val_loss": 1.1 / (e + 1) + 0.01 * e,
          "val_f1": 0.5 + 0.03 * e} for e in range(8)]
    m = T_an.learning_memorization_metrics(
        h, np.linspace(0.1, 0.9, 20), np.linspace(0.2, 0.8, 20),
        T_an.activation_statistics({"fc1": np.ones((2, 3))}))
    path = T_an.plot_memorization_dashboard(
        m, h, str(tmp_path), n_params={"backbone": 1000, "head": 10})
    assert os.path.basename(path) == "learning_vs_memorization.png"
    assert os.path.getsize(path) > 0
    assert os.path.basename(T_an.plot_training_curves(
        h, str(tmp_path))) == "training_curves.png"
    assert os.path.basename(T_an.plot_confusion_matrix(
        [[3, 1], [0, 4]], ("REAL", "FAKE"), str(tmp_path))) == "confusion.png"


def test_visualize_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (12, 10, 3), np.uint8)
    pred, true = rng.random((12, 10)), rng.random((12, 10))
    for tm in (None, true):
        np.testing.assert_array_equal(T_vis.mask_overlay(img, pred, tm),
                                      J_vis.mask_overlay(img, pred, tm))
    ims = [rng.integers(0, 256, (6, 5, 3), np.uint8) for _ in range(5)]
    np.testing.assert_array_equal(T_vis.collage(ims, cols=3),
                                  J_vis.collage(ims, cols=3))
    assert T_vis.collage([]) is None and J_vis.collage([]) is None
    ious, yt, yp = rng.random(50), rng.integers(0, 2, 50), rng.integers(0, 2,
                                                                        50)
    _same(T_vis.iou_bucket_matrix(ious, yt, yp),
          J_vis.iou_bucket_matrix(ious, yt, yp))
    rows = {"run_a": {"auc": 0.9, "f1": 0.8, "note": "x"},
            "run_b": {"auc": 0.85}}
    assert T_vis.results_table(rows, str(tmp_path / "t")) == \
        J_vis.results_table(rows, str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == ["results.csv",
                                                  "results.tex"]
    T_vis.save_webp(img, str(tmp_path / "o.webp"))
    from PIL import Image
    assert Image.open(tmp_path / "o.webp").size == (10, 12)
