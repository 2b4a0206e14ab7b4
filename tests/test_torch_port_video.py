"""The port's video report against the golden corpus' `float.video`, and
its temporal battery against JAX's, on the CPU.

The engine is the golden test's float engine (tests/test_report_golden.py:
`jax.random.key(11)` through JAX's init, then `params_from_numpy`); the
face checkpoints are pinned to the packaged assets (the same bytes in both
packages) with monkeypatch, so a user cache moves neither side.

  `_video_temporal_for` (the packed battery: the signals of
  compute_temporal_signals on the frames resized to 256 px, the dense-LK
  flow family, id_drift from the tower's embeddings, render_regularity)
  against JAX's jitted graph, on two 6-frame 64 px clips (the golden
  clip and a static one): the same names; each
  signal within the goldens' atol 2e-4 + rtol 2e-3, parallax NaN on the
  static clip in both; id_drift by the float engine's rule 1e-2 (the
  tower computes in bf16, tests/test_torch_port_report.py). JAX's graph
  is JAX's own `_video_temporal_for`, compiled once for both clips
  without XLA's constant-folding pass: with it, the CPU compiler folds
  the dense flow's and the histograms' constants for minutes (about 270
  s cold); without it, the same function compiles in seconds.

  `predict_video` on the golden clip against `float.video` (every key,
  no key missing or new), by tests/test_torch_port_report.py's rules:
  strings, ints and bools equal (labels, chosen_frame, sora_flag, the
  aggregation's counts); the battery's signals, the face trio and
  temporal_consistency_score by the goldens' rule; the floats the tower
  reaches by the engine rule 1e-2 (frame_probs, video_prob, the
  aggregation's video_prob and video_std, id_drift, sora_likelihood);
  chosen_frame_report as an image entry of the float engine.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_report_golden import GOLDEN_PATH, _images, _jsonable
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_report import _compare
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.serve import face as t_face
from tpudf_torch.serve.engine import DetectEngine
from tpudf_torch.serve.report import _video_temporal_for, predict_video

GOLDEN = dict(atol=2e-4, rtol=2e-3)
NO_FOLDING = {"xla_disable_hlo_passes": "constant_folding"}
ENGINE_ATOL = 1e-2
TOWER_SIGNALS = ("id_drift",)
TOWER_KEYS = ("frame_probs", "video_prob", "sora_likelihood")
TOWER_AGG = ("video_prob", "video_std")
ASSETS = os.path.join(os.path.dirname(t_face.__file__), os.pardir, "assets")

with open(GOLDEN_PATH) as f:
    WANT = json.load(f)["float.video"]


def _clips():
    """name → (6, 64, 64, 3) uint8: the golden clip (rolled 2 px a frame)
    and a static one."""
    img = _images(1, 64)
    return {"golden": np.stack([np.roll(img[0], 2 * t, axis=1)
                                for t in range(6)]),
            "static": np.repeat(img, 6, axis=0)}


@pytest.fixture(scope="module")
def engines():
    """(JAX's float engine, the port's) with the golden test's weights."""
    from tpudf.calib.coral import CoralCutpoints
    from tpudf.models.freq_mlp import init_freq_mlp
    from tpudf.models.fusion import init_fusion_linear
    from tpudf.models.heads import init_binary_head
    from tpudf.models.siglip import CONFIGS as J_CONFIGS
    from tpudf.models.siglip import init_siglip
    from tpudf.serve.engine import DetectEngine as JEngine

    cfg = J_CONFIGS["test-64"]
    ks = jax.random.split(jax.random.key(11), 4)
    tree = {"backbone": init_siglip(ks[0], cfg),
            "head": init_binary_head(ks[1], cfg.width),
            "freq": init_freq_mlp(ks[2]), "fusion": init_fusion_linear(ks[3])}
    cuts = CoralCutpoints.default()
    j_eng = JEngine(cfg=cfg, cuts=cuts, **tree)
    t_eng = DetectEngine(cfg=CONFIGS["test-64"], **params_from_numpy(
        {**jax.tree.map(np.asarray, tree), "cuts": cuts}, "cpu"))
    return j_eng, t_eng


@pytest.fixture(scope="module")
def batteries(engines, video_report):
    """clip → (JAX's names and packed values, the port's). The port's
    battery of the golden clip is the one its video report packed (no NaN
    there to drop)."""
    from tpudf.serve.report import _video_temporal_for as j_for
    j_eng, t_eng = engines
    out, compiled = {}, None
    for name, clip in _clips().items():
        fn, names = j_for(j_eng, clip, with_embeds=True)
        if compiled is None:           # both clips have the same shape
            compiled = fn.lower(j_eng.backbone, jnp.asarray(clip)).compile(
                compiler_options=NO_FOLDING)
        want = np.asarray(compiled(j_eng.backbone, jnp.asarray(clip)))
        tfn, tnames = _video_temporal_for(t_eng, clip, with_embeds=True)
        if name == "golden":
            sig = video_report["temporal_signals"]
            got = np.asarray([sig[k] for k in tnames])
        else:
            got = tfn(torch.from_numpy(clip)).numpy()
        out[name] = ((names, want), (tnames, got))
    return out


BATTERY_NAMES = sorted(WANT["temporal_signals"])
BATTERY_NAMES = [k for k in BATTERY_NAMES if not k.startswith("face_")]


def test_battery_names_match_jax(batteries):
    for (names, _), (tnames, _) in batteries.values():
        assert tuple(tnames) == tuple(names)
        assert sorted(tnames) == BATTERY_NAMES


@pytest.mark.parametrize("clip", sorted(_clips()))
@pytest.mark.parametrize("signal", BATTERY_NAMES)
def test_battery_matches_jax(batteries, clip, signal):
    (names, want), (tnames, got) = batteries[clip]
    w, g = float(want[names.index(signal)]), float(got[tnames.index(signal)])
    if signal == "parallax_err" and clip == "static":
        assert math.isnan(w) and math.isnan(g)      # gated: no pair moves
        return
    atol = ENGINE_ATOL if signal in TOWER_SIGNALS else (
        GOLDEN["atol"] + GOLDEN["rtol"] * abs(w))
    assert abs(g - w) <= atol, (clip, signal, g, w)


def test_battery_sees_the_clips(batteries):
    """The clips exercise the battery: the moving one has flow and PRNU
    drift, the static one neither."""
    val = {c: dict(zip(t[0], t[1])) for c, (_, t) in batteries.items()}
    assert val["golden"]["flow_fb_inconsistency"] > 0.1
    assert val["golden"]["prnu_drift"] > 0.1
    assert val["static"]["prnu_drift"] == 0.0
    assert val["static"]["flow_fb_inconsistency"] < 1e-3


@pytest.fixture(scope="module")
def video_report(engines):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUDF_FACE_CKPT",
                  os.path.join(ASSETS, "face_landmarks.npz"))
        mp.setenv("TPUDF_FACE_EMBED_CKPT",
                  os.path.join(ASSETS, "face_embed.npz"))
        for k in ("TPUDF_FACE_ID_EMBED", "TPUDF_FACE_TRAIN"):
            mp.delenv(k, raising=False)
        return _jsonable(predict_video(engines[1], _clips()["golden"]))


def _close(g, w, atol=None):
    lim = GOLDEN["atol"] + GOLDEN["rtol"] * abs(w) if atol is None else atol
    return abs(g - w) <= lim


def test_video_report_has_the_goldens_keys(video_report):
    assert set(video_report) == set(WANT)
    assert set(video_report["temporal_signals"]) == set(
        WANT["temporal_signals"])
    assert set(video_report["aggregation"]) == set(WANT["aggregation"])


@pytest.mark.parametrize("key", ["video_label", "chosen_frame", "sora_flag",
                                 "frame_labels"])
def test_video_decisions_match_golden(video_report, key):
    assert video_report[key] == WANT[key]
    assert type(video_report[key]) is type(WANT[key])


@pytest.mark.parametrize("signal", sorted(WANT["temporal_signals"]))
def test_video_signal_matches_golden(video_report, signal):
    g, w = video_report["temporal_signals"][signal], WANT[
        "temporal_signals"][signal]
    atol = ENGINE_ATOL if signal in TOWER_SIGNALS else None
    assert _close(g, w, atol), (signal, g, w)


@pytest.mark.parametrize("key", TOWER_KEYS + ("temporal_consistency_score",
                                              "aggregation"))
def test_video_floats_match_golden(video_report, key):
    g, w = video_report[key], WANT[key]
    if key == "aggregation":
        for k, wv in w.items():
            if k in TOWER_AGG:
                assert _close(g[k], wv, ENGINE_ATOL), k
            else:
                assert g[k] == wv and type(g[k]) is type(wv), k
    elif key == "frame_probs":
        assert len(g) == len(w)
        assert all(_close(a, b, ENGINE_ATOL) for a, b in zip(g, w)), (g, w)
    else:
        atol = ENGINE_ATOL if key in TOWER_KEYS else None
        assert _close(g, w, atol), (key, g, w)


def test_chosen_frame_report_matches_golden(video_report):
    errors = []
    _compare("float", "float.video.chosen_frame_report",
             video_report["chosen_frame_report"],
             WANT["chosen_frame_report"], errors)
    assert not errors, "\n".join(errors[:40])
