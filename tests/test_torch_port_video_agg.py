"""The video report's host-side parts against the JAX package's, on the
CPU: no JAX graph (the modules are numpy and cv2 on both sides).

  aggregate_video_probs   every agg_mode x strictness (and an unknown one),
       with and without frame weights, both override flags, no frames:
       equal (the same numpy, so the same floats)
  temporal_frame_weights  equal, empty and all-zero motion included
  aggregate_sora          seeded signal sets with None / NaN / missing
       entries and values on the hit thresholds: equal
  the SORA thresholds, odds tiers, _odds / _from_odds   equal
  host_flow_signals       the cv2 Farneback / KLT / RANSAC / ORB battery on
       the golden clip and on a clip with a scene cut: equal; {} under 3
       frames
"""

import math

import numpy as np
import pytest

from tests.test_report_golden import _images
from tpudf.fuse import temporal as j_temporal
from tpudf.fuse import video_agg as j_agg
from tpudf.serve import report as j_report
from tpudf_torch.fuse import temporal as t_temporal
from tpudf_torch.fuse import video_agg as t_agg
from tpudf_torch.serve import report as t_report


def _frames(seed):
    """(9 probs, 9 labels, 9 weights) of one seeded clip."""
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.2, 0.9, 9).astype(np.float32)
    labels = list(rng.choice(["REAL", "TAMPERED", "FAKE", "INCONCLUSIVE",
                              "UNCERTAIN", "other"], 9))
    return probs, labels, rng.uniform(0.0, 2.0, 9)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("strictness", ["conservative", "balanced",
                                        "aggressive", "unknown"])
@pytest.mark.parametrize("agg_mode", ["topk_mean", "median", "max"])
def test_aggregate_video_probs_matches_jax(agg_mode, strictness, weighted):
    for seed in range(4):
        probs, labels, w = _frames(seed)
        if seed == 3:                         # no frame above 0.75
            probs = np.clip(probs, 0.0, 0.7)
        kw = dict(agg_mode=agg_mode, strictness=strictness,
                  weights=w if weighted else None)
        assert t_agg.aggregate_video_probs(probs, labels, **kw) == \
            j_agg.aggregate_video_probs(probs, labels, **kw)


@pytest.mark.parametrize("flags", [dict(disable_tampered=True),
                                   dict(disable_inconclusive=True),
                                   dict(topk_frac=0.9, min_agree=4)])
def test_aggregate_video_probs_options_match_jax(flags):
    for seed in range(6):
        probs, labels, _ = _frames(10 + seed)
        probs = np.clip(probs, 0.0, 0.7)
        assert t_agg.aggregate_video_probs(probs, labels, **flags) == \
            j_agg.aggregate_video_probs(probs, labels, **flags)
    assert t_agg.aggregate_video_probs([]) == j_agg.aggregate_video_probs([])


@pytest.mark.parametrize("diffs", [[], [0.0, 0.0, 0.0], [3.0, 1.0, 0.5, 7.0],
                                   list(np.linspace(0, 1, 12))])
def test_temporal_frame_weights_matches_jax(diffs):
    np.testing.assert_array_equal(t_agg.temporal_frame_weights(diffs),
                                  j_agg.temporal_frame_weights(diffs))


def _signals(seed):
    """A seeded signal dict over every weighted name: some on a hit
    threshold, some None, NaN or missing."""
    rng = np.random.default_rng(seed)
    names = sorted({k for k, _ in t_temporal.SORA_WEIGHTS}
                   | {k for k, _ in t_temporal.CONSISTENCY_WEIGHTS})
    out = {}
    for k in names:
        r = rng.random()
        if r < 0.1:
            continue
        out[k] = (None if r < 0.15 else math.nan if r < 0.2 else
                  float(rng.choice([0.5, 0.55, 0.6])) if r < 0.35 else
                  float(rng.random()))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_aggregate_sora_matches_jax(seed):
    sig = _signals(seed)
    assert t_temporal.aggregate_sora(sig) == j_temporal.aggregate_sora(sig)


def test_sora_constants_match_jax():
    assert t_temporal.SORA_WEIGHTS == j_temporal.SORA_WEIGHTS
    assert t_temporal.CONSISTENCY_WEIGHTS == j_temporal.CONSISTENCY_WEIGHTS
    assert t_report.SORA_TAMPERED_THRESH == j_report.SORA_TAMPERED_THRESH
    assert t_report.SORA_FAKE_THRESH == j_report.SORA_FAKE_THRESH
    assert t_report.SORA_ODDS == j_report.SORA_ODDS
    for p in (0.0, 1e-7, 0.3, 0.5, 0.97, 1.0):
        assert t_report._odds(p) == j_report._odds(p)
        assert t_report._from_odds(t_report._odds(p)) == \
            j_report._from_odds(j_report._odds(p))


def _host_clips():
    img = _images(3, 64)
    golden = np.stack([np.roll(img[0], 2 * t, axis=1) for t in range(6)])
    cut = np.stack([np.roll(img[0] if t < 3 else img[2], 3 * t, axis=0)
                    for t in range(6)])
    return {"golden": golden, "cut": cut}


@pytest.mark.parametrize("clip", sorted(_host_clips()))
def test_host_flow_signals_matches_jax(clip):
    pytest.importorskip("cv2")
    frames = list(_host_clips()[clip])
    got = t_temporal.host_flow_signals(frames)
    assert got == j_temporal.host_flow_signals(frames)
    assert {"flow_fb_inconsistency", "flow_reprojection"} <= set(got)
    assert t_temporal.host_flow_signals(frames[:2]) == {}
