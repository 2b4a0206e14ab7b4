"""Parity of the port's fusion modules with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; every
signal set also holds values placed on the thresholds the rules compare
against.
  decision, verdict, AppConfig.from_env   equal (host numpy copies; the
       env under monkeypatch, clipped and unordered values included)
  hierarchical final_probability, bayes_combine   f32 atol 1e-6 + rtol 1e-5
       (the same math in another library); the FAKE / REAL labels equal
  bayesian_fuse_v2 (no calibration, isotonic, logistic; missing and NaN
       cues), dirichlet_fuse (missing cues, none present)   the same
  isotonic_fit, fit_bayes_calibration, the rest of eval/stats   equal
  TreeEnsemble   margins f32 atol 1e-6 (sums of the same leaves), the
       probabilities equal bit for bit off the thresholds; the rows placed
       on a node's threshold take the same branch (`xv < t` on the same
       f32 values); from a train/gbdt.py fit and from a small hand-written
       XGBoost JSON with a Platt file
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.core import config as J_config
from tpudf.eval import stats as J_stats
from tpudf.fuse import bayesian as J_bayes
from tpudf.fuse import decision as J_dec
from tpudf.fuse import hierarchical as J_hier
from tpudf.fuse import verdict as J_verdict
from tpudf.models.fusion import TreeEnsemble as JTrees
from tpudf.train import gbdt as J_gbdt
from tpudf_torch.core import config as T_config
from tpudf_torch.eval import stats as T_stats
from tpudf_torch.fuse import bayesian as T_bayes
from tpudf_torch.fuse import decision as T_dec
from tpudf_torch.fuse import hierarchical as T_hier
from tpudf_torch.fuse import verdict as T_verdict
from tpudf_torch.models.fusion import TreeEnsemble as TTrees
from tpudf_torch.train import gbdt as T_gbdt

F32 = dict(atol=1e-6, rtol=1e-5)

# every threshold the cascade, the verdict and the fusers compare against
THRESHOLDS = (0.0, 0.002, 0.04, 0.05, 0.10, 0.15, 0.18, 0.20, 0.25, 0.30,
              0.35, 0.40, 0.45, 0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80,
              0.85, 0.90, 1.0)
CASCADE_KEYS = ("p_final", "p_global", "patch_mean", "patch_spread",
                "head_delta", "forensic", "cfa_fake", "perlin", "grain",
                "fft_conf", "real_prior_v3", "jpeg_resid_v3", "esrgan",
                "sat_peak", "jpeg_q", "exposure", "hc", "texture_noise",
                "image_gen", "prnu_scaled", "visual_prob", "freq_prob",
                "render", "face_p_fake", "face_retouch")


def _value(rng):
    """A threshold, a uniform draw, or (rarely) None / a NaN / out of
    range."""
    u = rng.random()
    if u < 0.45:
        return float(rng.choice(THRESHOLDS))
    if u < 0.92:
        return float(rng.random())
    return [None, float("nan"), 1.3, -0.2][int(rng.integers(4))]


def _signals(seed, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {k: _value(rng) for k in CASCADE_KEYS}
        s["risk_idx"] = int(rng.integers(0, 5))
        s["entropy"] = float(rng.choice([0.5, 1.0, 1.2, rng.random() * 2]))
        for k in ("p_final", "forensic", "patch_mean", "head_delta"):
            if s[k] is None or s[k] != s[k]:
                s[k] = 0.5                  # the report always sets these
        out.append(s)
    return out


def _same(a, b):
    """Equal, with NaN equal to NaN (None stays None)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("cfg", [
    {}, {"disable_tampered": True}, {"disable_inconclusive": True},
    {"use_stabilized_fusion": True, "final_fake_thresh": 0.65,
     "final_real_thresh": 0.35}])
def test_decision_matches_jax(cfg):
    jcfg, tcfg = J_dec.DecisionConfig(**cfg), T_dec.DecisionConfig(**cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for s in _signals(len(cfg)):
        assert _same(J_dec.full_label_cascade(s, jcfg),
                     T_dec.full_label_cascade(s, tcfg)), s
        args = [s[k] for k in ("p_final", "real_prior_v3", "forensic",
                               "cfa_fake", "perlin", "grain", "fft_conf",
                               "patch_mean", "patch_spread")]
        assert J_dec.classify_rbr(*args) == T_dec.classify_rbr(*args)
        args3 = args + [s["jpeg_q"], s["hc"], s["texture_noise"]]
        assert (J_dec.classify_three_way(*args3)
                == T_dec.classify_three_way(*args3))
        sf = [s[k] if s[k] is not None and s[k] == s[k] else 0.5
              for k in ("p_final", "p_global", "visual_prob", "freq_prob",
                        "patch_mean", "forensic")]
        sf[4] = max(sf[4], sf[5])          # max_patch >= patch_mean
        assert J_dec.stabilized_fusion(*sf) == T_dec.stabilized_fusion(*sf)
        for label in ("FAKE", "REAL", "TAMPERED", "INCONCLUSIVE",
                      "UNCERTAIN", "RBR"):
            for override in (None, "REAL", "FAKE"):
                kw = dict(allow_real=s["risk_idx"] % 2 == 0,
                          override_label=override)
                assert (J_dec.finalize_label_and_risk(
                    label, s["p_final"], s["forensic"], cfg=jcfg, **kw)
                    == T_dec.finalize_label_and_risk(
                    label, s["p_final"], s["forensic"], cfg=tcfg, **kw))


def test_verdict_matches_jax():
    rng = np.random.default_rng(3)
    keys = ("bayesian_fusion_posterior", "bayesian_fusion_certainty",
            "dirichlet_uncertainty", "dirichlet_conflict", "jpeg",
            "jpeg_q_mismatch_score", "saturation_peak_score", "visual_head",
            "freq_head", "forensic_score", "cfa_fake_score", "patch_mean",
            "final_prob", "certainty")
    for i in range(400):
        r = {k: _value(rng) for k in keys}
        if i % 5 == 0:
            r["bayesian_fusion_calibrated"] = {
                k: _value(rng) for k in ("visual", "freq", "forensic",
                                         "cfa", "patch", "jpeg")}
        if i % 7 == 0:
            r["bayesian_fusion_posterior"] = None
        assert (dataclasses.asdict(J_verdict.decide_verdict(r))
                == dataclasses.asdict(T_verdict.decide_verdict(r))), r
        p, c = _value(rng), _value(rng)
        assert J_verdict.choose_band(p, c) == T_verdict.choose_band(p, c)
        if p is not None and p == p and c is not None and c == c:
            assert (J_verdict.apply_benign_jpeg_penalty(r, p, c)
                    == T_verdict.apply_benign_jpeg_penalty(r, p, c))


@pytest.mark.parametrize("env", [
    {},
    {"FINAL_REAL_THRESH": "0.3", "FINAL_FAKE_THRESH": "0.8",
     "DISABLE_TAMPERED": "1", "DETECT_USE_FUSION": "false",
     "VIDEO_STRICTNESS": "strict", "DETECT_VIDEO_STRIDE": "7"},
    {"FINAL_REAL_THRESH": "0.99", "FINAL_FAKE_THRESH": "0.01",
     "DETECT_VIDEO_WORKERS": "500", "FREQ_TEMP": "junk",
     "DETECT_MIN_SIDE": "2", "VIDEO_TOPK_FRAC": "-1",
     "DISABLE_INCONCLUSIVE": "True"},
    {"FINAL_REAL_THRESH": "0.8", "FINAL_FAKE_THRESH": "0.7"},
])
def test_app_config_from_env_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = J_config.AppConfig.from_env(), T_config.AppConfig.from_env()
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert (dataclasses.asdict(want.decision_config())
            == dataclasses.asdict(got.decision_config()))


def _probs(seed, n=64):
    """(n,) probabilities with threshold values and both ends mixed in."""
    rng = np.random.default_rng(seed)
    p = rng.random(n).astype(np.float32)
    p[:len(THRESHOLDS)] = rng.permutation(np.asarray(THRESHOLDS, np.float32))
    return p


def test_hierarchical_matches_jax():
    names = ("visual", "freq", "fusion", "coral", "forensic", "diff",
             "max_patch", "patch_mean", "head_delta", "spectral", "color",
             "face", "cfa", "real_prior")
    x = {k: _probs(i) for i, k in enumerate(names)}
    x["face"][::3] = 0.0                    # no face boost on a third
    for drop in ((), ("cfa", "real_prior"), ("max_patch", "patch_mean")):
        args = [None if k in drop else x[k] for k in names]
        want = np.asarray(J_hier.final_probability(*args))
        got = T_hier.final_probability(*[
            None if a is None else torch.from_numpy(a) for a in args])
        np.testing.assert_allclose(got.numpy(), want, **F32)
        p_j, lab_j = J_hier.final_decision(*args)
        p_t, lab_t = T_hier.final_decision(*[
            None if a is None else torch.from_numpy(a) for a in args])
        off = np.abs(np.asarray(p_j) - 0.75) > 1e-6
        assert (lab_j[off] == lab_t[off]).all()
    probs = [x["visual"], None, x["freq"]]
    np.testing.assert_allclose(
        T_hier.bayes_combine([None if p is None else torch.from_numpy(p)
                              for p in probs], [1.2, 1.0, 0.4], 0.3).numpy(),
        np.asarray(J_hier.bayes_combine(probs, [1.2, 1.0, 0.4], 0.3)), **F32)


def _cues(seed, missing=(), nan=()):
    out = {}
    for i, k in enumerate(J_bayes.FEATURES):
        if k in missing:
            out[k] = None
            continue
        p = _probs(seed * 10 + i)
        if k in nan:
            p[::4] = np.nan
        out[k] = p
    return out


def _torch_cues(cues):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in cues.items()}


def _fit(seed):
    """A calibration fit on seeded held-out cues: isotonic and logistic."""
    rng = np.random.default_rng(seed)
    held = {k: rng.random(200) for k in J_bayes.FEATURES}
    held["jpeg"][:40] = held["jpeg"][40:80]        # ties in the scores
    y = (rng.random(200) < 0.4 + 0.4 * held["visual"]).astype(np.float64)
    held["prnu"] = None
    out = {}
    for mode in ("isotonic", "logistic"):
        want = J_bayes.fit_bayes_calibration(held, y, mode=mode, iters=200)
        got = T_bayes.fit_bayes_calibration(held, y, mode=mode, iters=200)
        assert json.dumps(want.to_json()) == json.dumps(got.to_json())
        out[mode] = (want, got)
    return out


@pytest.mark.parametrize("case", ["plain", "missing", "nan", "isotonic",
                                  "logistic"])
def test_bayesian_fusion_matches_jax(case):
    missing = ("prnu", "patch") if case == "missing" else ()
    cues = _cues(1, missing=missing,
                 nan=("jpeg", "visual") if case == "nan" else ())
    want_cal = got_cal = None
    if case in ("isotonic", "logistic"):
        want_cal, got_cal = _fit(2)[case]
    want = J_bayes.bayesian_fuse_v2(cues, calibration=want_cal)
    got = T_bayes.bayesian_fuse_v2(_torch_cues(cues), calibration=got_cal)
    assert set(got) == set(want)
    for k in want:
        if k == "calibrated":
            for c in want[k]:
                np.testing.assert_allclose(got[k][c].numpy(),
                                           np.asarray(want[k][c]), **F32)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **F32)
    if got_cal is not None:                   # the same maps on a device
        moved = T_bayes.bayesian_fuse_v2(_torch_cues(cues),
                                         calibration=got_cal.to("cpu"))
        assert torch.equal(moved["posterior_fake"], got["posterior_fake"])
    for miss in ((), missing, tuple(J_bayes.FEATURES)):
        dcues = {k: None if k in miss else v for k, v in cues.items()}
        want = J_bayes.dirichlet_fuse(dcues)
        got = T_bayes.dirichlet_fuse(_torch_cues(dcues))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **F32)


def test_interp_matches_jnp():
    """`bayesian.interp` is jnp.interp: duplicate knots, both ends, knots
    hit exactly."""
    xp = np.asarray([0.1, 0.2, 0.2, 0.5, 0.5, 0.5, 0.9], np.float32)
    fp = np.asarray([0.0, 0.1, 0.3, 0.4, 0.6, 0.7, 1.0], np.float32)
    x = np.concatenate([xp, _probs(5), [-1.0, 2.0]]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = T_bayes.interp(torch.from_numpy(x), torch.from_numpy(xp),
                         torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_stats_match_jax():
    rng = np.random.default_rng(4)
    y = (rng.random(300) < 0.5).astype(int)
    p = np.clip(0.3 * y + 0.7 * rng.random(300), 0, 1)
    p[:50] = np.round(p[:50], 1)                   # ties
    for fn, args in (("isotonic_fit", (p, y)),
                     ("bootstrap_ci", (y, p)),
                     ("expected_calibration_error", (y, p)),
                     ("reliability_curve", (y, p)),
                     ("binomial_test_vs_random", (180, 300)),
                     ("mcnemar_test", (y == 1, p > 0.5))):
        want = getattr(J_stats, fn)(*args)
        got = getattr(T_stats, fn)(*args)
        np.testing.assert_equal(got, want, err_msg=fn)
    xf, yf = J_stats.isotonic_fit(p, y)
    np.testing.assert_equal(T_stats.apply_isotonic(xf, yf, p),
                            J_stats.apply_isotonic(xf, yf, p))


def _features19(seed, n=400):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 19))
    y = (rng.random(n) < 0.2 + 0.6 * (x[:, 3] * x[:, 6])).astype(np.float64)
    return x, y


def _on_thresholds(trees: JTrees, x):
    """Rows of x with one feature set to a node's threshold each."""
    rows = []
    f, t = np.asarray(trees.feats), np.asarray(trees.thresh)
    for i, j in zip(*np.nonzero(np.isfinite(t) & (t != 0))):
        r = x[len(rows) % len(x)].copy()
        r[f[i, j]] = t[i, j]
        rows.append(r)
    return np.asarray(rows, np.float32)


def _held(want_tree, got_tree, x):
    x = np.asarray(x, np.float32)
    wm = np.asarray(want_tree.margins(jnp.asarray(x)))
    gm = got_tree.margins(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(gm, wm, atol=1e-6, rtol=0)
    wp = np.asarray(want_tree.predict_proba(jnp.asarray(x)))
    gp = got_tree.predict_proba(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(gp, wp, atol=1e-6, rtol=0)


def test_tree_ensemble_from_gbdt_fit_matches_jax():
    x, y = _features19(6)
    model_j = J_gbdt.train_gbdt(x, y, n_trees=12, depth=3, seed=0)
    model_t = T_gbdt.train_gbdt(x, y, n_trees=12, depth=3, seed=0)
    np.testing.assert_equal(J_gbdt.predict_margin(model_j, x),
                            T_gbdt.predict_margin(model_t, x))
    a, b = J_gbdt.fit_platt(J_gbdt.predict_margin(model_j, x), y)
    assert (a, b) == T_gbdt.fit_platt(T_gbdt.predict_margin(model_t, x), y)
    want = J_gbdt.to_tree_ensemble(model_j, a, b)
    got = T_gbdt.to_tree_ensemble(model_t, a, b)
    assert isinstance(got, TTrees) and got.max_depth == want.max_depth
    xt, _ = _features19(7, 64)
    on = _on_thresholds(want, xt)
    assert len(on) > 20
    _held(want, got, np.concatenate([xt.astype(np.float32), on]))
    # the walk's rows on a threshold take the same branch: equal margins
    # with each such row nudged by one f32 step below and above
    for d in (-1, 1):
        _held(want, got, np.nextafter(on, on + d))


def test_tree_ensemble_from_xgboost_json_matches_jax(tmp_path):
    trees = [
        {"split_indices": [3, 0, 6, 0, 0, 0, 0],
         "split_conditions": [0.5, 0.25, 0.7, -0.4, 0.3, 0.2, 0.6],
         "left_children": [1, 3, 5, -1, -1, -1, -1],
         "right_children": [2, 4, 6, -1, -1, -1, -1]},
        {"split_indices": [18, 0, 0],
         "split_conditions": [0.35, -0.1, 0.15],
         "left_children": [1, -1, -1], "right_children": [2, -1, -1]},
    ]
    model = {"learner": {"learner_model_param": {"base_score": "0.3"},
                         "gradient_booster": {"model": {"trees": trees}}}}
    path = tmp_path / "xgb.json"
    path.write_text(json.dumps(model))
    platt = tmp_path / "platt.json"
    platt.write_text(json.dumps({"a": 1.7, "b": -0.2}))
    want = JTrees.from_xgboost_json(str(path), str(platt))
    got = TTrees.from_xgboost_json(str(path), str(platt))
    x, _ = _features19(8, 64)
    x[:6, 3] = 0.5                          # on the root's threshold
    x[6:12, 18] = 0.35
    x[12:18, 0] = 0.25
    _held(want, got, x)
    assert got.to("cpu").margins(torch.from_numpy(
        x.astype(np.float32))).shape == (64,)
