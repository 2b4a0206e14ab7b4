"""The report's fusion tail, port vs JAX, on the CPU.

The port's `_build_fusion_tail` against JAX's on the same stub core: a
packed numpy core (the engine's scalars from a seed) plus `embed_feat`,
`risk_probs` and `patch_probs`, and the same 64 px uint8 pixels, full and
fast. JAX gets the artifacts through a small engine stand-in, first all
None, then all set: `mean_real`, a `TreeEnsemble` fitted by each
package's `train/gbdt.py` on seeded 19-d features, and an isotonic
`BayesCalibration` fitted by each package on seeded cues.

JAX's battery and rendering score run once per module, jitted on their own
(the tail's own resize to 256 px first), and the JAX tails read them in
place of recomputing them: four tails with the battery inside would cost a
minute of XLA compiles here. Both are JAX's functions on the same pixels;
the port's tail computes its own. tests/test_torch_port_forensics.py and
tests/test_torch_port_flow.py hold the battery and the rendering score
themselves.

Tolerances: the packed core columns and `risk_probs` / `patch_probs`
equal (copied); every battery column and tail scalar within atol 2e-4 +
rtol 2e-3 (the goldens' rule); `xgb_prob` NaN in both without a booster.

Also here: the tail runs its convolutions and products with TF32 off
(`forensics.f32_math`) whatever the caller's setting, and restores it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_report_golden import _images
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_flow import mirror_images
from tests.test_torch_port_forensics import benford_tie_steps
from tpudf.fuse import bayesian as J_bayes
from tpudf.serve import engine as J_engine
from tpudf.serve import report as J_report
from tpudf.train import gbdt as J_gbdt
from tpudf_torch.data.pipeline import resize
from tpudf_torch.fuse import bayesian as T_bayes
from tpudf_torch.serve import engine as T_engine
from tpudf_torch.serve import report as T_report
from tpudf_torch.train import gbdt as T_gbdt

GOLDEN = dict(atol=2e-4, rtol=2e-3)
B, S, W = 3, 64, 64


def _stub_core(fast, seed=0):
    """Seeded per-image outputs of the engine, in its output dict."""
    rng = np.random.default_rng(seed)
    p = lambda: rng.random(B).astype(np.float32)
    out = {"p_blend": p(), "p_fake_raw": p(), "p_fake_coral": p(),
           "visual_prob": p(), "freq_prob": p(),
           "z_sig": rng.normal(0, 2, B).astype(np.float32),
           "z_freq": rng.normal(0, 2, B).astype(np.float32),
           "entropy": (1.6 * rng.random(B)).astype(np.float32),
           "risk_idx": rng.integers(0, 5, B).astype(np.int32)}
    logits = rng.normal(0, 1, (B, 5))
    out["risk_probs"] = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                         ).astype(np.float32)
    if fast:
        out["z_scaled"] = rng.normal(0, 1, B).astype(np.float32)
        return out
    out["patch_probs"] = rng.random((B, 16)).astype(np.float32)
    out["max_patch"] = out["patch_probs"].max(1)
    out["patch_mean"] = out["patch_probs"].mean(1)
    feat = rng.normal(0, 1, (B, W)).astype(np.float32)
    out["embed_feat"] = feat / np.linalg.norm(feat, axis=1, keepdims=True)
    out["embed_l2"] = (40 * rng.random(B)).astype(np.float32)
    return out


def _pixels():
    """A golden corpus image and two near-mirrors (the rendering score's
    blur term moves off 0 on them)."""
    return np.concatenate([_images(1, S), mirror_images(S, (0.0, 0.7))])


def _artifacts():
    """(JAX's, the port's) mean_real, booster and calibration."""
    rng = np.random.default_rng(9)
    mean_real = rng.normal(0, 1, W).astype(np.float32)
    x = rng.random((300, 19))
    x[:, 3] = rng.random(300)
    y = (rng.random(300) < 0.2 + 0.6 * x[:, 3]).astype(np.float64)
    jm = J_gbdt.train_gbdt(x, y, n_trees=8, depth=3)
    tm = T_gbdt.train_gbdt(x, y, n_trees=8, depth=3)
    jt, tt = J_gbdt.to_tree_ensemble(jm, 1.3, -0.1), T_gbdt.to_tree_ensemble(
        tm, 1.3, -0.1)
    held = {k: rng.random(200) for k in J_bayes.FEATURES}
    lab = (rng.random(200) < 0.3 + 0.4 * held["forensic"]).astype(float)
    jc = J_bayes.fit_bayes_calibration(held, lab)
    tc = T_bayes.fit_bayes_calibration(held, lab)
    return ((mean_real, jt, jc), (mean_real.copy(), tt, tc))


@pytest.fixture(scope="module")
def jax_cues():
    """JAX's battery on the tail's own resize of the pixels, and its
    rendering score, each jitted once."""
    px = jnp.asarray(_pixels())

    def battery(px):
        x = px.astype(jnp.float32) / 255.0
        x = jax.image.resize(x, (B, 256, 256, 3), "bilinear")
        return J_report.forensic_battery(x)

    from tpudf.fuse.temporal import render_scores_graph
    return (jax.jit(battery)(px), jax.jit(render_scores_graph)(px))


def _jax_tail(monkeypatch, cues, fast, artifacts):
    fb, render = cues
    J_report._battery_keys()        # its key set, traced on the real one
    monkeypatch.setattr(J_report, "forensic_battery", lambda x: (
        fb if x.shape == (B, 256, 256, 3) else pytest.fail("battery input")))
    monkeypatch.setattr("tpudf.fuse.temporal.render_scores_graph",
                        lambda px: render)
    mean_real, gbdt, calib = artifacts
    eng = types.SimpleNamespace(mean_real=mean_real, gbdt=gbdt,
                                bayes_calibration=calib)
    fn, names = J_report._build_fusion_tail(eng, fast)
    names_ = J_engine.FAST_SCALARS if fast else J_engine.FULL_SCALARS
    core = J_engine._pack(jax.tree.map(jnp.asarray, _stub_core(fast)),
                          names_)
    packed, aux = fn(core, jnp.asarray(_pixels()))
    return (np.asarray(packed), {k: np.asarray(v) for k, v in aux.items()},
            names)


def _port_tail(fast, artifacts):
    mean_real, gbdt, calib = artifacts
    eng = types.SimpleNamespace(mean_real=mean_real, gbdt=gbdt,
                                bayes_calibration=calib,
                                device=torch.device("cpu"))
    fn, names = T_report._build_fusion_tail(eng, fast)
    names_ = T_engine.FAST_SCALARS if fast else T_engine.FULL_SCALARS
    core = T_engine._pack({k: torch.from_numpy(v) for k, v in
                           _stub_core(fast).items()}, names_)
    packed, aux = fn(core, torch.from_numpy(_pixels()))
    return packed.numpy(), {k: v.numpy() for k, v in aux.items()}, names


def _benford_held(got, want):
    """benford_wavelet within the goldens' rule, except on images where
    the difference is shown to be a leading-digit step at ties
    (`benford_tie_steps`): the near-mirrors' Haar coefficients sit on
    digit boundaries (2.0, 50.0) at 256 px, and last-bit differences of
    the grey level flip 6-26 of them (measured |Δ| 5.2e-3 / 5.8e-3)."""
    off = np.abs(got - want) > GOLDEN["atol"] + GOLDEN["rtol"] * np.abs(want)
    if off.any():
        x = resize(torch.from_numpy(_pixels()).float() / 255.0,
                   (B, 256, 256, 3), "bilinear").numpy()
        flips = benford_tie_steps(x)
        assert (flips[off] > 0).all(), (got, want, flips)
        assert np.abs(got - want).max() < 1e-2


@pytest.mark.parametrize("with_artifacts", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_tail_matches_jax(monkeypatch, jax_cues, fast, with_artifacts):
    j_art, t_art = _artifacts() if with_artifacts else ((None,) * 3,) * 2
    want, want_aux, want_names = _jax_tail(monkeypatch, jax_cues, fast,
                                           j_art)
    got, got_aux, names = _port_tail(fast, t_art)
    assert names == want_names and got.shape == want.shape == (B, len(names))
    core_names = T_engine.FAST_SCALARS if fast else T_engine.FULL_SCALARS
    for i, k in enumerate(names):
        if k in core_names:
            np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=k)
        elif k == "xgb_prob" and not (with_artifacts and not fast):
            assert np.isnan(got[:, i]).all() and np.isnan(want[:, i]).all()
        elif k == "fb_benford_wavelet":
            _benford_held(got[:, i], want[:, i])
        else:
            np.testing.assert_allclose(got[:, i], want[:, i], err_msg=k,
                                       **GOLDEN)
    assert set(got_aux) == set(want_aux)
    for k in got_aux:
        np.testing.assert_array_equal(got_aux[k], want_aux[k])
    col = {k: i for i, k in enumerate(names)}
    if not fast:
        # the cues the artifacts move are live in this case
        assert (got[:, col["render_score"]] > 0.55).any()
        if with_artifacts:
            assert (got[:, col["embed_cos_dev"]] > 0).all()
            assert not np.isnan(got[:, col["xgb_prob"]]).any()


def test_tail_runs_without_tf32(monkeypatch):
    """With TF32 on for cuDNN and cuBLAS, every convolution of the tail
    still runs with both off, and the caller's settings come back."""
    import torch.nn.functional as F
    seen = []
    for name in ("conv1d", "conv2d"):
        orig = getattr(F, name)

        def spy(*a, _orig=orig, **kw):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return _orig(*a, **kw)
        monkeypatch.setattr(F, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _port_tail(False, (None,) * 3)
    assert len(seen) > 50
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
