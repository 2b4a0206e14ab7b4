"""The video report's face path on the CPU against the JAX package: the
two face nets, their checkpoints, the face temporal signals and the
engine's `embed_batch`.

  assets   tpudf_torch/assets/*.npz are byte for byte tpudf/assets/'s
  landmark_forward, face_embed_forward on the packaged weights, seeded
       images (noise and the golden recipe)   f32, atol 1e-5 (same math;
       the convolutions pad as "SAME" does: (0, 1) on the stride-2 ones);
       the nets with a symmetric padding=1 in place of "SAME" (a planted
       fault) must miss it
  init / save / load   the init trees' shapes equal JAX's; an npz saved by
       one package loads in the other bit for bit; a wrong format raises
  checkpoint resolution (env, user cache, packaged asset, pretraining)
  detect_landmarks_batch and face_temporal_signals on the golden clip
       against JAX's: the landmark branch, the Haar branch (both packages'
       detect_faces return the same boxes), the tower-embedding fallback
       ($TPUDF_FACE_ID_EMBED=0, one numpy embed_fn for both): the
       goldens' atol 2e-4 + rtol 2e-3 (a crop is truncated to uint8 after
       a resize whose sums run in another order)
  DetectEngine.embed_batch on an f32 test-64 engine, 3 and 4 frames of 48
       px (the bucket of 4; resized to 64 inside)   atol 2e-3 (the f32
       engine rule, tests/test_torch_port_engine.py); one JAX graph
The face checkpoints' env vars are pinned with monkeypatch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_report_golden import _images
from tests.test_torch_port_float import numpy_params
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.models import face_embed as j_embed
from tpudf.models import face_landmark as j_lm
from tpudf.serve import face as j_face
from tpudf_torch.models import face_embed as t_embed
from tpudf_torch.models import face_landmark as t_lm
from tpudf_torch.serve import face as t_face

GOLDEN = dict(atol=2e-4, rtol=2e-3)
T_ASSETS = os.path.join(os.path.dirname(t_lm.__file__), os.pardir, "assets")
J_ASSETS = os.path.join(os.path.dirname(j_lm.__file__), os.pardir, "assets")
LM, EMB = "face_landmarks.npz", "face_embed.npz"


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """The packaged weights on both sides, whatever a user cache holds."""
    monkeypatch.setenv("TPUDF_FACE_CKPT", os.path.join(T_ASSETS, LM))
    monkeypatch.setenv("TPUDF_FACE_EMBED_CKPT", os.path.join(T_ASSETS, EMB))
    for k in ("TPUDF_FACE_ID_EMBED", "TPUDF_FACE_TRAIN"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("name", [LM, EMB])
def test_assets_are_the_jax_packages_bytes(name):
    with open(os.path.join(T_ASSETS, name), "rb") as a, \
            open(os.path.join(J_ASSETS, name), "rb") as b:
        assert a.read() == b.read()


def _inputs(kind):
    if kind == "noise":
        return np.random.default_rng(5).random((4, 64, 64, 3), np.float32)
    return _images(3, 64).astype(np.float32) / 255.0


def _nets():
    j = (j_lm.load_landmark_net(os.path.join(J_ASSETS, LM)),
         j_embed.load_face_embed(os.path.join(J_ASSETS, EMB)))
    t = (t_lm.load_landmark_net(os.path.join(T_ASSETS, LM), "cpu"),
         t_embed.load_face_embed(os.path.join(T_ASSETS, EMB), "cpu"))
    return j, t


def _both(x):
    (jl, je), (tl, te) = _nets()
    want = {**{k: np.asarray(v) for k, v in
               j_lm.landmark_forward(jl, jnp.asarray(x)).items()},
            "embed": np.asarray(j_embed.face_embed_forward(
                je, jnp.asarray(x)))}
    xt = torch.from_numpy(x)
    got = {**{k: v.numpy() for k, v in t_lm.landmark_forward(tl, xt).items()},
           "embed": t_embed.face_embed_forward(te, xt).numpy()}
    return got, want


@pytest.mark.parametrize("kind", ["noise", "golden"])
def test_face_nets_match_jax(kind):
    got, want = _both(_inputs(kind))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_symmetric_padding_misses_jax(monkeypatch):
    """A planted fault: padding=1 on every side in place of "SAME"."""
    def symmetric(x, k_hwio, b, stride):
        return F.conv2d(x, k_hwio.permute(3, 2, 0, 1), b, stride=stride,
                        padding=k_hwio.shape[0] // 2)
    monkeypatch.setattr(t_lm, "conv_same", symmetric)
    monkeypatch.setattr(t_embed, "conv_same", symmetric)
    got, want = _both(_inputs("golden"))
    for k in ("landmarks", "box", "embed"):
        assert np.abs(got[k] - want[k]).max() > 1e-3, k


def test_init_trees_match_jax_shapes():
    g = torch.Generator().manual_seed(0)
    for t_init, j_tree in (
            (lambda: t_lm.init_landmark_net(g),
             jax.eval_shape(lambda: j_lm.init_landmark_net(jax.random.key(0)))),
            (lambda: t_embed.init_face_embed(g),
             jax.eval_shape(lambda: j_embed.init_face_embed(
                 jax.random.key(0))))):
        got = jax.tree.map(lambda t: tuple(t.shape), t_init())
        want = jax.tree.map(lambda s: tuple(s.shape), j_tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_checkpoints_cross_load(tmp_path):
    g = torch.Generator().manual_seed(1)
    cases = ((t_lm.init_landmark_net(g), t_lm.save_landmark_net,
              j_lm.load_landmark_net, j_lm.save_landmark_net,
              t_lm.load_landmark_net),
             (t_embed.init_face_embed(g), t_embed.save_face_embed,
              j_embed.load_face_embed, j_embed.save_face_embed,
              t_embed.load_face_embed))
    for i, (params, t_save, j_load, j_save, t_load) in enumerate(cases):
        a, b = str(tmp_path / f"t{i}.npz"), str(tmp_path / f"j{i}.npz")
        t_save(params, a)
        j_params = j_load(a)
        j_save(j_params, b)
        back = t_load(b, "cpu")
        for x, y, z in zip(jax.tree.leaves(params), jax.tree.leaves(j_params),
                           jax.tree.leaves(back)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            np.testing.assert_array_equal(x.numpy(), z.numpy())
        bad = str(tmp_path / f"bad{i}.npz")
        np.savez(bad, format_version=np.asarray(99))
        with pytest.raises(ValueError):
            t_load(bad, "cpu")


def test_checkpoint_resolution(monkeypatch, tmp_path):
    """$env → user cache → packaged asset → pretraining (saved to the user
    cache) / None; memoized per (env, device); the identity net off with
    $TPUDF_FACE_ID_EMBED=0."""
    monkeypatch.setattr(t_face, "_LM_MEMO", {})
    monkeypatch.setattr(t_face, "_EMBED_MEMO", {})
    a = t_face.get_landmark_params("cpu")
    assert a is t_face.get_landmark_params("cpu")            # memoized
    monkeypatch.delenv("TPUDF_FACE_CKPT")
    monkeypatch.setattr(t_face, "_DEFAULT_CACHE", str(tmp_path / "no.npz"))
    b = t_face.get_landmark_params(torch.device("cpu"))
    assert b is not a                     # the packaged asset, another key
    np.testing.assert_array_equal(a["convs"][0]["k"], b["convs"][0]["k"])
    monkeypatch.setattr(t_face, "_LM_MEMO", {})
    monkeypatch.setattr(t_face, "_PACKAGED_ASSET", str(tmp_path / "x.npz"))
    assert t_face.get_landmark_params("cpu") is None
    monkeypatch.setenv("TPUDF_FACE_TRAIN", "1")
    monkeypatch.setenv("TPUDF_FACE_TRAIN_STEPS", "1")
    trained = t_face.get_landmark_params("cpu")
    assert trained["convs"][0]["k"].shape == a["convs"][0]["k"].shape
    assert os.path.exists(tmp_path / "no.npz")
    assert t_face.get_landmark_params("cpu") is trained       # memoized
    assert t_face.get_face_embed_params("cpu") is not None
    monkeypatch.setenv("TPUDF_FACE_ID_EMBED", "0")
    assert t_face.get_face_embed_params("cpu") is None


def _clip():
    return np.stack([np.roll(_images(1, 64)[0], 2 * t, axis=1)
                     for t in range(6)])


def test_detect_landmarks_matches_jax():
    clip = _clip()
    want, wboxes = j_face.detect_landmarks_batch(
        clip, j_lm.load_landmark_net(os.path.join(J_ASSETS, LM)))
    got, gboxes = t_face.detect_landmarks_batch(
        clip, t_lm.load_landmark_net(os.path.join(T_ASSETS, LM), "cpu"))
    np.testing.assert_allclose(gboxes, wboxes, atol=1e-5, rtol=0)
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(w is not None for w in want) >= 3
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def _embed_fn(crops):
    """One deterministic numpy embedder for both packages."""
    x = np.asarray(crops, np.float32).reshape(len(crops), -1)
    return x[:, ::97] - x[:, ::97].mean(1, keepdims=True)


@pytest.mark.parametrize("branch", ["landmark", "haar", "embed_fn"])
def test_face_temporal_signals_match_jax(branch, monkeypatch):
    clip = list(_clip())
    lm = None
    if branch == "haar":
        boxes = iter([(6 + t, 8, 40, 44) for t in range(6)] * 2)
        stub = lambda img, min_size=48: [next(boxes)]
        monkeypatch.setattr(j_face, "detect_faces", stub)
        monkeypatch.setattr(t_face, "detect_faces", stub)
    else:
        lm = "lm"
    if branch == "embed_fn":
        monkeypatch.setenv("TPUDF_FACE_ID_EMBED", "0")
    want = j_face.face_temporal_signals(
        clip, _embed_fn, lm and j_face.get_landmark_params())
    got = t_face.face_temporal_signals(
        clip, _embed_fn, lm and t_face.get_landmark_params("cpu"),
        device="cpu")
    assert set(got) == set(want)
    assert all(v is not None for v in want.values()), want
    for k, w in want.items():
        assert abs(got[k] - w) <= GOLDEN["atol"] + GOLDEN["rtol"] * abs(w), \
            (k, got[k], w)


def test_face_nets_run_without_tf32(monkeypatch):
    """With TF32 on for cuDNN and cuBLAS, every convolution of both face
    nets (the landmark net's two passes, the identity net) runs with both
    off, and the caller's settings come back."""
    seen = []
    orig = F.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return orig(*a, **kw)
    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    sig = t_face.face_temporal_signals(list(_clip()), None,
                                       t_face.get_landmark_params("cpu"))
    assert sig["face_embedding_drift"] is not None
    n_lm = len(t_face.get_landmark_params("cpu")["convs"])
    assert len(seen) > 2 * n_lm               # both passes and the id net
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("lm", [True, False])
def test_face_signals_device_follows_the_landmark_net(monkeypatch, lm):
    """Without `device`, the identity net is loaded on the landmark net's
    device, and on the card when there is no landmark net (the port's
    entry points run on the card unless the caller asks for the CPU)."""
    asked = []

    def params(device, allow_train=None):
        asked.append(torch.device(device))
    monkeypatch.setattr(t_face, "get_face_embed_params", params)
    monkeypatch.setattr(t_face, "detect_faces", lambda img, min_size=48: [])
    t_face.face_temporal_signals(
        list(_clip()), None, t_face.get_landmark_params("cpu") if lm else None)
    assert asked == [torch.device("cpu" if lm else "cuda")]


@pytest.fixture(scope="module")
def f32_engines():
    from tpudf.calib.coral import CoralCutpoints as JCuts
    from tpudf.core.precision import F32_POLICY as J_F32
    from tpudf.models.freq_mlp import init_freq_mlp
    from tpudf.models.fusion import init_fusion_linear
    from tpudf.models.heads import init_binary_head
    from tpudf.models.siglip import CONFIGS as J_CONFIGS
    from tpudf.models.siglip import init_siglip
    from tpudf.serve.engine import DetectEngine as JEngine
    from tpudf_torch.convert import params_from_numpy
    from tpudf_torch.core.precision import F32_POLICY
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.serve.engine import DetectEngine

    cfg = J_CONFIGS["test-64"]
    k = jax.random.key(0)
    tree = numpy_params(lambda: {
        "backbone": init_siglip(k, cfg), "head": init_binary_head(k, 64),
        "freq": init_freq_mlp(k), "fusion": init_fusion_linear(k)}, 4)
    jeng = JEngine(cfg=cfg, cuts=JCuts.default(), policy=J_F32,
                   **jax.tree.map(jnp.asarray, tree))
    eng = DetectEngine(cfg=CONFIGS["test-64"], policy=F32_POLICY,
                       **params_from_numpy({**tree, "cuts": jeng.cuts},
                                           "cpu"))
    return jeng, eng


@pytest.mark.parametrize("n", [3, 4])
def test_embed_batch_matches_jax(f32_engines, n):
    jeng, eng = f32_engines
    px = np.random.default_rng(n).integers(0, 256, (n, 48, 48, 3), np.uint8)
    want = jeng.embed_batch(px)
    got = eng.embed_batch(px)
    assert got.shape == want.shape == (n, 64)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
