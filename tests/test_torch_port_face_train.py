"""Parity of the port's face-net pretraining with the JAX package, on the
CPU: the synthetic generators, the contrastive data and loss, the landmark
and identity trainers, pretraining on demand in serve/face.py and the
face_pretrain CLI (tpudf_torch/data/synth_detect.py, synth_faces.py,
tpudf_torch/models/face_landmark.py `train_landmark_net`,
tpudf_torch/models/face_embed.py, tpudf_torch/cli/face_pretrain.py).

Tolerances:
  make_detect_batch, make_batch, face_clip, make_pair_batch (same seeds,
       same pool), load_crop_pool_from_dir  bit-equal
  render_crop_pool  within one uint8 level (1/255) everywhere, at most
       1e-3 of the values apart: each crop is resized (the port's matrix
       resize, XLA's einsum: f32 sums in another order) and truncated to
       uint8, so a value on an integer lands on it or just below (measured
       8.1e-5 of a 16-crop pool); the draws stay aligned (the next draw
       after the pool is equal)
  nt_xent_loss  rtol 1e-6
  1 and 3 steps of train_landmark_net (batch 4, size 64) and of
       train_face_embed (k_ids 4; JAX's 8-identity, 2-view pool handed to
       both) from JAX's init trees carried across as numpy: every
       parameter within 1e-4 of its leaf's largest magnitude (after 3
       steps, or 2e-2 lr where that is larger, the MTL trainer's rule in
       tests/test_torch_port_train.py: a bias leaf is a few lr large,
       measured 6e-3 lr; one identity-projection weight of 262,144 sits
       1.5e-2 lr off), except where the step-1 gradient is
       below 1e-6 (zero in exact arithmetic, as the heatmap bias's under
       the spatial softmax, or a dead unit's): Adam's first step is
       lr · sign(g), so f32 noise there moves a parameter by up to lr a
       step either way; those within 2 lr a step
  serve/face with TPUDF_FACE_TRAIN=1 (2 steps, a temporary HOME): trains,
       writes the user cache, the next lookup (memo cleared) reads it back
  face_pretrain.main (2 steps each): both npz files, which JAX's
       load_landmark_net / load_face_embed read
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_variants import persist_every_compile  # noqa: F401
from tpudf.data import synth_detect as J_det
from tpudf.data import synth_faces as J_faces
from tpudf.models import face_embed as J_emb
from tpudf.models import face_landmark as J_lm
from tpudf_torch.cli import face_pretrain as T_cli
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.data import synth_detect as T_det
from tpudf_torch.data import synth_faces as T_faces
from tpudf_torch.models import face_embed as T_emb
from tpudf_torch.models import face_landmark as T_lm
from tpudf_torch.serve import face as T_face
from tpudf_torch.train.steps import tensor_leaves


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


NOISE_GRAD = 1e-6


def _step1_grads(params, loss_fn):
    """The port's gradient of loss_fn at the carried parameters, by leaf."""
    p = params_from_numpy(_np_tree(params), "cpu")
    for leaf in tensor_leaves(p):
        leaf.requires_grad_(True)
    loss_fn(p).backward()
    return [leaf.grad.numpy() for leaf in tensor_leaves(p)]


def _held(got, want, grad1, steps, lr):
    g = [t.numpy() for t in tensor_leaves(got)]
    w = [np.asarray(t) for t in jax.tree.leaves(want)]
    assert len(g) == len(w) == len(grad1)
    for i, (a, b, g1) in enumerate(zip(g, w, grad1)):
        assert a.shape == b.shape
        tol = 1e-4 * float(np.abs(b).max())
        if steps > 1:
            tol = max(tol, 2e-2 * lr)
        tol = np.where(np.abs(g1) < NOISE_GRAD, 2 * lr * steps, tol)
        err = np.abs(a - b)
        assert (err <= tol).all(), (f"leaf {i}: {int((err > tol).sum())} "
                                    f"off, max {float(err.max()):.3e}")


# ------------------------------------------------------------ the data

@pytest.mark.parametrize("size,seed", [(32, 0), (64, 5)])
def test_make_detect_batch_bit_equal(size, seed):
    for a, b in zip(T_det.make_detect_batch(3, size, seed),
                    J_det.make_detect_batch(3, size, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_synth_faces_bit_equal():
    for a, b in zip(T_faces.make_batch(np.random.default_rng(1), 6, 48),
                    J_faces.make_batch(np.random.default_rng(1), 6, 48)):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"swap_at": 3}):
        for a, b in zip(T_faces.face_clip(40, 5, np.random.default_rng(2),
                                          **kw),
                        J_faces.face_clip(40, 5, np.random.default_rng(2),
                                          **kw)):
            np.testing.assert_array_equal(a, b)


POOL_SEED = 80


@pytest.fixture(scope="module")
def jax_pool():
    """JAX's 8-identity, 2-view pool and its generator after the pool."""
    rng = np.random.default_rng(POOL_SEED)
    return J_emb.render_crop_pool(rng, 8, 2), rng


def test_crop_pool_and_pairs_match_jax(jax_pool):
    want_pool, j_rng = jax_pool
    t_rng = np.random.default_rng(POOL_SEED)
    got_pool = T_emb.render_crop_pool(t_rng, 8, 2)
    assert got_pool.shape == (8, 2, 64, 64, 3)
    apart = got_pool != want_pool
    assert np.abs(got_pool - want_pool).max() <= 1 / 255 + 1e-6
    assert apart.mean() <= 1e-3
    assert t_rng.random() == j_rng.random()           # the draws aligned
    a = T_emb.make_pair_batch(np.random.default_rng(4), 3, pool=want_pool)
    b = J_emb.make_pair_batch(np.random.default_rng(4), 3, pool=want_pool)
    assert a.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_load_crop_pool_from_dir_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(5)
    for ident, n in (("a", 3), ("b", 2), ("c", 1)):
        d = tmp_path / ident
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (50, 40, 3), np.uint8)).save(
                d / f"{i}.png")
    got = T_emb.load_crop_pool_from_dir(str(tmp_path), size=32)
    assert got.shape == (2, 2, 32, 32, 3)
    np.testing.assert_array_equal(
        got, J_emb.load_crop_pool_from_dir(str(tmp_path), size=32))


def test_nt_xent_loss_matches_jax():
    e = np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    for t in (0.1, 0.5):
        got = float(T_emb.nt_xent_loss(torch.from_numpy(e), t))
        want = float(J_emb.nt_xent_loss(e, t))
        assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------ trainers

@pytest.mark.parametrize("steps", [1, 3])
def test_train_landmark_net_matches_jax(steps):
    init = J_lm.init_landmark_net(jax.random.key(7), 64)
    imgs, pres, lms, boxes = (torch.from_numpy(a) for a in J_faces.make_batch(
        np.random.default_rng(7), 4, 64))
    grad1 = _step1_grads(init, lambda p: T_lm.landmark_loss(
        T_lm.landmark_outputs(p, imgs), pres, lms, boxes))
    want = J_lm.train_landmark_net(jax.random.key(7), steps=steps, batch=4,
                                   size=64, seed=7)
    got = T_lm.train_landmark_net(params_from_numpy(_np_tree(init), "cpu"),
                                  steps=steps, batch=4, size=64, seed=7,
                                  device="cpu")
    _held(got, want, grad1, steps, 2e-3)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_face_embed_matches_jax(steps, jax_pool):
    jax_pool = jax_pool[0]
    init = J_emb.init_face_embed(jax.random.key(8))
    batch = torch.from_numpy(J_emb.make_pair_batch(
        np.random.default_rng(8), 4, pool=jax_pool))
    grad1 = _step1_grads(init, lambda p: T_emb.nt_xent_loss(
        T_emb.face_embed_outputs(p, batch)))
    want = J_emb.train_face_embed(jax.random.key(8), steps=steps, k_ids=4,
                                  pool=jax_pool, seed=8)
    got = T_emb.train_face_embed(params_from_numpy(_np_tree(init), "cpu"),
                                 steps=steps, k_ids=4, pool=jax_pool, seed=8,
                                 device="cpu")
    _held(got, want, grad1, steps, 1e-3)


# ------------------------------------------------- serving and the CLI

def test_serve_face_trains_and_caches(monkeypatch, tmp_path):
    """TPUDF_FACE_TRAIN=1 with no checkpoint anywhere: both nets train,
    land in the user cache under HOME, and the next lookup reads them."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TPUDF_FACE_TRAIN", "1")
    monkeypatch.setenv("TPUDF_FACE_TRAIN_STEPS", "2")
    for k in ("TPUDF_FACE_CKPT", "TPUDF_FACE_EMBED_CKPT",
              "TPUDF_FACE_ID_EMBED"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(T_face, "_PACKAGED_ASSET", str(tmp_path / "no.npz"))
    monkeypatch.setattr(T_face, "_EMBED_ASSET", str(tmp_path / "no.npz"))
    # the identity net's default pool is 256 identities x 6 views: a small
    # one keeps the test to the resolution's flow
    small = T_emb.train_face_embed
    monkeypatch.setattr(T_emb, "train_face_embed", lambda **kw: small(
        n_ids=8, pool_views=2, **kw))
    cache = tmp_path / ".cache" / "tpudf"
    for get, name, memo in (
            (T_face.get_landmark_params, "face_landmarks.npz", "_LM_MEMO"),
            (T_face.get_face_embed_params, "face_embed.npz", "_EMBED_MEMO")):
        monkeypatch.setattr(T_face, memo, {})
        trained = get("cpu")
        assert trained is not None and (cache / name).exists()
        assert get("cpu") is trained                    # memoized
        monkeypatch.setattr(T_face, memo, {})
        monkeypatch.setenv("TPUDF_FACE_TRAIN", "0")     # the cache, no train
        back = get("cpu")
        monkeypatch.setenv("TPUDF_FACE_TRAIN", "1")
        for a, b in zip(jax.tree.leaves(trained), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_face_pretrain_cli_writes_jax_loadable(tmp_path):
    lm, emb = str(tmp_path / "lm.npz"), str(tmp_path / "emb.npz")
    T_cli.main(["--steps", "2", "--embed_steps", "2", "--embed_ids", "4",
                "--batch", "4", "--out", lm, "--embed_out", emb,
                "--device", "cpu"])
    j_lm, j_emb = J_lm.load_landmark_net(lm), J_emb.load_face_embed(emb)
    t_lm, t_emb = T_lm.load_landmark_net(lm, "cpu"), T_emb.load_face_embed(
        emb, "cpu")
    for t, j in ((t_lm, j_lm), (t_emb, j_emb)):
        for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T_emb.face_embed_forward(t_emb, torch.from_numpy(x)).numpy(),
        np.asarray(J_emb.face_embed_forward(j_emb, x)), atol=1e-5)
