"""Parity of the port's inference CLI's engine and what the CLI imports
with the JAX package, on the CPU (`tpudf_torch.cli.infer`, `data/decode.py`,
`data/datasets._decode_image`, `serve/adapt.py`, `data/tta.py`, the
artifact loaders).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  _decode_image        equal (uint8), the native JPEG route and PIL's
  artifact loaders     leaf for leaf equal (freq MLP, fusion head, CORAL
                       cuts and temperature, the booster's tables, the
                       Bayes calibration); fit_temperature equal
  build_engine         the ToMe schedules, fusion, cuts, booster and
                       calibration equal; act scales within one bf16 step
                       (rtol 2^-7: both calibrate the same tree on the same
                       decoded images in bf16, and torch and XLA round the
                       bf16 blocks at other points; measured 1 of 8 scales
                       a step apart); _calib_batch equal
  prototype_classify   atol 1e-5 (measured 4.2e-7)
  linear / kernel probe after 300 Adam steps: parameters and predictions
                       atol 1e-4 (measured: linear w 1.03e-5, b 4.9e-6,
                       predictions 2.0e-6; kernel alpha 3.2e-6,
                       predictions 8.9e-7: torch's Adam and optax's adam
                       order the same update's operations apart)
  embedding anomaly, mean_real_embedding   atol 1e-6
  tta transforms       atol 1e-6 (the blurs' sums in another order); the
                       flips and rotations equal
`main` itself is held in tests/test_torch_port_infer_main.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.calib import coral as J_coral
from tpudf.cli import infer as J_infer
from tpudf.data import datasets as J_data
from tpudf.data import decode as J_decode
from tpudf.data import tta as J_tta
from tpudf.models import freq_mlp as J_freq
from tpudf.models import fusion as J_fusion
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.serve import adapt as J_adapt
from tpudf_torch.calib import coral as T_coral
from tpudf_torch.cli import infer as T_infer
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.data import datasets as T_data
from tpudf_torch.data import decode as T_decode
from tpudf_torch.data import tta as T_tta
from tpudf_torch.fuse.bayesian import FEATURES
from tpudf_torch.models import freq_mlp as T_freq
from tpudf_torch.models import fusion as T_fusion
from tpudf_torch.serve import adapt as T_adapt


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _leaves_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def _write_images(root, n_per_class, seed, size=(40, 48)):
    """REAL/FAKE folders of n_per_class seeded images each, PNG and
    quality-90 JPEG alternating (FAKE brighter)."""
    rng = np.random.default_rng(seed)
    for cls, bias in (("REAL", 0.0), ("FAKE", 0.5)):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            arr = np.clip(rng.random((*size, 3)) * 0.5 + bias, 0, 1)
            im = Image.fromarray((arr * 255).astype(np.uint8))
            if i % 2:
                im.save(os.path.join(d, f"{i}.jpg"), quality=90)
            else:
                im.save(os.path.join(d, f"{i}.png"))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """{train,val}/{REAL,FAKE}/ of 8 images a class, PNG + JPEG."""
    root = str(tmp_path_factory.mktemp("infer"))
    for i, split in enumerate(("train", "val")):
        _write_images(os.path.join(root, split), 8, seed=i)
    return root


# ----------------------------------------------------------------- decode

@pytest.fixture(scope="module")
def big_jpeg(tmp_path_factory):
    """A seeded 300 × 420 JPEG at quality 90 (smooth colour ramps plus
    noise, as a photo's statistics)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:300, 0:420] / 420.0
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx), 0.5 + 0.4 * np.cos(5 * yy),
                    0.3 + 0.3 * xx], -1) + 0.05 * rng.standard_normal(
                        (300, 420, 3))
    path = str(tmp_path_factory.mktemp("jpeg") / "photo.jpg")
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        path, quality=90)
    return path


def test_decode_jpeg_matches_jax(big_jpeg):
    """The port decodes a JPEG in JAX's order (the native library first,
    then PIL), so the pixels are JAX's: equal at 256 px."""
    np.testing.assert_array_equal(T_data._decode_image(big_jpeg, 256),
                                  J_data._decode_image(big_jpeg, 256))


def test_decode_native_route_then_pil(big_jpeg, monkeypatch):
    """Where cpp/libtpudf_decode.so loads: the binding's decode equals
    JAX's (a missing file's status too), `_decode_image` takes it, a PNG
    takes PIL's route; with the library absent on both sides both fall
    back to the same PIL decode, which is not the native one."""
    if not (T_decode.available() and J_decode.available()):
        pytest.skip("cpp/libtpudf_decode.so does not load here")
    native = T_decode.decode_resize(big_jpeg, 256)
    np.testing.assert_array_equal(native, J_decode.decode_resize(big_jpeg,
                                                                 256))
    np.testing.assert_array_equal(T_data._decode_image(big_jpeg, 256),
                                  native)
    out, status = T_decode.decode_batch([big_jpeg, big_jpeg + ".missing"],
                                        64)
    want_out, want_status = J_decode.decode_batch(
        [big_jpeg, big_jpeg + ".missing"], 64)
    np.testing.assert_array_equal(status, want_status)
    np.testing.assert_array_equal(out[0], want_out[0])
    assert status[0] == 0 and status[1] != 0
    png = big_jpeg[:-4] + ".png"
    Image.open(big_jpeg).save(png)
    assert T_decode.decode_resize(png, 256) is None
    np.testing.assert_array_equal(T_data._decode_image(png, 256),
                                  J_data._decode_image(png, 256))
    for mod in (T_decode, J_decode):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)
    assert not T_decode.available()
    pil = T_data._decode_image(big_jpeg, 256)
    np.testing.assert_array_equal(pil, J_data._decode_image(big_jpeg, 256))
    with Image.open(big_jpeg) as im:
        want = np.asarray(im.convert("RGB").resize((256, 256),
                                                   Image.BICUBIC))
    np.testing.assert_array_equal(pil, want)
    assert (pil != native).any()


def test_video_exts_match_jax():
    assert T_data.VIDEO_EXTS == J_data.VIDEO_EXTS
    assert T_data.IMG_EXTS == J_data.IMG_EXTS


# -------------------------------------------------------------- artifacts

def _artifacts(root):
    """A seeded artifacts dir in the reference's layout: freq MLP and
    fusion head safetensors, CORAL cut points and temperature, the Bayes
    calibration, an XGBoost booster and its Platt scale."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    save_file({"net.0.weight": 1 + 0.1 * f(24), "net.0.bias": 0.1 * f(24),
               "net.1.weight": f(64, 24), "net.1.bias": f(64),
               "net.3.weight": f(1, 64), "net.3.bias": f(1)},
              os.path.join(root, "freq_mlp.safetensors"))
    save_file({"fc.weight": f(1, 2), "fc.bias": f(1)},
              os.path.join(root, "fusion_head.safetensors"))
    with open(os.path.join(root, "coral_cutpoints.json"), "w") as fo:
        json.dump({"q25": 0.3, "q50": 0.45, "q75": 0.6, "max": 0.8}, fo)
    with open(os.path.join(root, "coral_temp.json"), "w") as fo:
        json.dump({"temperature": 1.4}, fo)
    with open(os.path.join(root, "bayes_calibration.json"), "w") as fo:
        json.dump({"iso": {FEATURES[0]: [[0.0, 0.5, 1.0], [0.1, 0.4, 0.9]]},
                   "logistic": {"w": [0.2] * len(FEATURES), "b": -0.3}}, fo)
    trees = [{"split_indices": [3, 0, 0], "split_conditions": [0.5, -0.4,
                                                               0.3],
              "left_children": [1, -1, -1], "right_children": [2, -1, -1]}]
    with open(os.path.join(root, "xgb_fusion.json"), "w") as fo:
        json.dump({"learner": {"learner_model_param": {"base_score": "0.3"},
                               "gradient_booster": {"model": {
                                   "trees": trees}}}}, fo)
    with open(os.path.join(root, "platt.json"), "w") as fo:
        json.dump({"a": 1.7, "b": -0.2}, fo)
    return root


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _artifacts(str(tmp_path_factory.mktemp("artifacts")))


def test_freq_mlp_and_fusion_from_safetensors_match_jax(artifacts):
    path = os.path.join(artifacts, "freq_mlp.safetensors")
    _leaves_equal(T_freq.freq_mlp_from_safetensors(path),
                  J_freq.freq_mlp_from_safetensors(path))
    path = os.path.join(artifacts, "fusion_head.safetensors")
    _leaves_equal(T_fusion.fusion_linear_from_safetensors(path),
                  J_fusion.fusion_linear_from_safetensors(path))


@pytest.mark.parametrize("form", ["dict", "list"])
@pytest.mark.parametrize("with_temp", [False, True])
def test_coral_from_json_matches_jax(tmp_path, form, with_temp):
    cuts = [0.28, 0.5, 0.66, 0.81]
    path = tmp_path / "cuts.json"
    path.write_text(json.dumps(cuts if form == "list" else dict(
        zip(("q25", "q50", "q75", "max"), cuts))))
    temp = None
    if with_temp:
        temp = tmp_path / "temp.json"
        temp.write_text(json.dumps({"temperature": 0.8}))
        temp = str(temp)
    got = T_coral.CoralCutpoints.from_json(str(path), temp)
    want = J_coral.CoralCutpoints.from_json(str(path), temp)
    assert got.cuts == want.cuts and got.temperature == want.temperature


def test_fit_temperature_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.normal(0, 3, 200)
    y = (rng.random(200) < 1 / (1 + np.exp(-z / 2.2))).astype(float)
    assert T_coral.fit_temperature(z, y) == J_coral.fit_temperature(z, y)
    grid = np.linspace(0.5, 3.0, 11)
    assert T_coral.fit_temperature(z, y, grid) == J_coral.fit_temperature(
        z, y, grid)


# ------------------------------------------------------------------ adapt

def _fewshot(n=60, d=32, seed=0):
    """Unit rows, class 1 shifted on 4 features (tests/test_adapt_tta.py's
    data)."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % 2).astype(np.float32)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    x[y == 1, :4] += 2.0
    return x / np.linalg.norm(x, axis=1, keepdims=True), y


def test_prototype_classify_matches_jax():
    x, y = _fewshot()
    q, _ = _fewshot(seed=1)
    np.testing.assert_allclose(
        _np(T_adapt.prototype_classify(x, y, q)),
        np.asarray(J_adapt.prototype_classify(jnp.asarray(x), jnp.asarray(y),
                                              jnp.asarray(q))), atol=1e-5,
        rtol=0)


def test_linear_probe_matches_jax():
    x, y = _fewshot()
    q, _ = _fewshot(seed=2)
    got = T_adapt.train_linear_probe(x, y)
    want = J_adapt.train_linear_probe(jnp.asarray(x), jnp.asarray(y))
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        _np(T_adapt.linear_probe_predict(got, q)),
        np.asarray(J_adapt.linear_probe_predict(want, jnp.asarray(q))),
        atol=1e-4, rtol=0)


def test_kernel_probe_matches_jax():
    x, y = _fewshot()
    q, _ = _fewshot(seed=3)
    got = T_adapt.train_kernel_probe(x, y)
    want = J_adapt.train_kernel_probe(jnp.asarray(x), jnp.asarray(y))
    assert got["gamma"] == want["gamma"]
    for k in ("alpha", "b"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        _np(T_adapt.kernel_probe_predict(got, q)),
        np.asarray(J_adapt.kernel_probe_predict(want, jnp.asarray(q))),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_mean", [False, True])
def test_embedding_anomaly_matches_jax(with_mean):
    rng = np.random.default_rng(7)
    real = rng.normal(0, 1, (100, 32)).astype(np.float32)
    real[:, 0] += 5.0
    feats = np.concatenate([real[:5], -real[5:10]])
    mu_t = T_adapt.mean_real_embedding(real)
    mu_j = J_adapt.mean_real_embedding(jnp.asarray(real))
    np.testing.assert_allclose(_np(mu_t), np.asarray(mu_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        _np(T_adapt.embedding_anomaly_score(feats,
                                            mu_t if with_mean else None)),
        np.asarray(J_adapt.embedding_anomaly_score(
            jnp.asarray(feats), mu_j if with_mean else None)),
        atol=1e-6, rtol=0)


# -------------------------------------------------------------------- tta

def _tta_input():
    return np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(J_tta.TTA_TRANSFORMS))
def test_tta_transform_matches_jax(name):
    x = _tta_input()
    got = _np(T_tta.TTA_TRANSFORMS[name](torch.from_numpy(x)))
    want = np.asarray(J_tta.TTA_TRANSFORMS[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_tta_batch_brightness_and_aggregate_match_jax():
    x = _tta_input()
    views, names = T_tta.tta_batch(torch.from_numpy(x))
    want, want_names = J_tta.tta_batch(jnp.asarray(x))
    assert names == want_names and views.shape == want.shape
    np.testing.assert_allclose(_np(views), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        _np(T_tta.brightness(torch.from_numpy(x), 0.3)),
        np.asarray(J_tta.brightness(jnp.asarray(x), 0.3)), atol=0, rtol=0)
    z = np.random.default_rng(9).normal(0, 1, (3, 9)).astype(np.float32)
    for zz in (z, z[:, :8]):                     # odd and even counts
        for mode in ("mean", "median"):
            np.testing.assert_allclose(
                _np(T_tta.tta_aggregate(torch.from_numpy(zz), mode=mode)),
                np.asarray(J_tta.tta_aggregate(jnp.asarray(zz), mode=mode)),
                atol=1e-6, rtol=0, err_msg=mode)
        # JAX's trimmed mean raises NameError (`jax` is unbound in
        # tpudf/data/tta.py); held to its formula in numpy
        k = zz.shape[1]
        lo, hi = max(1, k // 8), k - max(1, k // 8)
        np.testing.assert_allclose(
            _np(T_tta.tta_aggregate(torch.from_numpy(zz), mode="trimmed")),
            np.sort(zz, axis=1)[:, lo:hi].mean(axis=1), atol=1e-6, rtol=0)
    with pytest.raises(NameError):
        J_tta.tta_aggregate(jnp.asarray(z), mode="trimmed")


def test_jitter_views_are_small_rolls():
    """jitter_views draws from a torch.Generator (not JAX's key): each view
    is the input rolled by at most round(0.02 · side) pixels, as JAX's."""
    x = torch.from_numpy(np.random.default_rng(10).random(
        (2, 64, 64, 3)).astype(np.float32))
    views = T_tta.jitter_views(torch.Generator().manual_seed(0), x, n=6)
    assert views.shape == (2, 6, 64, 64, 3)
    lim = round(0.02 * 64)
    for v in range(6):
        assert any(torch.equal(views[:, v], torch.roll(x, (sy, sx), (1, 2)))
                   for sy in range(-lim, lim + 1)
                   for sx in range(-lim, lim + 1)), v


# ----------------------------------------------------------- build_engine

def _numpy_backbone(cfg_name, seed=0):
    jcfg = J_CONFIGS[cfg_name]
    return numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg), seed)


def test_build_engine_matches_jax(folder, artifacts, monkeypatch, capsys):
    """--int8 --tome_r --patch_tome with an artifacts dir at test-32: the
    same schedules, fusion, cuts, booster and calibration, and act scales
    calibrated on the same decoded input images (JAX's random tower taken
    as numpy into both builds)."""
    backbone = _numpy_backbone("test-32")
    head = numpy_params(lambda: j_init_head(jax.random.key(1), 64), 1)
    import tpudf.models.heads as J_heads
    import tpudf.models.siglip as J_siglip
    monkeypatch.setattr(J_siglip, "init_siglip", lambda key, cfg: backbone)
    monkeypatch.setattr(J_heads, "init_binary_head", lambda key, w: head)
    monkeypatch.setattr(T_infer, "init_siglip", lambda g, cfg: params_from_numpy(
        backbone, "cpu"))
    val = os.path.join(folder, "val")
    argv = ["--input", val, "--model_size", "test-32", "--int8", "--tome_r",
            "--patch_tome", "--artifacts", artifacts]
    jargs = J_infer.parse_args(argv)
    targs = T_infer.parse_args(argv + ["--device", "cpu"])
    assert targs.device == "cpu" and T_infer.parse_args(
        ["--input", val]).device == "cuda"
    jcal, tcal = J_infer._calib_batch(jargs, 32), T_infer._calib_batch(
        targs, 32)
    np.testing.assert_array_equal(tcal, jcal)
    jeng = J_infer.build_engine(jargs, jcal)
    eng = T_infer.build_engine(targs, tcal)
    assert "xgb_fusion.json booster attached (platt=yes)" in \
        capsys.readouterr().out
    assert eng.device == torch.device("cpu")
    for k in ("tome_r", "tome_floor", "patch_tome_r", "patch_tome_floor"):
        assert getattr(eng, k) == getattr(jeng, k), k
    assert eng.tome_r > 0 and eng.patch_tome_r > 0
    assert eng.cuts.cuts == jeng.cuts.cuts
    assert eng.cuts.temperature == jeng.cuts.temperature == 1.4
    _leaves_equal(eng.fusion, jeng.fusion)
    _leaves_equal(eng.freq, jeng.freq)
    for k in ("feats", "thresh", "left", "right", "leaf"):
        np.testing.assert_array_equal(_np(getattr(eng.gbdt, k)),
                                      np.asarray(getattr(jeng.gbdt, k)))
    assert (eng.gbdt.platt_a, eng.gbdt.platt_b, eng.gbdt.base_score) == (
        jeng.gbdt.platt_a, jeng.gbdt.platt_b, jeng.gbdt.base_score)
    assert eng.bayes_calibration.to_json() == jeng.bayes_calibration.to_json()
    got = eng.backbone["blocks"]["act_scales"]
    want = jeng.backbone["blocks"]["act_scales"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=2 ** -7, atol=0, err_msg=k)


def test_build_engine_moe_fallback_and_invert(folder, capsys):
    """No artifacts: the MoE fallback (fusion None, the line printed) and
    the default cuts; --random_fusion a fusion head; --invert_logits
    negates fc3 of the same head."""
    val = os.path.join(folder, "val")
    base = ["--input", val, "--model_size", "test-32", "--device", "cpu"]
    plain = T_infer.build_engine(T_infer.parse_args(base))
    assert plain.fusion is None and "MoE fallback" in capsys.readouterr().out
    assert plain.cuts == T_coral.CoralCutpoints.default()
    assert plain.tome_r == plain.patch_tome_r == 0
    assert T_infer.build_engine(T_infer.parse_args(
        base + ["--random_fusion"])).fusion["w"].shape == (2, 1)
    inv = T_infer.build_engine(T_infer.parse_args(base + ["--invert_logits"]))
    for k in ("w", "b"):
        torch.testing.assert_close(inv.head["fc3"][k], -plain.head["fc3"][k],
                                   atol=0, rtol=0)
    torch.testing.assert_close(inv.head["fc2"]["w"], plain.head["fc2"]["w"],
                               atol=0, rtol=0)
    explicit = T_infer.build_engine(T_infer.parse_args(
        base + ["--tome_r", "8"]))
    assert (explicit.tome_r, explicit.tome_floor) == (8, 0)


def test_head_ckpt_restores_train_binary_ema(folder, tmp_path):
    """--head_ckpt reads the port's own checkpoint (tpudf_torch.cli
    .train_binary, torch.save) and takes its EMA; a checkpoint of another
    tree is refused."""
    from tpudf_torch.cli import train_binary
    from tpudf_torch.train.checkpoint import restore_train_state
    save = str(tmp_path / "run")
    train_binary.main(["--data_dir", folder, "--save_dir", save,
                       "--model_size", "test-32", "--epochs", "1",
                       "--batch_size", "8", "--warmup_steps", "1",
                       "--no_augment", "--ema_decay", "0.9", "--device",
                       "cpu"])
    best = os.path.join(save, "best")
    ema = restore_train_state(best)["ema"]
    eng = T_infer.build_engine(T_infer.parse_args(
        ["--input", folder, "--model_size", "test-32", "--device", "cpu",
         "--head_ckpt", best]))
    _leaves_equal(eng.head, ema)
    bad = tmp_path / "bad"
    torch.save({"params": {"w": torch.zeros(3)}, "opt_state": {}, "step": 0},
               str(bad))
    with pytest.raises(SystemExit, match="cannot restore head"):
        T_infer.build_engine(T_infer.parse_args(
            ["--input", folder, "--model_size", "test-32", "--device", "cpu",
             "--head_ckpt", str(bad)]))
