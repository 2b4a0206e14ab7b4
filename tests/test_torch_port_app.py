"""Parity of the port's front end with the JAX package, on the CPU:
`tpudf_torch.data.media`, `ops/forensic_maps.py`, `serve/app.py` and the
`tpudf_torch.cli.forensics` CLI.

Inputs are made with numpy from a seed and handed to both packages; JAX's
map battery and forensic battery are jitted once per shape.
Tolerances:
  media                 equal (the same PIL calls), the same MediaError
  forensic maps         every map and the combined locator at 256 and 384
                        px: atol 2e-4 + rtol 2e-3 (the forensic battery's
                        rule; sums and FFTs in another order, the combined
                        map's 4 → 8 bilinear resize in another order); the
                        JPEG residual map's blocks but ≤ 0.2 % of them,
                        those within 1e-3 (a DCT coefficient on a rounding
                        tie of coeff / q rounds the other way and moves its
                        block's recompression by one quantisation step:
                        measured 3 of 5,376 blocks, ≤ 3.1e-4)
  heatmap_overlay, forensic_panel_image, jitter_collage: uint8 within 1 on
                        every value, at most 5 % of them apart (truncation
                        to uint8 of floats that agree to ~1e-5: a resize of
                        equal neighbours lands on an integer, just below it
                        or not; measured ≤ 2.7 %, the 384 px panel's
                        resized original); the panel's JPEG residual tile
                        held through its map (the blocks above) and equal
                        to the port's coloring of it (a block a rounding
                        step off moved 0.35–1.2 % of that tile's values by
                        up to 7)
  render helpers        equal strings; report_json_file the same JSON
  predict_image         JAX's 9-tuple: the same arity and types (JAX's run
                        on a stub report: its engine's graph is not
                        compiled here), its images as above; the report
                        equals the port's predict_images on the same pixels
  app.main              under tests/_gradio_stub.py: two clicks, each
                        callback returns as many payloads as it declares
                        outputs
  cli.forensics         the PNG names JAX's CLI writes, scores.json's keys
                        JAX's battery's, the scores within the battery's
                        rule against JAX's battery on the same pixels
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests import _gradio_stub as stub
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_forensics import _battery_images
from tpudf.data import media as J_media
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.ops import forensic_maps as J_maps
from tpudf.ops import forensics as J_for
from tpudf.serve import app as J_app
from tpudf.serve import report as J_report
from tpudf_torch.data import media as T_media
from tpudf_torch.entry import build_engine
from tpudf_torch.ops import forensic_maps as T_maps
from tpudf_torch.serve import app as T_app
from tpudf_torch.serve.report import predict_images

RULE = dict(atol=2e-4, rtol=2e-3)
MAP_KEYS = ("prnu_strength", "prnu_fft", "cfa_anomaly", "jpeg_residual",
            "patch_variance", "multiscale_fft", "perlin", "combined")
UINT8_SHARE = 5e-2
JPEG_BLOCKS = 2e-3
JPEG_TILE = 4                 # the panel's jpeg_residual tile


def _uint8_close(got, want, label):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, (label, d.max())
    assert (d > 0).mean() <= UINT8_SHARE, (label, (d > 0).mean())


def _tiles(panel):
    """The nine 256 px tiles of a forensic panel, in order."""
    pad, title_h, cell = 4, 18, 256
    for i in range(9):
        r, c = divmod(i, 3)
        y = pad + r * (cell + title_h + pad) + title_h
        x = pad + c * (cell + pad)
        yield panel[y:y + cell, x:x + cell]


def _jpeg_tile(img):
    """The panel's JPEG residual tile as the port computes it from its own
    map: normalized, resized to 256 px, jet-colored."""
    from tpudf_torch.data.pipeline import resize
    x = torch.from_numpy(img[None].astype(np.float32)) / 255.0
    if x.shape[1] != 256:
        x = resize(x, (1, 256, 256, 3), "bilinear")
    m = T_maps._norm01(T_maps.jpeg_residual_map(x))[0]
    return T_maps.jet_colors(np.clip(resize(m, (256, 256), "bilinear")
                                     .numpy(), 0, 1))


def _panel_close(got, want, img, label):
    """_uint8_close tile by tile and on the whole canvas, but for the JPEG
    residual tile: held through its map (test_forensic_map_matches_jax's
    rule) and here equal to the port's coloring of that map."""
    assert got.shape == want.shape
    g, w = got.copy(), want.copy()
    for i, (a, b) in enumerate(zip(_tiles(g), _tiles(w))):
        if i == JPEG_TILE:
            np.testing.assert_array_equal(a, _jpeg_tile(img))
            a[...] = b
        else:
            _uint8_close(a, b, f"{label} tile {i}")
    _uint8_close(g, w, label)


def _photo(h, w, seed):
    """A splice test image: noise with a smooth pasted square (the JAX
    package's tests/test_forensic_maps.py recipe), uint8."""
    rng = np.random.default_rng(seed)
    img = np.clip(0.5 + 0.15 * rng.normal(0, 1, (h, w, 3)), 0, 1)
    s = min(h, w) * 3 // 8
    yy, xx = np.mgrid[0:s, 0:s] / s
    img[16:16 + s, 16:16 + s] = np.stack(
        [0.5 + 0.3 * yy, 0.5 + 0.3 * xx, np.full_like(yy, 0.4)], -1)
    return (img * 255).astype(np.uint8)


# ------------------------------------------------------------------ media

@pytest.fixture(scope="module")
def media_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    files = {}
    for name, (h, w) in {"ok.png": (96, 128), "ok.jpg": (120, 90),
                         "wide.png": (80, 2100), "small.png": (40, 200)
                         }.items():
        files[name] = str(d / name)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            files[name])
    files["flat.png"] = str(d / "flat.png")
    Image.fromarray(np.full((80, 80, 3), 120, np.uint8)).save(
        files["flat.png"])
    files["broken.jpg"] = str(d / "broken.jpg")
    with open(files["broken.jpg"], "wb") as f:
        f.write(b"not an image")
    return files


@pytest.mark.parametrize("name", ["ok.png", "ok.jpg", "wide.png",
                                  "flat.png"])
def test_load_image_any_matches_jax(media_files, name):
    got = T_media.load_image_any(media_files[name])
    np.testing.assert_array_equal(got, J_media.load_image_any(
        media_files[name]))
    assert T_media.is_near_constant(got) == J_media.is_near_constant(got)
    if name == "wide.png":
        assert max(got.shape[:2]) == T_media.MAX_SIDE


@pytest.mark.parametrize("name,match", [("small.png", "too small"),
                                        ("broken.jpg", "cannot decode")])
def test_load_image_any_refuses_like_jax(media_files, name, match):
    for mod in (T_media, J_media):
        with pytest.raises(mod.MediaError, match=match):
            mod.load_image_any(media_files[name])


def test_validate_image_matches_jax(media_files):
    flat = T_media.load_image_any(media_files["flat.png"])
    for mod in (T_media, J_media):
        with pytest.raises(mod.MediaError, match="near-constant"):
            mod.validate_image(flat)
    ok = T_media.load_image_any(media_files["ok.png"])
    assert T_media.validate_image(ok) is ok
    assert (T_media.MAX_PIXELS, T_media.MIN_SIDE, T_media.MAX_SIDE) == (
        J_media.MAX_PIXELS, J_media.MIN_SIDE, J_media.MAX_SIDE)


# ----------------------------------------------------------- forensic maps

_J_BATTERY = jax.jit(J_maps.forensic_map_battery)


def _map_inputs(size):
    """(B, size, size, 3) [0, 1]: the splice image and, at 256 px, two of
    the golden corpus' structured images."""
    x = _photo(size, size, seed=size)[None].astype(np.float32) / 255.0
    if size == 256:
        x = np.concatenate([x, _battery_images()[:2]])
    return x


@pytest.fixture(scope="module", params=[256, 384])
def map_pair(request):
    x = _map_inputs(request.param)
    got = T_maps.forensic_map_battery(torch.from_numpy(x))
    want = _J_BATTERY(jnp.asarray(x))
    return request.param, got, want


@pytest.mark.parametrize("key", MAP_KEYS)
def test_forensic_map_matches_jax(map_pair, key):
    _, got, want = map_pair
    assert set(got) == set(want) == set(MAP_KEYS)
    _map_close(got[key].numpy(), np.asarray(want[key]), key)


def _map_close(got, want, key):
    """The battery's rule; the JPEG residual map's on all but a share of
    its blocks (see the module docstring)."""
    assert got.shape == want.shape, key
    off = np.abs(got - want) > RULE["atol"] + RULE["rtol"] * np.abs(want)
    if key == "jpeg_residual":
        assert off.mean() <= JPEG_BLOCKS, (key, off.mean())
        assert np.abs(got - want).max() <= 1e-3, key
    else:
        assert not off.any(), (key, np.abs(got - want).max())


def test_maps_alone_and_reduced_match_jax():
    """The map functions the CLI's --reduced mode calls, alone, at a
    non-default block size too, and _smooth1d past its clamp."""
    x = _map_inputs(384)[:, :320, :256]
    gray = np.einsum("bhwc,c->bhw", x, np.float32([0.299, 0.587, 0.114]))
    t, j = torch.from_numpy(gray), jnp.asarray(gray)
    for fn, arg in (("prnu_strength_map", None), ("prnu_fft_consistency_map",
                                                  None),
                    ("cfa_anomaly_map", 16), ("patch_anomaly_map", 32),
                    ("perlin_noise_map", None), ("multiscale_fft_map", 64)):
        kw = {} if arg is None else {"block": arg}
        np.testing.assert_allclose(
            getattr(T_maps, fn)(t, **kw).numpy(),
            np.asarray(getattr(J_maps, fn)(j, **kw)), err_msg=fn, **RULE)
    _map_close(T_maps.jpeg_residual_map(torch.from_numpy(x)).numpy(),
               np.asarray(J_maps.jpeg_residual_map(jnp.asarray(x))),
               "jpeg_residual")
    sig = np.random.default_rng(1).random((3, 9)).astype(np.float32)
    np.testing.assert_allclose(
        T_maps._smooth1d(torch.from_numpy(sig), 3.0).numpy(),
        np.asarray(J_maps._smooth1d(jnp.asarray(sig), 3.0)), atol=1e-6,
        rtol=0)


def test_heatmap_overlay_matches_jax(map_pair):
    size, got, want = map_pair
    img = _photo(size, size, seed=size)
    _uint8_close(T_maps.heatmap_overlay(img, got["combined"][0]),
                 J_maps.heatmap_overlay(img, np.asarray(want["combined"])[0]),
                 "overlay")


@pytest.fixture()
def jitted_jax_maps(monkeypatch):
    """JAX's app helpers run the map battery eagerly (seconds of op-by-op
    dispatch here); the jitted battery computes the same maps."""
    monkeypatch.setattr(J_maps, "forensic_map_battery", _J_BATTERY)


@pytest.mark.parametrize("size", [64, 384])
def test_forensic_panel_matches_jax(size, jitted_jax_maps):
    img = _photo(size, size, seed=size + 1)
    _panel_close(T_app.forensic_panel_image(img, device="cpu"),
                 J_app.forensic_panel_image(img), img, f"panel {size}")


@pytest.mark.parametrize("shape,n", [((64, 64), 3), ((96, 80), 4)])
def test_jitter_collage_matches_jax(shape, n):
    img = _photo(*shape, seed=5)
    got = T_app.jitter_collage(img, n=n, device="cpu")
    assert got.shape == (shape[0], shape[1] * n, 3)
    _uint8_close(got, J_app.jitter_collage(img, n=n), "collage")


# -------------------------------------------------------------------- app

REPORTS = [
    {"final_label": "FAKE", "final_prob": 0.87, "band_text": "HIGH",
     "visual_prob": 0.9, "freq_prob": 0.6, "sora_likelihood": 0.2,
     "verdict": "likely synthetic"},
    {"video_label": "Likely Real", "video_prob": 0.21, "band": "LOW",
     "temporal_consistency_score": 0.93, "embedding_anomaly": 0.1},
    {"final_label": "INCONCLUSIVE"},
]


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_render_helpers_match_jax(i):
    rep = REPORTS[i]
    assert T_app.verdict_html(rep) == J_app.verdict_html(rep)
    assert T_app.metrics_html(rep) == J_app.metrics_html(rep)
    for p in (0.0, 0.555, 1.2, rep.get("final_prob", 0.5)):
        assert T_app.gauge_html(p) == J_app.gauge_html(p)
    probs = [0.1, 0.45, 0.61, 0.9][:i + 1]
    assert T_app.frames_timeline_html(probs) == J_app.frames_timeline_html(
        probs)
    assert T_app.frames_timeline_html([]) == J_app.frames_timeline_html([])
    path = T_app.report_json_file(rep)
    try:
        with open(path) as f:
            assert json.load(f) == json.loads(json.dumps(rep))
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def engine():
    """The port's test-32 engine (seeded random weights) on the CPU."""
    return build_engine("cpu", cfg_name="test-32")


def test_predict_image_matches_jax_contract(engine, monkeypatch,
                                            jitted_jax_maps):
    """The port's predict_image returns JAX's tuple: run JAX's on the same
    PIL image with its predict_images stubbed to return the port's report
    (so no JAX engine graph compiles), every payload of the same type;
    the images within 1; the port's report the port's predict_images of
    the same resized pixels."""
    pil = Image.fromarray(_photo(48, 48, seed=9))
    predict_image, _ = T_app.build_predict_fns(engine)
    got = predict_image(pil)
    px = np.array(pil.convert("RGB").resize((32, 32), Image.BICUBIC))
    want_rep = json.loads(json.dumps(predict_images(engine, px[None])[0],
                                     default=float))
    assert json.loads(got[7]) == want_rep
    monkeypatch.setattr(J_report, "predict_images",
                        lambda eng, pixels, fast=False: [want_rep])
    want = J_app.build_predict_fns(types.SimpleNamespace(
        cfg=J_CONFIGS["test-32"]))[0](pil)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert type(g) is type(w)
    for k in (0, 1, 2, 3, 7):
        assert got[k] == want[k], k
    _uint8_close(got[4], want[4], "overlay")
    _panel_close(got[5], want[5], px, "panel")
    _uint8_close(got[6], want[6], "collage")
    for path in (got[8], want[8]):
        with open(path) as f:
            assert json.load(f)["final_label"] == want_rep["final_label"]
        os.unlink(path)


def test_app_main_with_gradio_stub(monkeypatch, tmp_path):
    """serve/app.main's Blocks graph under the gradio stub: it builds its
    engine through tpudf_torch.cli.infer.build_engine (--device cpu), and
    each recorded callback returns as many payloads as its click declares
    outputs; without gradio it exits naming the port's batch CLI."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="tpudf_torch.cli.infer"):
        T_app.main(["--model_size", "test-32", "--device", "cpu"])
    stub.Blocks.instances.clear()
    monkeypatch.setitem(sys.modules, "gradio", stub)
    T_app.main(["--model_size", "test-32", "--device", "cpu", "--int8",
                "--tome_r"])
    demo, = stub.Blocks.instances
    assert demo.launched == {"share": False}
    (img_fn, img_in, img_out), (vid_fn, vid_in, vid_out) = demo.clicks
    assert isinstance(img_in, stub.Image) and isinstance(vid_in, stub.Video)
    rng = np.random.default_rng(0)
    payload = img_fn(Image.fromarray(rng.integers(0, 256, (32, 32, 3),
                                                  np.uint8)))
    assert len(payload) == len(img_out) == 9
    assert "<div" in payload[0] and os.path.exists(payload[-1])
    os.unlink(payload[-1])
    cv2 = pytest.importorskip("cv2")
    vid = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for _ in range(5):
        w.write(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    w.release()
    payload = vid_fn(vid)
    assert len(payload) == len(vid_out) == 10
    assert isinstance(payload[6], list) and len(payload[6][0]) == 3
    assert json.loads(payload[8])["video_label"]
    os.unlink(payload[-1])
    payload = vid_fn(str(tmp_path / "missing.mp4"))
    assert len(payload) == 10 and payload[0] == "<div>DECODE FAILED</div>"
    os.unlink(payload[-1])


# ---------------------------------------------------------- cli.forensics

_J_SCORES = jax.jit(J_for.forensic_battery)


@pytest.mark.parametrize("reduced", [False, True])
def test_cli_forensics_matches_jax(tmp_path, reduced):
    """The CLI on a 300 × 420 JPEG: the PNGs JAX's CLI writes (its map
    battery's keys, or the three of --reduced), scores.json's keys JAX's
    battery's, each score within the battery's rule of JAX's battery on
    the same 256 px pixels (computed in a batch of the forensics test's
    shape, so its jitted graph is shared)."""
    from tpudf_torch.cli import forensics
    src = str(tmp_path / "photo.jpg")
    Image.fromarray(_photo(300, 420, seed=12)).save(src, quality=90)
    out = str(tmp_path / "out")
    forensics.main([src, "--out_dir", out, "--device", "cpu"]
                   + (["--reduced"] if reduced else []))
    names = (["prnu_strength", "prnu_fft", "jpeg_residual"] if reduced
             else list(MAP_KEYS))
    assert sorted(os.listdir(out)) == sorted(
        [f"{n}.png" for n in names] + ["scores.json"])
    with open(os.path.join(out, "scores.json")) as f:
        scores = json.load(f)
    arr = J_media.validate_image(J_media.load_image_any(src))
    img256 = np.asarray(Image.fromarray(arr).resize((256, 256)), np.uint8)
    x = np.concatenate([img256[None].astype(np.float32) / 255.0,
                        _battery_images()[1:]])
    want = {k: float(np.asarray(v)[0])
            for k, v in _J_SCORES(jnp.asarray(x)).items()}
    assert set(scores) == set(want)
    for k in want:
        np.testing.assert_allclose(scores[k], want[k], err_msg=k, **RULE)
    with Image.open(os.path.join(out, f"{names[-1]}.png")) as im:
        assert im.size == (256, 256)
