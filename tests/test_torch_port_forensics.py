"""Parity of the port's forensic battery and face cues with the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX's
graphs are jitted once per module.
  forensic_battery   cue by cue at (5, 256, 256, 3): the golden corpus'
       structured images (`tests/test_report_golden.py::_images` at 256 px),
       a flat grey image and two of uniform uint8 noise, within atol 2e-4
       + rtol 2e-3 (the goldens' own rule; measured: at most 5.1e-5,
       benford_wavelet), but for a cue shown to be a step at ties: a
       binned cue (color_harmony on the noise images, 5.9e-3 / 1.33e-2) that
       agrees with JAX's op-by-op run of it, which differs from JAX's
       jitted graph by the same step. The key set is JAX's.
  fft2_mag ± shifted   atol 1e-3 + rtol 1e-5 (one FFT in another library)
  face_region_retouch_score (and the batched `retouch_scores`) against
       JAX's, atol 2e-4 + rtol 2e-3; `_crop_from_box` equal, with and
       without the PIL resize
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_report_golden import _images
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.ops import fft_features as J_fft
from tpudf.ops import forensics as J_for
from tpudf.serve import face as J_face
from tpudf_torch.ops import fft_features as T_fft
from tpudf_torch.ops import forensics as T_for
from tpudf_torch.serve import face as T_face

GOLDEN = dict(atol=2e-4, rtol=2e-3)


def _battery_images():
    """The goldens' structured images at 256 px, a flat grey one and two
    of uniform uint8 noise (the hue and grey-level histograms of uint8
    values put many pixels on bin edges)."""
    imgs = _images(2, 256).astype(np.float32) / 255.0
    flat = np.full((1, 256, 256, 3), 0.5, np.float32)
    noise = np.random.default_rng(28).integers(0, 256, (2, 256, 256, 3))
    return np.concatenate([imgs, flat, noise.astype(np.float32) / 255.0])


# JAX's function of each cue that bins, thresholds or rounds a float
# (tpudf_torch.ops.forensics.TIE_STEPS) and of the composites over them,
# with its arguments
J_BINNED = {
    "benford_wavelet": (J_for.benford_wavelet_score, "gray"),
    "color_harmony": (J_for.color_harmony_score, "img"),
    "exposure_variation": (J_for.exposure_variation, "gray"),
    "glcm_contrast": (J_for.hf_glcm_contrast, "gray"),
    "highlight_clipping": (J_for.highlight_clipping_realness, "gray"),
    "histogram_consistency": (J_for.histogram_consistency, "img"),
    "multiscale_fft": (J_for.multiscale_fft_confidence, "gray"),
    "saturation_peak": (J_for.saturation_peak_score, "img"),
    "self_similarity": (J_for.self_similarity_anomaly_score, "img"),
    "real_prior_v3": (J_for.real_image_prior_v3, "img, gray"),
    "real_prior_agg": (J_for.real_prior_v2_aggregate, "img, gray"),
}


def _jax_op_by_op(key, x):
    """JAX's cue `key` run op by op (no jit): each op rounds as it would
    alone, as torch's do; XLA's fused graph may rewrite them (e.g. fold
    hue * 30 / 5 into one product)."""
    fn, args = J_BINNED[key]
    img = jnp.asarray(x)
    gray = jnp.einsum("bhwc,c->bhw", img,
                      jnp.asarray([0.299, 0.587, 0.114]))
    return np.asarray(fn(*[{"img": img, "gray": gray}[a.strip()]
                           for a in args.split(",")]))


@pytest.fixture(scope="module")
def batteries():
    x = _battery_images()
    want = jax.jit(J_for.forensic_battery)(jnp.asarray(x))
    got = T_for.forensic_battery(torch.from_numpy(x))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_battery_keys_are_jax():
    shapes = jax.eval_shape(J_for.forensic_battery,
                            jax.ShapeDtypeStruct((1, 256, 256, 3),
                                                 jnp.float32))
    assert T_for.BATTERY_KEYS == tuple(sorted(shapes))


@pytest.mark.parametrize("key", T_for.BATTERY_KEYS)
def test_battery_cue_matches_jax(batteries, key):
    """Each cue within the goldens' rule of JAX's jitted battery, or, for
    a binned cue, shown to be a step at ties: within the rule of JAX's
    own op-by-op run of it, which differs from JAX's jitted graph by the
    same step (measured on the noise images: color_harmony 5.9e-3 and
    1.33e-2)."""
    want, got = batteries
    assert got[key].shape == want[key].shape == (5,)
    lim = GOLDEN["atol"] + GOLDEN["rtol"] * np.abs(want[key])
    off = np.abs(got[key] - want[key]) > lim
    if off.any():
        assert key in J_BINNED, key
        eager = _jax_op_by_op(key, _battery_images())
        np.testing.assert_allclose(got[key], eager, err_msg=key, **GOLDEN)
        jax_step = np.abs(eager - want[key])
        assert (jax_step[off] > lim[off]).all(), key


@pytest.mark.parametrize("shifted", [False, True])
def test_fft2_mag_matches_jax(shifted):
    x = np.random.default_rng(2).standard_normal((2, 64, 48)).astype(
        np.float32)
    want = np.asarray(J_fft.fft2_mag(jnp.asarray(x), shifted=shifted,
                                     use_matmul_dft=False))
    got = T_fft.fft2_mag(torch.from_numpy(x), shifted=shifted).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)


def _face(seed, h=120, w=100):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 0.5 + 0.3 * np.sin(7 * yy + 3 * xx)[..., None] \
        + 0.04 * rng.standard_normal((h, w, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def test_face_retouch_score_matches_jax():
    crops = [_face(1), _face(2, 256, 256)]
    for c in crops:
        np.testing.assert_allclose(T_face.face_region_retouch_score(c),
                                   J_face.face_region_retouch_score(c),
                                   **GOLDEN)
    # the batched form the report launches, on 256 px crops
    from tpudf.serve.report import _retouch_graph
    batch = np.stack([_face(3, 256, 256), _face(4, 256, 256)])
    want = np.asarray(_retouch_graph()(jnp.asarray(batch)))
    got = T_face.retouch_scores(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, want, **GOLDEN)


@pytest.mark.parametrize("out_size", [None, 112])
def test_crop_from_box_matches_jax(out_size):
    img = _face(5, 200, 180)
    for box in ((20, 30, 60, 80), (0, 0, 150, 150), (150, 170, 40, 30)):
        np.testing.assert_array_equal(
            T_face._crop_from_box(img, box, out_size=out_size),
            J_face._crop_from_box(img, box, out_size=out_size))


def benford_tie_steps(img):
    """Show that a benford_wavelet difference between the packages on
    (B, H, W, 3) [0,1] `img` is a step at ties: the leading digit of a
    Haar coefficient that sits on a digit boundary (d·10^k; quantised,
    piecewise-flat images have many). Asserts that the port's Benford
    distance of JAX's own detail bands is JAX's, that the two packages'
    bands differ by float rounding only, and that every coefficient whose
    leading digit differs lies within 1e-4 (relative) of a boundary.
    Returns the number of such coefficients per image."""
    from tpudf.ops.dwt import haar_dwt2 as j_haar
    from tpudf_torch.ops.dwt import haar_dwt2
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    j_gray = jnp.einsum("bhwc,c->bhw", jnp.asarray(img), jnp.asarray(w))
    t_gray = T_for._gray(torch.from_numpy(np.asarray(img)))
    _, j_bands = j_haar(j_gray * 255.0)
    _, t_bands = haar_dwt2(t_gray * 255.0)
    b = img.shape[0]
    flips = np.zeros(b, int)
    for jb, tb in zip(j_bands, t_bands):
        jb = np.array(jb).reshape(b, -1)
        tb = tb.numpy().reshape(b, -1)
        np.testing.assert_allclose(
            T_for.benford_distance(torch.from_numpy(jb)).numpy(),
            np.asarray(J_for.benford_distance(jnp.asarray(jb))), atol=1e-6)
        np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=1e-5)
        lead = lambda x: np.floor(x / 10.0 ** np.floor(np.log10(
            np.maximum(x, 1.0)) + 1e-9)).astype(int)
        ja, ta = np.abs(jb).astype(np.float64), np.abs(tb).astype(np.float64)
        differ = (lead(ja) != lead(ta)) & ((ja > 1) | (ta > 1))
        near = np.round(ja / 10.0 ** np.floor(np.log10(np.maximum(
            ja, 1e-30)) + 1e-6))
        near = near * 10.0 ** np.floor(np.log10(np.maximum(ja, 1e-30))
                                       + 1e-6)
        on_tie = np.abs(ja - near) <= 1e-4 * np.maximum(ja, 1.0)
        assert on_tie[differ].all()
        flips += differ.sum(1)
    return flips
