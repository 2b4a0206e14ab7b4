"""Parity of the port's dense flow and rendering score with the JAX
package, on the CPU.

Inputs are made with numpy from a seed; JAX's graphs are jitted once per
module (one graph for the flow and the clip score, one for the rendering
score).
  dense_flow on a 64 px clip moved by 2 px   u, v within atol 1e-2 px
       (measured 1.4e-3 on flows up to 41 px: iterated solves over sums
       in another order)
  exposure_blur_regularity on a 3-frame 64 px clip   atol 2e-4 + rtol 2e-3
  render_scores_graph on 40 px images (not a multiple of 16: resized to
       256 px first) whose horizontal flips are near-mirrors, so that the
       blur term is neither 0 nor 1   atol 2e-4 + rtol 2e-3; its 64 px
       form (no resize) is held in tests/test_torch_port_tail.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_report_golden import _images
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.fuse.temporal import render_scores_graph as j_render
from tpudf.ops.flow import dense_flow as j_flow
from tpudf.ops.flow import exposure_blur_regularity as j_expo
from tpudf_torch.fuse.temporal import render_scores_graph
from tpudf_torch.ops.flow import dense_flow, exposure_blur_regularity

GOLDEN = dict(atol=2e-4, rtol=2e-3)


def mirror_images(size, shifts=(0.0, 0.7, 1.5, 3.0), seed=0):
    """Vertical bars symmetric about a line `shift` px off the centre, with
    a little noise: uint8 (len(shifts), size, size, 3). The image and its
    flip differ by a small motion, so the rendering score's blur term
    moves between 0 and 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for s in shifts:
        d = np.abs(xx - (size - 1) / 2 + s)
        img = 128 + 100 * np.sign(np.sin(d / 3.0)) * (
            0.6 + 0.4 * np.cos(yy / 9.0))
        img = img + rng.normal(0, 3, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.repeat(np.stack(out)[..., None], 3, -1)


def _clips():
    a = _images(2, 64)[..., 0].astype(np.float32)
    b = np.roll(a, 2, axis=2)
    g = (mirror_images(64, (0.7, 1.5, 0.0))[..., 0].astype(np.float32)
         / 255.0)
    return a, b, g


@pytest.fixture(scope="module")
def flows():
    a, b, g = _clips()
    want = jax.jit(lambda a, b, g: (j_flow(a, b), j_expo(g)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    got = (dense_flow(torch.from_numpy(a), torch.from_numpy(b)),
           exposure_blur_regularity(torch.from_numpy(g)))
    return jax.tree.map(np.asarray, want), got


def test_dense_flow_matches_jax(flows):
    (wu, wv), _ = flows[0]
    (gu, gv), _ = flows[1]
    assert np.abs(wu).max() > 1.0           # the flow is not trivial
    np.testing.assert_allclose(gu.numpy(), wu, atol=1e-2, rtol=0)
    np.testing.assert_allclose(gv.numpy(), wv, atol=1e-2, rtol=0)


def test_exposure_blur_regularity_matches_jax(flows):
    _, (we, wb) = flows[0]
    _, (ge, gb) = flows[1]
    assert 0.0 < float(wb) < 1.0
    np.testing.assert_allclose(float(ge), float(we), **GOLDEN)
    np.testing.assert_allclose(float(gb), float(wb), **GOLDEN)


def test_render_score_resized_matches_jax():
    px = mirror_images(40, (0.0, 0.4, 1.0, 4.0), seed=1)
    want = np.asarray(jax.jit(j_render)(jnp.asarray(px)))
    got = render_scores_graph(torch.from_numpy(px)).numpy()
    assert ((want > 0.55) & (want < 1.0)).any()      # blur in (0, 1)
    np.testing.assert_allclose(got, want, **GOLDEN)
