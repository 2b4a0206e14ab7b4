"""The port's head-checkpoint helpers and public forensic helpers against
the JAX package's, on the CPU. Inputs are made with numpy from a seed.

  save_head_safetensors  a tree with a transposed leaf and a list: the
        same key set and bit-equal arrays from both packages' files
  load_state_filtered    a state dict with a missing, a mis-shaped and
        an extra key: equal leaves (the template's where not loaded, on
        its dtype), the template's structure, and JAX's log lines
  detect_feature_dim     768 / 1024 / 1152 and none: equal
  srm_residuals, blockwise_dct_energy, patchify (f32)   within 1e-5 of
        JAX's max |value|; SRM_KERNELS equal
  rendering_pipeline_score on 3-frame 64 px clips    atol 2e-4 + rtol
        2e-3, the rule tests/test_torch_port_report.py holds
        render_score to; 0.0 for fewer than 2 frames
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_report_golden import _images
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_flow import GOLDEN, mirror_images
from tpudf.fuse import temporal as J_temporal
from tpudf.models import siglip as J_siglip
from tpudf.ops import dct as J_dct
from tpudf.ops import srm as J_srm
from tpudf.train import checkpoint as J_ckpt
from tpudf_torch.fuse import temporal as T_temporal
from tpudf_torch.models import siglip as T_siglip
from tpudf_torch.ops import dct as T_dct
from tpudf_torch.ops import srm as T_srm
from tpudf_torch.train import checkpoint as T_ckpt
from tpudf_torch.utils.safetensors_io import load_file


def _head(rng):
    """A small head tree (numpy): a transposed (non-contiguous) leaf, a
    list of layers, mixed dtypes."""
    w = rng.standard_normal((24, 16)).astype(np.float32)
    return {"fc": {"w": w.T, "b": rng.standard_normal(24).astype(np.float32)},
            "layers": [{"w": rng.standard_normal((16, 8)).astype(np.float32),
                        "n": np.arange(3, dtype=np.int32)}
                       for _ in range(2)],
            "scale": np.float32(0.5)}


def _torch_tree(tree):
    """The same tree as tensors; the transposed leaf stays a view."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if isinstance(tree, np.ndarray) and not tree.flags.c_contiguous:
        return torch.from_numpy(np.ascontiguousarray(tree.T)).t()
    return torch.as_tensor(np.asarray(tree))


def test_save_head_safetensors_matches_jax(tmp_path):
    tree = _head(np.random.default_rng(0))
    tt = _torch_tree(tree)
    assert not tt["fc"]["w"].is_contiguous()
    J_ckpt.save_head_safetensors(str(tmp_path / "j.safetensors"), tree)
    T_ckpt.save_head_safetensors(str(tmp_path / "t.safetensors"), tt)
    want = load_file(str(tmp_path / "j.safetensors"))
    got = load_file(str(tmp_path / "t.safetensors"))
    assert sorted(got) == sorted(want) == [
        "fc.b", "fc.w", "layers.0.n", "layers.0.w", "layers.1.n",
        "layers.1.w", "scale"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["fc.w"], tree["fc"]["w"])


def test_load_state_filtered_matches_jax():
    rng = np.random.default_rng(1)
    template = _head(rng)
    sd = _head(rng)
    del sd["layers"][1]["w"]                           # missing
    sd["fc"]["b"] = np.zeros(25, np.float32)           # mis-shaped
    sd["extra"] = np.ones(4, np.float32)               # not in the template
    sd["layers"][0]["w"] = sd["layers"][0]["w"].astype(np.float64)
    j_log, t_log = [], []
    want = J_ckpt.load_state_filtered(sd, template, log_fn=j_log.append)
    t_template = _torch_tree(template)
    got = T_ckpt.load_state_filtered(_torch_tree(sd), t_template,
                                     log_fn=t_log.append)
    assert t_log == j_log and len(j_log) == 3
    assert j_log[-1] == "[ckpt] loaded 5/7 tensors"
    flat_w, flat_g = J_ckpt._flatten(want), T_ckpt._flatten(got)
    assert list(flat_g) == list(flat_w)
    flat_t = T_ckpt._flatten(t_template)
    for k, v in flat_w.items():
        assert torch.is_tensor(flat_g[k]), k
        assert flat_g[k].dtype == flat_t[k].dtype, k      # the template's
        np.testing.assert_array_equal(
            flat_g[k].numpy(), np.asarray(v).astype(flat_g[k].numpy().dtype))
    # not loaded: the template's own leaves
    np.testing.assert_array_equal(got["fc"]["b"].numpy(), template["fc"]["b"])
    np.testing.assert_array_equal(got["layers"][1]["w"].numpy(),
                                  template["layers"][1]["w"])


@pytest.mark.parametrize("dim", [768, 1024, 1152, None])
def test_detect_feature_dim_matches_jax(dim):
    rng = np.random.default_rng(2)
    sd = {"norm": {"scale": rng.standard_normal(64).astype(np.float32)},
          "proj": {"w": rng.standard_normal((64, 32)).astype(np.float32)}}
    if dim is not None:
        sd["head"] = {"w": rng.standard_normal((dim, 2)).astype(np.float32)}
    want = J_ckpt.detect_feature_dim(sd)
    assert T_ckpt.detect_feature_dim(_torch_tree(sd)) == want == dim
    assert T_ckpt.detect_feature_dim(sd) == want


def _close_to_max(got, want, rel=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_srm_residuals_match_jax():
    g = np.random.default_rng(3).random((2, 40, 48), np.float32)
    want = J_srm.srm_residuals(jnp.asarray(g))
    got = T_srm.srm_residuals(torch.from_numpy(g))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _close_to_max(a.numpy(), b)
    for a, b in zip(T_srm.SRM_KERNELS, J_srm.SRM_KERNELS, strict=True):
        np.testing.assert_array_equal(a, b)


def test_blockwise_dct_energy_matches_jax():
    g = np.random.default_rng(4).random((2, 32, 48), np.float32) * 255.0
    want = J_dct.blockwise_dct_energy(jnp.asarray(g))
    got = T_dct.blockwise_dct_energy(torch.from_numpy(g))
    assert got.shape == (2, 4, 6)
    _close_to_max(got.numpy(), want)


def test_patchify_matches_jax():
    px = np.random.default_rng(5).random((2, 32, 48, 3), np.float32)
    want = J_siglip.patchify(jnp.asarray(px), 16)
    got = T_siglip.patchify(torch.from_numpy(px), 16)
    assert got.shape == (2, 6, 768)
    _close_to_max(got.numpy(), want)


def _clips():
    return {"mirror": mirror_images(64, (0.0, 0.7, 1.5)),
            "golden": _images(3, 64)}


@pytest.mark.parametrize("name", ["mirror", "golden"])
def test_rendering_pipeline_score_matches_jax(name):
    clip = _clips()[name]
    want = J_temporal.rendering_pipeline_score(list(clip))
    got = T_temporal.rendering_pipeline_score(list(clip))
    assert isinstance(got, float) and 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, **GOLDEN)
    assert T_temporal.rendering_pipeline_score(torch.from_numpy(clip)) == got


def test_rendering_pipeline_score_short_clips():
    clip = _clips()["mirror"]
    for frames in (None, [], list(clip[:1])):
        assert (T_temporal.rendering_pipeline_score(frames)
                == J_temporal.rendering_pipeline_score(frames) == 0.0)
