"""The port's frame sampler (tpudf_torch/data/video.py, video_native.py)
against the JAX package's, on the CPU: no JAX graph (both are numpy, cv2
and the ctypes binding of cpp/libtpudf_video.so).

A seeded clip (the golden recipe rolled 2 px a frame, another image from
frame 45 on) is written by cv2 (mp4v) to tmp_path, then sampled by both
packages: the scene-aware native route (where the library loads here),
the cv2 route, the uniform route and a clip too short for the scan. The
indices and every frame are equal; the scan, the primary-scene pick and
the adaptive pick on seeded inputs are equal.
"""

import numpy as np
import pytest

from tests.test_report_golden import _images
from tpudf.data import video as j_video
from tpudf.data import video_native as j_native
from tpudf_torch.data import video as t_video
from tpudf_torch.data import video_native as t_native


def _write(path, n, cut, size=96):
    import cv2
    img = _images(3, size)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                        (size, size))
    assert w.isOpened()
    for i in range(n):
        f = np.roll(img[0] if i < cut else img[2], 2 * i, axis=1)
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("video")
    return {"long": _write(d / "long.mp4", 90, 45),
            "short": _write(d / "short.mp4", 20, 10)}


def _same(got, want):
    (gf, gi), (wf, wi) = got, want
    assert gi == wi
    assert gf is not None and wf is not None
    np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("clip", ["long", "short"])
@pytest.mark.parametrize("route", ["native", "cv2", "uniform"])
def test_sample_video_matches_jax(clips, route, clip):
    kw = {"native": {}, "cv2": dict(prefer_native=False),
          "uniform": dict(prefer_native=False, scene_aware=False)}[route]
    if route == "native":
        if not j_native.available():
            pytest.skip("cpp/libtpudf_video.so does not load here")
        assert t_native.available()
        _same(t_native.sample_video_native(clips[clip]),
              j_native.sample_video_native(clips[clip]))
    got = t_video.sample_video(clips[clip], max_samples=8, size=64, **kw)
    _same(got, j_video.sample_video(clips[clip], max_samples=8, size=64,
                                    **kw))
    assert got[0].shape[1:] == (64, 64, 3) and len(got[1]) >= 3


def test_sample_video_missing_file(tmp_path):
    path = str(tmp_path / "none.mp4")
    assert t_video.sample_video(path, prefer_native=False) == \
        j_video.sample_video(path, prefer_native=False) == (None, [])


@pytest.mark.parametrize("seed", range(3))
def test_scene_scan_and_picks_match_jax(seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (60, 16, 16, 3), np.uint8)
    frames[30:] //= 3                                    # a scene cut
    read = lambda i: frames[i] if i % 17 else None       # some reads fail
    got = t_video.scan_video_changes(read, 60, stride=2)
    want = j_video.scan_video_changes(read, 60, stride=2)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for cut in (0.1, 0.45):
        assert t_video.pick_primary_scene(*got, cut) == \
            j_video.pick_primary_scene(*want, cut)
    for m, gap in ((6, 2), (12, 4), (40, 1)):
        assert t_video.adaptive_sample_indices(*got, m, gap) == \
            j_video.adaptive_sample_indices(*want, m, gap)
