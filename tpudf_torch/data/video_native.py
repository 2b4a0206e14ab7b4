"""ctypes binding to the C++ video frame sampler (cpp/video.cc), as
tpudf/data/video_native.py binds it: the repo's library
cpp/libtpudf_video.so (built by `make -C cpp`; this module loads it where
it lies and never builds it). The native sampler replaces
the reference's cv2 seek-decode host path (appv3.py:611-786 scan +
:719-786 extraction; hidf_video_classifier.py:106-149): two multithreaded
sequential libavcodec passes instead of a full-video scan plus one GOP
re-decode per sampled frame. Callers (data/video.py) fall back to cv2 when
the library is absent.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(here, "cpp", "libtpudf_video.so"),
                 "libtpudf_video.so"):
        try:
            lib = ctypes.CDLL(cand)
            lib.tpudf_sample_video.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)]
            lib.tpudf_sample_video.restype = ctypes.c_int
            _LIB = lib
            break
        except OSError:
            continue
    return _LIB


def available() -> bool:
    return _load() is not None


def sample_video_native(path: str, max_samples=12, stride=5,
                        cut_thresh=0.45, size=256, scene_aware=True):
    """Scan + scene-aware pick + decode in native code.

    Returns (uint8 (T, size, size, 3), frame_indices) like
    data/video.sample_video, or (None, []) when the library is absent or
    the container cannot be decoded (caller falls back to cv2).
    """
    lib = _load()
    if lib is None:
        return None, []
    out = np.empty((max_samples, size, size, 3), np.uint8)
    idx = np.full(max_samples, -1, np.int32)
    n = lib.tpudf_sample_video(
        os.fsencode(path), int(max_samples), int(stride),
        float(cut_thresh), int(size), int(bool(scene_aware)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if n <= 0:
        return None, []
    return out[:n].copy(), [int(i) for i in idx[:n]]
