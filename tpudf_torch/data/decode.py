"""ctypes binding to the C++ batch JPEG decoder (cpp/decode.cc), as
tpudf/data/decode.py binds it: the repo's library cpp/libtpudf_decode.so
(built by `make -C cpp`; this module loads it where it lies, or
libtpudf_decode.so on the loader path, and never builds it). Where the
library is absent every function returns None, and callers
(data/datasets.py) decode with PIL.
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
    for cand in (os.path.join(here, "cpp", "libtpudf_decode.so"),
                 "libtpudf_decode.so"):
        try:
            lib = ctypes.CDLL(cand)
            lib.tpudf_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
            lib.tpudf_decode_batch.restype = None
            lib.tpudf_decode_jpeg_mem.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.tpudf_decode_jpeg_mem.restype = ctypes.c_int
            _LIB = lib
            break
        except OSError:
            continue
    return _LIB


def available() -> bool:
    """True when the native decoder loads."""
    return _load() is not None


def decode_batch(paths: list[str], size: int, n_threads: int = 8):
    """Decode + resize a batch of JPEGs → (uint8 (N, size, size, 3), status
    (N,) int32, 0 = ok), or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.tpudf_decode_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, status


def decode_resize(path: str, size: int):
    """One `.jpg` / `.jpeg` file decoded and resized to uint8 (size, size,
    3); None for another extension, a failed decode or no library."""
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    res = decode_batch([path], size, n_threads=1)
    if res is None:
        return None
    out, status = res
    return out[0] if status[0] == 0 else None
