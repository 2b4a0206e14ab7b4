"""The safetensors file format read and written with numpy alone.

The port's one reader and writer of the format: the expert artifacts
(freq_mlp.safetensors, freq_mlp_v5.safetensors, fusion_head.safetensors)
and the published backbone checkpoints that `models/convert.py` reads are
safetensors files, and the `safetensors` package is not installed
everywhere the port runs (the card's machine has none). The format is
small: an 8-byte little-endian header length, a JSON
header {name: {"dtype", "shape", "data_offsets": [begin, end]}} padded
with spaces to a multiple of 8 bytes, then the tensors' bytes, row-major,
little-endian, back to back. Files written here load in
`safetensors.numpy.load_file`, and `load_file` reads what it writes.
numpy has no bfloat16, so `load_file` widens a BF16 tensor to f32 (its
16 bits are the top half of the f32's, exactly) and `save_file` writes
none.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
           "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: dict, path: str) -> None:
    """Write {name: numpy array} to `path` in the safetensors format."""
    header, blobs, offset = {}, [], 0
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        if a.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors "
                            f"name here")
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def load_file(path: str) -> dict:
    """{name: numpy array} of a safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            half = np.frombuffer(body[begin:end], dtype="<u2")
            out[name] = (half.astype(np.uint32) << 16).view(
                np.float32).reshape(info["shape"])
            continue
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = np.frombuffer(body[begin:end], dtype=dt).reshape(
            info["shape"]).astype(dt.newbyteorder("="))
    return out
