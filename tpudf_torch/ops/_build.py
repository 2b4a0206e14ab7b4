"""Build and load the hand-written Hopper kernels.

At first use, `nvcc` compiles every `tpudf_torch/csrc/*.cu` for `sm_90a`,
one process per source, all started together, and links the objects into
ONE shared library with a plain C interface under `build/tpudf_torch/` at
the repository root (git-ignored); the library is loaded with ctypes.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as `void*`,
launches on that stream, and returns `cudaGetLastError()`; `call` raises
when that is not 0, so a refused launch (too many threads, too much shared
memory) is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from tpudf_torch.core.backend import is_hopper, require_cuda

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpudf_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signature of each entry point: p = pointer (c_void_p), i = int, f = float
SIGNATURES = {
    "tpudf_layer_norm_bf16": "ppppiiifp",
    "tpudf_ln_quant_i8": "pppppiiifp",
    "tpudf_ln_quant_f32": "pppppiifp",
    "tpudf_ln_max_width": "i",
    "tpudf_i8_gemm": "pppppppppiiiip",
    "tpudf_i8_gemm_tile_n": "ii",
    "tpudf_attention_i8_sm90": "ppppiiiiifip",
    "tpudf_attention_qkv_sm90": "pppiiiifp",
    "tpudf_attention_qkv_bwd_sm90": "ppppiiiifp",
    "tpudf_bf16_gemm": "pppppiiiip",
    "tpudf_srm_moments": "pppppiiip",
    "tpudf_srm_plan": "iiii",
    "tpudf_ln_qkv_i8": "ppppppppiiifp",
    "tpudf_ln_qkv_splits": "ii",
    "tpudf_attn_out_i8": "pppppppiiiiiifp",
    "tpudf_attn_out_cluster": "iiiiii",
    "tpudf_attn_out_smem": "ii",
    "tpudf_attn_out_waves": "iii",
    "tpudf_layer_cluster": "iiiiii",
    "tpudf_layer_smem": "iii",
    "tpudf_attention_i8dyn": "pppiiiiifp",
    "tpudf_attention_i8_prepass": "pppppiiiiip",
    "tpudf_attention_i8dyn_sm90": "pppppiiiiifp",
    "tpudf_layer_i8": "p" * 22 + "iiiiiiiffp",
    "tpudf_attention_plain_f32": "pppp" + "i" * 11 + "fp",
    "tpudf_attention_plain_sm90": "pppp" + "i" * 11 + "fp",
    "tpudf_attention_i8_static_prepass": "pppiiiiffp",
    "tpudf_attention_i8_static": "ppppiiiifffp",
    "tpudf_i8_gemm_quant": "ppppppiiiip",
    "tpudf_quant_rows_i8": "pppiip",
    "tpudf_sm90_encode_ns": "pi",
    "tpudf_sm90_smem": "iii",
    "tpudf_plain_sm90_smem": "i",
    "tpudf_plain_f32_smem": "i",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc calls, None if reused
build_log = None       # path of nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("tpudf_torch: nvcc not found (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile_and_link(so: Path, log: Path) -> None:
    """One nvcc per source, all in flight together, then one link."""
    global build_seconds
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    outs = [p.communicate()[0] for p in procs]
    failed = [(src.name, out) for src, p, out in zip(_sources(), procs, outs)
              if p.returncode != 0]
    tmp = so.with_suffix(f".{tag}")
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.stdout + link.stderr))
    build_seconds = time.perf_counter() - t0
    log.write_text("".join(outs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"[{name}]\n{out[-8000:]}" for name, out in failed))
    os.replace(tmp, so)


def load():
    """Build (once) and return the ctypes library of all kernels."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        require_cuda()
        if not is_hopper():
            raise RuntimeError("tpudf_torch kernels are built for sm_90a "
                               "(Hopper); this card is "
                               f"{torch.cuda.get_device_name()}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libtpudf_kernels-{_digest()}.so"
        log = so.with_suffix(".log")
        if not so.exists():
            _compile_and_link(so, log)
        build_log = log
        lib = ctypes.CDLL(str(so))
        for name, sig in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def call(name: str, *args) -> None:
    """Launch entry point `name` on the current stream and raise on a
    launch error. Tensor arguments are passed as their device pointers
    (None as NULL) and stay referenced by `args` until the launch is
    enqueued; the stream is appended as the last argument."""
    fn = getattr(load(), name)
    dev = torch.cuda.current_device()
    for a in args:
        # 16-byte alignment for the kernels' vector loads (a scalar: its own)
        align = 1
        if torch.is_tensor(a):
            align = 16 if a.numel() > 1 else a.element_size()
        if torch.is_tensor(a) and not (a.is_cuda and a.get_device() == dev
                                       and a.is_contiguous()
                                       and a.data_ptr() % align == 0):
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"aligned on cuda:{dev}, got {a.device} "
                             f"{tuple(a.shape)}")
    raw = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    err = fn(*raw, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
