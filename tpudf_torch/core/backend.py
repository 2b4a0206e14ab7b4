"""Device probes and per-kernel launch counters.

Every kernel wrapper in `tpudf_torch.ops` decides between its CUDA kernel
and its plain PyTorch twin from the device of the tensor it was given: a CPU
tensor takes the twin, a CUDA tensor launches the kernel or raises. The
counters let a run show that the main path really went through each kernel.
"""

from __future__ import annotations

import torch


def require_cuda() -> None:
    """Raise unless a CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("tpudf_torch: no CUDA device is available")


def is_hopper(device=None) -> bool:
    """True when the CUDA device is compute capability 9.x (H100/H200)."""
    if not torch.cuda.is_available():
        return False
    major, _ = torch.cuda.get_device_capability(device)
    return major == 9


def has_triton() -> bool:
    try:
        import triton  # noqa: F401
    except ImportError:
        return False
    return True


class LaunchCounts:
    """Plain integer launch counts, one per kernel name. A wrapper calls
    `hit(name)` once each time it launches its kernel on the device, and
    nowhere else (never on the CPU twin path)."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def hit(self, name: str) -> None:
        self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        return dict(self._counts)


LAUNCHES = LaunchCounts()
