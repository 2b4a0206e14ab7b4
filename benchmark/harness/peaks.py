"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit) and the roofline
bound: the least time the card could take for a piece of work, the larger
of its operations over the peak rate of their type and its bytes over the
peak memory bandwidth. Shares are stated against these peaks; a run
writes the card's power limit beside them."""

from __future__ import annotations

PEAK = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12,
        "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: dict, n_bytes: float) -> float:
    """Seconds: max(sum of ops[kind] / PEAK[kind], n_bytes / HBM)."""
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return max(t_ops, n_bytes / HBM_BYTES_PER_S)


def share(work_s: float, seconds: float) -> float | None:
    """100 · work_s / seconds, or None where nothing was timed."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work_s / seconds
