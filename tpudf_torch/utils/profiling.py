"""Step-time logging and profiler hooks (tpudf/utils/profiling.py).

  * StepTimer: wall-clock step statistics (mean/p50/p95, steps/sec,
    items/sec) with an optional CSV ledger, a copy of the JAX package's
  * trace(): a context manager around torch.profiler (CPU activity, and
    CUDA activity where a card is visible) that writes a Chrome trace
    (`trace.json`, open it in chrome://tracing or Perfetto); a profiler
    that fails raises, and an error raised in the body propagates
  * device_memory_stats(): the current and peak bytes allocated on each
    card by PyTorch's caching allocator
"""

from __future__ import annotations

import contextlib
import csv
import os
import tempfile
import time

import numpy as np
import torch


class StepTimer:
    def __init__(self, window: int = 200, csv_path: str | None = None):
        self.times: list[float] = []
        self.items: list[int] = []
        self.window = window
        self.csv_path = csv_path
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.items.append(n_items)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.items.pop(0)
        if self.csv_path:
            exists = os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if not exists:
                    w.writerow(["step_time_s", "items"])
                w.writerow([f"{dt:.6f}", n_items])
        return dt

    @contextlib.contextmanager
    def step(self, n_items: int = 1):
        self.start()
        yield
        self.stop(n_items)

    def stats(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        items = float(np.sum(self.items))
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps_per_sec": float(1.0 / t.mean()),
            "items_per_sec": float(items / t.sum()),
        }


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler over the body; on a clean exit its events go to
    `log_dir/trace.json` (Chrome trace format). log_dir defaults to
    `tpudf_torch_trace` under the temporary directory. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "tpudf_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> list[dict]:
    """One entry per visible card: its current and peak allocated bytes
    (`torch.cuda.memory_stats`); without a card, one CPU entry whose
    counts are None."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": raw.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": raw.get("allocated_bytes.all.peak")})
    return out
