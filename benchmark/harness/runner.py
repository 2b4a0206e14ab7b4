"""One run of one cell: set-up, the measured window (traced or not),
the peak memory, the comparison that decides `correct`, and the result's
line. `run.py` calls `run` after its checks for the card."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import subprocess
import time

import torch

from benchmark.harness import manifest
from benchmark.harness.clock import Spans
from benchmark.harness.devtrace import DeviceTrace


@dataclasses.dataclass
class Record:
    """What a per-layer metric's `read` is given."""
    cell: manifest.Cell
    spans: Spans
    window: object            # paths.Window
    trace: dict | None        # DeviceTrace.summarize's dict


def power_limit() -> str | None:
    """nvidia-smi's name and power limit of card 0, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every reading finite and
    at most its limit, every limit read."""
    checks = {k: {"value": readings.get(k), "limit": limits[k]}
              for k in limits}
    ok = all(c["value"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, root=manifest.ROOT) -> dict:
    """The result's dict of one run (its keys in the order printed)."""
    device = device or torch.device("cuda", 0)
    cell = manifest.find_cell(manifest.load_manifest(root), workload, root)
    spans = Spans()
    driver = manifest.path_driver(cell.mix["path"]).Driver(
        cell, seed, device, spans)
    setup_s = time.time() - t_start
    on_card = device.type == "cuda"
    tracer = DeviceTrace() if trace and on_card else None
    with tracer or contextlib.nullcontext():
        win = driver.window(seconds, spans)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = driver.end_to_end(win)
    summary = tracer.summarize(spans, win.t0, win.t1) if tracer else None
    driver.release()
    correct, checks = judge(driver.readings("program"), cell.limits)

    metrics = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = Record(cell, spans, win, summary)
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"], root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    if on_card:
        dev["power"] = power_limit()
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out
