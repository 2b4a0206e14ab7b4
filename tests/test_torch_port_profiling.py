"""The port's profiling hooks (tpudf_torch/utils/profiling.py) against the
JAX package's (tpudf/utils/profiling.py), on the CPU.

StepTimer is a copy: fed the same step times (time.perf_counter stubbed
on both sides) its stats and CSV ledger equal JAX's exactly. trace()
writes a Chrome trace of the body, and an error raised in the body
propagates (JAX's swallows a profiler failure; the port's does not).
device_memory_stats() lists one CPU entry of Nones without a card.
"""

import json
import os

import pytest
import torch

from tpudf.utils import profiling as J_prof
from tpudf_torch.utils import profiling as T_prof

TIMES = (0.5, 0.75, 0.25, 1.0, 0.125)


def _timed(module, monkeypatch, csv_path, window):
    clock = iter([t for dt in TIMES for t in (10.0, 10.0 + dt)])
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StepTimer(window=window, csv_path=csv_path)
    for i in range(len(TIMES)):
        with timer.step(n_items=2 + i):
            pass
    monkeypatch.undo()
    return timer


@pytest.mark.parametrize("window", [3, 200])
def test_step_timer_matches_jax(tmp_path, monkeypatch, window):
    paths = [str(tmp_path / f"{s}.csv") for s in ("t", "j")]
    got = _timed(T_prof, monkeypatch, paths[0], window)
    want = _timed(J_prof, monkeypatch, paths[1], window)
    assert got.stats() == want.stats()
    assert got.stats()["steps"] == min(window, len(TIMES))
    assert open(paths[0]).read() == open(paths[1]).read()
    assert T_prof.StepTimer().stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with T_prof.trace(str(tmp_path / "tr")) as d:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_propagates_an_error_in_its_body(tmp_path):
    with pytest.raises(KeyError, match="body"):
        with T_prof.trace(str(tmp_path / "tr")):
            raise KeyError("body")


def test_trace_raises_where_the_profiler_fails(tmp_path, monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(tp, "profile", Broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with T_prof.trace(str(tmp_path / "tr")):
            pass


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T_prof.device_memory_stats() == [
        {"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None}]
