"""The trace's reduction on synthetic events: busy time as the union of
device intervals inside the window, idle gaps labelled by the host span
open when each began, kernel seconds by name."""

import pytest

from benchmark.harness.clock import Spans
from benchmark.harness.devtrace import DeviceTrace, kernel_seconds


def trace(events, offset=100.0):
    t = DeviceTrace()
    t.offset = offset                     # device clock = host + offset
    t.events = [(n, s + offset, e + offset) for n, s, e in events]
    return t


def test_bench_busy_is_the_union_inside_the_window():
    t = trace([("void i8_gemm_sm90<0, 128, false>(CUtensorMap)", 1.0, 2.0),
               ("k2", 1.5, 2.5), ("k3", 4.0, 5.0), ("before", -1.0, 0.5)])
    s = t.summarize(Spans(), 0.0, 4.5)
    # [0, .5] of the one that began before, [1, 2.5], [4, 4.5]
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["window_s"] == pytest.approx(4.5)
    assert s["by_name"]["i8_gemm_sm90<0, 128, false>"] == pytest.approx(1.0)
    assert kernel_seconds(s["by_name"], ("i8_gemm_sm90",)) == \
        pytest.approx(1.0)
    assert s["device_ops"][0][0] == "i8_gemm_sm90<0, 128, false>"


def test_bench_idle_gaps_take_the_open_span():
    spans = Spans()
    spans.items += [("dispatch", 0.0, 1.2), ("loss_readback", 2.4, 4.2),
                    ("step", 2.0, 4.3)]
    t = trace([("k", 0.5, 1.0), ("k", 1.5, 2.5), ("k", 4.0, 4.5)])
    s = t.summarize(spans, 0.0, 5.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["dispatch"] == pytest.approx(0.5 + 0.5)   # [0, .5], [1, 1.5]
    assert gaps["loss_readback"] == pytest.approx(1.5)    # [2.5, 4]
    assert gaps["none"] == pytest.approx(0.5)             # [4.5, 5]
    assert s["busy_s"] + sum(gaps.values()) == pytest.approx(5.0)


def test_bench_no_marker_no_events():
    t = DeviceTrace()
    s = t.summarize(Spans(), 0.0, 1.0)
    assert s["busy_s"] == 0.0 and s["device_ops"] == []
