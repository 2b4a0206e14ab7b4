"""The device trace of a traced run: torch.profiler with CUDA activity
only (tracing the host's ops slows the host and inflates the idle share
of a host-paced run), aligned to the host's spans by a marker kernel.

`busy_s` is the union of the device operations' intervals inside the
window; the idle gaps between them are labelled by the harness span open
on the host when each gap began.
"""

from __future__ import annotations

import bisect
import collections
import time

MARK_CYCLES = 1000        # torch.cuda._sleep's spin kernel: the marker
MARK_NAME = "spin_kernel"
TOP = 10                  # entries of each list in the breakdown


def _short(name: str) -> str:
    """A kernel's demangled name without its return type, its anonymous
    namespace and its argument list (the last parenthesised group; a
    template argument may hold parentheses of its own)."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:120]


def _device_events(prof):
    """[(name, start_s, end_s)] of the device operations, on the
    profiler's clock."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class DeviceTrace:
    """`with DeviceTrace(): <window>`; then `summarize(spans, t0, t1)`
    with the window's host-clock ends."""

    def __init__(self):
        self.events = []
        self.offset = None        # device clock - host perf_counter

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        events = _device_events(self._prof)
        marks = [e for e in events if MARK_NAME in e[0]]
        if marks:
            self.offset = marks[0][1] - self._mark_host
            events = [e for e in events if e is not marks[0]]
        elif events:           # the first operation after the marker
            self.offset = min(e[1] for e in events) - self._mark_host
        self.events = events
        del self._prof
        return False

    def window_events(self, t0: float, t1: float):
        """The device operations inside the host window [t0, t1], clipped
        to it, on the host's clock."""
        if self.offset is None:
            return []
        out = []
        for name, s, e in self.events:
            s, e = s - self.offset, e - self.offset
            if e > t0 and s < t1:
                out.append((name, max(s, t0), min(e, t1)))
        return out

    def summarize(self, spans, t0: float, t1: float):
        """{"busy_s", "window_s", "device_ops", "idle_gaps", "by_name"}:
        device_ops the TOP names by device seconds, idle_gaps the idle
        seconds by the host span open when each gap began ("none" outside
        every span), by_name every kernel's device seconds."""
        ev = sorted(self.window_events(t0, t1), key=lambda e: e[1])
        by_name = collections.defaultdict(float)
        for name, s, e in ev:
            by_name[_short(name)] += e - s
        label = _Labels(spans)
        busy, end = 0.0, t0
        gaps = collections.defaultdict(float)
        for _, s, e in ev + [("", t1, t1)]:
            if s > end:
                gaps[label(end)] += s - end
            if e > end:
                busy += e - max(s, end)
                end = e
        return {
            "busy_s": busy, "window_s": t1 - t0, "by_name": dict(by_name),
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:TOP]}


class _Labels:
    """label(t): the name of the latest-started span open at host time t,
    "none" outside every span. Spans nest shallowly, so a few steps back
    from the last span started before t find it."""

    DEPTH = 8

    def __init__(self, spans):
        self.items = sorted(spans.items, key=lambda s: s[1])
        self.starts = [s[1] for s in self.items]

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for s in self.items[max(0, i - self.DEPTH + 1):i + 1][::-1]:
            if s[2] > t:
                return s[0]
        return "none"


def kernel_seconds(by_name: dict, patterns) -> float:
    """Device seconds of the kernels whose name holds one of `patterns`."""
    return sum(v for k, v in by_name.items()
               if any(p in k for p in patterns))
