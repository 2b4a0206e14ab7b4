"""The host's clocks: the process's start time (for `setup_s`) and the
harness's spans (name, start, end on `time.perf_counter`), kept in memory
and read after the run."""

from __future__ import annotations

import contextlib
import os
import time


def process_start() -> float:
    """The epoch time at which this process started: now less the seconds
    since its start, both read from /proc on the boot clock (10 ms ticks),
    so set-up counts the interpreter's own start. Where /proc has no
    answer, the time of this call."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, up - started)


class Spans:
    """Host spans: `with spans("name"): ...` records (name, t0, t1) in
    perf_counter seconds; `seconds(name)` sums a name's spans."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> float | None:
        got = [t1 - t0 for n, t0, t1 in self.items if n == name]
        return sum(got) if got else None
