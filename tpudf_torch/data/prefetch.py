"""Host↔device pipelining: background-thread batch prefetch.

A copy of tpudf/data/prefetch.py (standard library only).

The reference overlaps host decode with GPU compute via DataLoader worker
processes + prefetch_factor (cifake_binary_classifier.py:1637-1649,
hidf_video_classifier.py:2895-2907). tpudf's `batches()` generators decode
with a thread pool but yield synchronously, so the device idles during the
next batch's decode and the host idles during the device step. `prefetch`
runs the producer in a daemon thread with a bounded queue so decode(i+1)
overlaps step(i) — on TPU this also hides the host→device transfer because
dispatch is async (the step call returns before execution finishes and the
producer refills the queue meanwhile).

Depth 2 suffices: one batch in flight on device, one decoded and queued.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` in a background thread, keeping up to `depth` items
    ready. Exceptions in the producer re-raise at the consuming site.
    Abandoning the iterator (break / GC) stops the producer promptly via
    a stop flag checked on every bounded put."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_stoppable(item) -> bool:
        """Bounded put that gives up when the consumer abandoned us."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put_stoppable(item):
                    return
            put_stoppable(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            put_stoppable(_Error(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            stop.set()

    return gen()
