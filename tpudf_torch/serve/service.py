"""Production micro-batching inference service.

The port of tpudf/serve/service.py over `tpudf_torch.serve.report`.

The reference serves one request at a time through Gradio with a thread pool
for video frames (appv3.py:6404-6457). The serving shape here is a
micro-batching queue: requests accumulate up to `max_batch` or `max_wait_ms`
and run as one padded device batch — the same collapse that wins the
throughput target, applied at the serving layer.

Thread-safe; a single background worker owns the card (one stream of
launches). Latency/throughput counters included (the reference has no
serving observability at all — SURVEY.md §5).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field


@dataclass
class _Pending:
    pixels: object
    fast: bool
    event: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: Exception | None = None
    enqueued_at: float = field(default_factory=time.perf_counter)


class DetectService:
    def __init__(self, engine, *, max_batch=32, max_wait_ms=5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "images": 0,
                      "total_latency_s": 0.0, "max_latency_s": 0.0}
        # recent per-request latencies for percentile SLOs (bounded window)
        from collections import deque
        self._latencies = deque(maxlen=8192)
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ client

    def predict(self, pixels_uint8, fast=False, timeout=60.0) -> dict:
        """Blocking single-image predict; (S, S, 3) uint8 → report dict."""
        p = _Pending(pixels_uint8, fast)
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("detect service timeout")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def warmup(self, fast=False, max_bucket=None):
        """Run every pow2 batch bucket up to max_batch once (the kernels'
        build, cuBLAS / cuDNN plans, the resize matrices) so no request pays
        a first-call cost at serving time. Call before taking load."""
        import numpy as np
        from tpudf_torch.serve.report import predict_images
        cap = max_bucket or self.max_batch
        s = self.engine.cfg.image_size
        sizes = []
        size = 1
        while size <= cap:
            sizes.append(size)
            size *= 2
        if cap not in sizes:
            # non-pow2 max_batch: _run pads a full drain to exactly cap
            # (pad_to_bucket's max_batch clamp), so warm that size too
            sizes.append(cap)
        for size in sizes:
            rng = np.random.default_rng(size)
            px = rng.integers(0, 256, (size, s, s, 3), dtype=np.uint8)
            predict_images(self.engine, px, fast=fast)

    # ------------------------------------------------------------ worker

    def _drain(self):
        items = []
        try:
            items.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return items
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        # Double-buffered dispatch: launch the device work for batch i
        # (CUDA launches are async), drain batch i+1 while the card runs,
        # THEN finalize batch i (the blocking device fetch). Under
        # sustained load this hides the drain window + host round-trip
        # behind device compute instead of serializing them.
        import numpy as np
        from tpudf_torch.serve.report import dispatch_images, predict_images
        inflight = []   # [(group, batch, fast, futures)]

        def finalize_one():
            group, batch, fast, futures = inflight.pop(0)
            try:
                reports = predict_images(self.engine, batch, fast=fast,
                                         _dispatched=futures)
                now = time.perf_counter()
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["images"] += len(group)
                    self.stats["requests"] += len(group)
                for p, r in zip(group, reports):
                    p.result = r
                    lat = now - p.enqueued_at
                    with self._lock:
                        self.stats["total_latency_s"] += lat
                        self.stats["max_latency_s"] = max(
                            self.stats["max_latency_s"], lat)
                        self._latencies.append(lat)
                    p.event.set()
            except Exception as e:          # pragma: no cover
                for p in group:
                    p.error = e
                    p.event.set()

        while not self._stop.is_set():
            items = self._drain()
            for fast in (False, True):
                group = [p for p in items if p.fast == fast]
                if not group:
                    continue
                try:
                    batch = np.stack([np.asarray(p.pixels) for p in group])
                    # pow2 bucket padding (capped at max_batch — the graphs
                    # warmup ran): at most log2(max_batch)+2 device
                    # graphs per mode, instead of one per drained count
                    futures = dispatch_images(self.engine, batch, fast=fast,
                                              pad_batch=True,
                                              max_batch=self.max_batch)
                    inflight.append((group, batch, fast, futures))
                except Exception as e:          # pragma: no cover
                    for p in group:
                        p.error = e
                        p.event.set()
            # keep at most one batch in flight: finalize immediately when
            # the queue is empty (a lone request must not wait out the next
            # drain timeout) and whenever depth reaches 2
            while inflight and (self._q.empty() or len(inflight) >= 2):
                finalize_one()
        while inflight:                          # drain on shutdown
            finalize_one()

    def snapshot_stats(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            lats = sorted(self._latencies)
        if s["requests"]:
            s["mean_latency_s"] = s["total_latency_s"] / s["requests"]
            s["mean_batch_size"] = s["images"] / max(s["batches"], 1)
        if lats:
            s["p50_latency_s"] = lats[len(lats) // 2]
            s["p99_latency_s"] = lats[min(len(lats) - 1,
                                          int(len(lats) * 0.99))]
        return s
