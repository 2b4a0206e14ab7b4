"""The full-analysis request: the port's `DetectEngine.predict_batch` on
engine A as `tpudf_torch.entry.build_engine`'s defaults make it (the bf16
tower, no ToMe, the fusion head), from the benchmark's weights. 53 views
an image.

Traffic keys: "request_images" (images a request), "pool_images" (the
seeded uint8 images on the host a request draws from), "check_requests"
(window requests the check compares, drawn from the seed). One caller in
a closed loop: each request is the uint8 numpy batch handed to
predict_batch, timed on the host clock to its numpy result.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark.harness import inputs, stats, weights
from benchmark.paths import Window
from benchmark.paths.detect import port_config
from benchmark.reference.common import CONTROL, SOUND
from benchmark.reference.request import KEYS, RequestReference


def build_engine(params, cfg):
    """`entry.build_engine`'s engine on given weights (its defaults: no
    int8, no ToMe, the fusion head)."""
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.serve.engine import DetectEngine
    return DetectEngine(cfg=cfg, backbone=params["backbone"],
                        head=params["head"], freq=params["freq"],
                        fusion=params["fusion"],
                        cuts=CoralCutpoints.default(),
                        policy=DEFAULT_POLICY)


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed, self.device = cell, seed, device
        mix, config = cell.mix, cell.config
        self.k = mix["request_images"]
        with spans("inputs"):
            g = weights.generator(seed, weights.INPUTS, device)
            self.pool = inputs.images(g, mix["pool_images"],
                                      config["image_size"],
                                      device).cpu().numpy()
        with spans("weights"):
            params = self._weights()
        with spans("build"):
            self.engine = build_engine(params, port_config(config))
            _sync(device)
        del params
        self.draw = random.Random(seed)
        with spans("warmup"):
            for _ in range(2):
                self.engine.predict_batch(self._request()[1])
        self.kept, self.refs = [], {}

    def _weights(self):
        return weights.make(weights.detect_spec(self.cell.config),
                            weights.generator(self.seed, weights.WEIGHTS,
                                              self.device), self.device)

    def _request(self):
        idx = self.draw.sample(range(len(self.pool)), self.k)
        return idx, self.pool[idx]

    def window(self, seconds: float, spans) -> Window:
        from tpudf_torch.core.backend import LAUNCHES
        LAUNCHES.reset()
        lat, reqs, outs = [], [], []
        t0 = time.perf_counter()
        while True:
            idx, batch = self._request()
            with spans("request"):
                a = time.perf_counter()
                out = self.engine.predict_batch(batch)
                lat.append(time.perf_counter() - a)
            reqs.append(idx)
            outs.append(out)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        t1 = time.perf_counter()
        self.lat, self.reqs, self.outs = lat, reqs, outs
        return Window(t0, t1, {"requests": len(lat),
                               "images": len(lat) * self.k},
                      LAUNCHES.snapshot(), len(lat), 0)

    def end_to_end(self, win: Window) -> dict:
        ms = [1e3 * t for t in self.lat]
        return {"request_p50_ms": stats.percentile(ms, 50),
                "request_p95_ms": stats.percentile(ms, 95)}

    def release(self):
        n = len(self.outs)
        self.sample = sorted(random.Random(self.seed).sample(
            range(n), min(self.cell.mix["check_requests"], n)))
        self.kept = [{k: torch.as_tensor(np.asarray(self.outs[i][k]))
                      .float() for k in KEYS} for i in self.sample]
        self.outs = []
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec):
        if prec not in self.refs:
            ref = RequestReference(self._weights(), self.cell.config, prec)
            self.refs[prec] = [ref(torch.as_tensor(
                self.pool[self.reqs[i]]).to(self.device))
                for i in self.sample]
        return self.refs[prec]

    def readings(self, candidate: str = "program") -> dict:
        ref = self._reference(SOUND)
        got = self.kept if candidate == "program" else \
            self._reference(CONTROL)
        return {k: max(float((a[k].reshape(b[k].shape) - b[k]).abs().max())
                       for a, b in zip(got, ref)) for k in KEYS}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
