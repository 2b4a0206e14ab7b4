"""The bulk detect path: the port's detect core (static W8A8 tower with
ToMe at the deployed schedule, the v5 head, the frequency expert, the
fusion and CORAL), built as `tpudf_torch.entry.build` composes it, from
the benchmark's weights.

Traffic keys: "batch" (images a batch), "pool_batches" (distinct seeded
batches held on the card as uint8; batch i of the window is pool entry
i mod pool_batches), "calib_images", "check_batches" (window batches the
check compares whole, drawn from the seed). Batches are dispatched ahead
with no synchronise between them; the window ends with one.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import inputs, weights
from benchmark.paths import Window
from benchmark.reference.common import CONTROL, SOUND
from benchmark.reference.detect import KEYS, DetectReference

COMPARED = ("p_blend", "z_sig", "z_freq")   # risk_probs: see readings


def port_config(config: dict):
    """The port's SigLIPConfig of a configuration file."""
    from tpudf_torch.models.siglip import SigLIPConfig
    return SigLIPConfig(
        width=config["hidden_size"], layers=config["num_hidden_layers"],
        heads=config["num_attention_heads"],
        mlp_dim=config["intermediate_size"],
        image_size=config["image_size"], patch_size=config["patch_size"],
        ln_eps=config["layer_norm_eps"])


def build_core(params, calib_uint8, cfg):
    """`entry.build`'s composition on given weights and calibration
    images: calibrate the activation scales, quantise to static W8A8,
    add the kernels' layout, hold it all in a DetectCore."""
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.precision import DEFAULT_POLICY
    from tpudf_torch.entry import DetectCore
    from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                       quantize_siglip_static)

    calib = (calib_uint8.float() / 255.0 - 0.5) / 0.5
    scales = calibrate_siglip_act_scales(params["backbone"], cfg, calib,
                                         DEFAULT_POLICY)
    params = dict(params, backbone=quantize_siglip_static(
        params["backbone"], scales, cfg))
    return DetectCore(add_kernel_layout(params), cfg,
                      CoralCutpoints.default())


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from tpudf_torch.core.backend import LAUNCHES
        self.cell, self.seed, self.device = cell, seed, device
        self.launches = LAUNCHES
        mix, config = cell.mix, cell.config
        self.batch, self.pool_n = mix["batch"], mix["pool_batches"]
        size = config["image_size"]
        with spans("inputs"):
            g = weights.generator(seed, weights.INPUTS, device)
            self.calib = inputs.images(g, mix["calib_images"], size, device)
            self.pool = inputs.images(g, self.pool_n * self.batch, size,
                                      device).view(self.pool_n, self.batch,
                                                   size, size, 3)
        with spans("weights"):
            params = self._weights()
        with spans("build"):
            self.core = build_core(params, self.calib, port_config(config))
            _sync(device)
        del params
        with spans("warmup"):
            for i in range(2):
                self._step(i)
            _sync(device)
        self.outs, self.n, self._refs = [], 0, {}

    def _weights(self):
        return weights.make(weights.detect_spec(self.cell.config),
                            weights.generator(self.seed, weights.WEIGHTS,
                                              self.device), self.device)

    def _step(self, i):
        return self.core(self.pool[i % self.pool_n].float() / 255.0)

    def window(self, seconds: float, spans) -> Window:
        self.launches.reset()
        outs = []
        t0 = time.perf_counter()
        while True:
            with spans("dispatch"):
                outs.append(self._step(len(outs)))
            if time.perf_counter() - t0 >= seconds:
                break
        with spans("drain"):
            _sync(self.device)
        t1 = time.perf_counter()
        self.outs, self.n = outs, len(outs)
        images = self.n * self.batch
        return Window(t0, t1, {"batches": self.n, "images": images},
                      self.launches.snapshot(), images, 0)

    def end_to_end(self, win: Window) -> dict:
        return {"detect_img_per_s": win.work["images"] / win.seconds}

    def release(self):
        """Keeps the sampled batches' outputs on the host, drops the rest
        and the program."""
        self.sample = sorted(random.Random(self.seed).sample(
            range(self.n), min(self.cell.mix["check_batches"], self.n)))
        self.kept = [{k: self.outs[i][k].float().cpu() for k in KEYS}
                     for i in self.sample]
        self.outs = []
        del self.core
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec):
        if prec in self._refs:
            return self._refs[prec]
        ref = DetectReference(self._weights(), self.calib,
                              self.cell.config, prec)
        block = reference_block(self.cell.config)
        self._refs[prec] = [ref(self.pool[i % self.pool_n], block)
                            for i in self.sample]
        return self._refs[prec]

    def readings(self, candidate: str = "program") -> dict:
        """The widest gap over the sampled batches between the candidate's
        outputs (the program's, or the control's) and the reference's, in
        units of the reference output's standard deviation over those
        images: the seeded heads' scale differs from seed to seed.
        risk_probs is CORAL's ordinal transform of the fused logit that
        p_blend also carries; its deviation over images mixes the five
        classes' levels, so it is not compared."""
        ref = self._reference(SOUND)
        got = self.kept if candidate == "program" else \
            self._reference(CONTROL)
        out = {}
        for k in COMPARED:
            r = torch.cat([b[k] for b in ref])
            gap = (torch.cat([a[k] for a in got]) - r).abs().max()
            out[k] = float(gap / r.std().clamp(min=1e-12))
        return out


def reference_block(config: dict) -> int:
    """Images a reference block holds: about 1 GB of f64 products and of
    f32 attention scores."""
    n = (config["image_size"] // config["patch_size"]) ** 2
    by_mm = 2 ** 30 // (8 * n * config["intermediate_size"])
    by_attn = 2 ** 30 // (4 * config["num_attention_heads"] * n * n)
    return max(1, min(by_mm, by_attn))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
