"""The detect core (the port's `entry.build` → `DetectCore.forward`) in
f32: pixels in [0, 1] → SigLIP-normalised → static-W8A8 tower with ToMe
at the deployed schedule → MAP head → v5 head (z_sig); beside it the
grey image → 24-d frequency vector → frequency MLP (z_freq); the
Linear(2 → 1) fusion of the two probabilities, then CORAL.

The activation scales are calibrated here on the same calibration images
the program was given, and the weights quantised here: nothing of the
program's derived tables is read."""

from __future__ import annotations

import torch

from benchmark.reference import heads, siglip
from benchmark.reference.common import no_tf32

KEYS = ("p_blend", "risk_probs", "z_sig", "z_freq")
GRAY = torch.tensor(heads.GRAY)


class DetectReference:
    """Built once from the benchmark's weights and calibration images
    (uint8); called on (B, S, S, 3) uint8 images → {KEYS} of f32 CPU
    tensors, computed on the images' device in blocks of `block`."""

    def __init__(self, params, calib_uint8, cfg: dict, prec):
        self.p, self.cfg, self.prec = params, cfg, prec
        with no_tf32():
            x = calib_uint8.float() / 255.0
            self.scales = siglip.calibrate(params["backbone"],
                                           (x - 0.5) / 0.5, cfg)
            self.qw = siglip.quantize_blocks(params["backbone"]["blocks"],
                                             prec.levels)

    @torch.no_grad()
    def __call__(self, images_uint8, block: int) -> dict:
        outs = []
        with no_tf32():
            for i in range(0, images_uint8.shape[0], block):
                outs.append(self._block(images_uint8[i:i + block]))
        return {k: torch.cat([o[k] for o in outs]) for k in KEYS}

    def _block(self, imgs):
        p, cfg, prec = self.p, self.cfg, self.prec
        px = prec.lowp(imgs.float() / 255.0)
        tokens, sizes = siglip.w8a8_tower(p["backbone"], self.scales,
                                          self.qw, (px - 0.5) / 0.5, cfg,
                                          prec)
        pooled = siglip.map_head(tokens, p["backbone"]["head"], cfg, prec,
                                 bias=torch.log(sizes))
        z_sig = heads.binary_head(p["head"], pooled, prec)
        gray = prec.highp(px @ GRAY.to(px.device))
        z_freq = heads.freq_mlp(p["freq"], heads.freq_vector(gray), prec)
        out = heads.coral(heads.fuse(p["fusion"], torch.sigmoid(z_sig),
                                     torch.sigmoid(z_freq)))
        return {"p_blend": out["p_blend"].cpu(),
                "risk_probs": out["risk_probs"].cpu(),
                "z_sig": z_sig.cpu(), "z_freq": z_freq.cpu()}
