"""The full analysis of a request (the port's `DetectEngine.predict_batch`
on engine A: the float tower, no ToMe, the fusion head) in f32.

Per image, 53 views: 9 crops (the centre half, the four halves, the four
quadrants, each resized back with a Keys cubic), the rot90 of the image,
the same 10 of the mirrored image, the image itself, 16 tiles of a 4 x 4
grid (each upsampled with a triangle kernel) and their rot90s. Resizing
follows jax.image.resize: half-pixel sample positions, each output's
weights divided by their sum (the border renormalises), no antialias
when upsampling. The tower and the v5 head run on every view, the
frequency expert on the 9 + 9 crops and the 16 tiles (grey, at 256 px); the crops' logits
are averaged with the weights 0.2 (centre) and 0.1; the visual
probability is 0.6 · sigmoid(crops) + 0.4 · sigmoid(the rot90 view); the
frequency probability sigmoid(z / 1.25); the fusion and CORAL follow,
for the image and its mirror (averaged) and for each tile."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import heads, siglip
from benchmark.reference.common import no_tf32

KEYS = ("p_blend", "z_sig", "z_freq", "patch_probs", "embed_feat")
CROP_WEIGHTS = (0.2,) + (0.1,) * 8
FREQ_TEMP = 1.25
FREQ_SIZE = 256          # the frequency features' fixed resolution
BLOCK = 64               # views the f32 tower takes at a time


def _kernel(x, kind):
    x = np.abs(x)
    if kind == "cubic":
        return np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                        np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2,
                                 0.0))
    return np.maximum(0.0, 1 - x)


def resize_matrix(src: int, dst: int, kind: str) -> torch.Tensor:
    """(dst, src) weights of an upsampling (or identity) resize."""
    if dst < src:
        raise ValueError("the full analysis only upsamples")
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    w = _kernel(pos[:, None] - np.arange(src)[None, :], kind)
    return torch.tensor(w / w.sum(1, keepdims=True), dtype=torch.float32)


def resize(x, size: int, kind: str):
    """(B, h, w, C) → (B, size, size, C)."""
    _, h, w, _ = x.shape
    mh = resize_matrix(h, size, kind).to(x.device)
    mw = resize_matrix(w, size, kind).to(x.device)
    return torch.einsum("ih,bhwc,jw->bijc", mh, x, mw)


def crops(x):
    """(B, S, S, 3) → (B, 9, S, S, 3)."""
    s = x.shape[1]
    m = s // 2
    q = (s - m) // 2
    boxes = [(q, q, m, m), (0, 0, s, m), (0, s - m, s, m), (0, 0, m, s),
             (s - m, 0, m, s), (0, 0, m, m), (0, s - m, m, m),
             (s - m, 0, m, m), (s - m, s - m, m, m)]
    return torch.stack([resize(x[:, t:t + h, l:l + w], s, "cubic")
                        for t, l, h, w in boxes], 1)


def tiles(x):
    """(B, S, S, 3) → (B, 16, S, S, 3): a 4 × 4 grid, row-major,
    upsampled."""
    b, s, _, c = x.shape
    p = s // 4
    t = x.reshape(b, 4, p, 4, p, c).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(b * 16, p, p, c)
    return resize(t, s, "triangle").reshape(b, 16, s, s, c)


def rot90(x):
    """Counter-clockwise over the (H, W) axes of (..., H, W, C)."""
    return torch.rot90(x, 1, dims=(-3, -2))


class RequestReference:
    def __init__(self, params, cfg: dict, prec):
        self.p, self.cfg, self.prec = params, cfg, prec

    def _pooled(self, views):
        out = []
        for i in range(0, views.shape[0], BLOCK):
            tok, _ = siglip.float_tower(self.p["backbone"],
                                        (views[i:i + BLOCK] - 0.5) / 0.5,
                                        self.cfg, self.prec)
            out.append(siglip.map_head(tok, self.p["backbone"]["head"],
                                       self.cfg, self.prec))
        return torch.cat(out)

    def _fuse(self, vis, pf):
        return heads.coral(heads.fuse(self.p["fusion"], vis, pf))

    @torch.no_grad()
    def __call__(self, images_uint8) -> dict:
        """(B, S, S, 3) uint8 → {KEYS} of f32 CPU tensors."""
        with no_tf32():
            return self._run(images_uint8)

    def _run(self, images_uint8):
        p, prec = self.p, self.prec
        x = prec.highp(images_uint8.float() / 255.0)
        b, s = x.shape[:2]
        flip = torch.flip(x, dims=(2,))
        c, cf, t = crops(x), crops(flip), tiles(x)
        main = torch.cat([c, rot90(x)[:, None], cf, rot90(flip)[:, None],
                          x[:, None]], 1)
        patch = torch.cat([t, rot90(t)], 1)
        views = prec.highp(torch.cat([main, patch], 1))
        pooled = self._pooled(views.reshape(b * 53, s, s, 3))
        z = heads.binary_head(p["head"], pooled, prec).reshape(b, 53)
        feat = pooled.reshape(b, 53, -1)[:, 20]
        gray = prec.highp(torch.cat([c, cf, t], 1).reshape(b * 34, s, s, 3)
                          @ torch.tensor(heads.GRAY, device=x.device))
        if s != FREQ_SIZE:
            gray = resize(gray[..., None], FREQ_SIZE, "triangle")[..., 0]
        zf = torch.cat([heads.freq_mlp(p["freq"], heads.freq_vector(g),
                                       prec)
                        for g in torch.split(gray, 256)]).reshape(b, 34)
        wts = torch.tensor(CROP_WEIGHTS, device=x.device)

        def core(zs, zfs, zrot):
            vis = 0.6 * torch.sigmoid((zs * wts).sum(1)) \
                + 0.4 * torch.sigmoid(zrot)
            zfreq = (zfs * wts).sum(1)
            out = self._fuse(vis, torch.sigmoid(zfreq / FREQ_TEMP))
            v = vis.clamp(1e-6, 1 - 1e-6)
            return out, torch.log(v / (1 - v)), zfreq

        m, z_sig, z_freq = core(z[:, 0:9], zf[:, 0:9], z[:, 9])
        tta, _, _ = core(z[:, 10:19], zf[:, 9:18], z[:, 19])
        vp = 0.6 * torch.sigmoid(z[:, 21:37]) + 0.4 * torch.sigmoid(
            z[:, 37:53])
        fp = torch.sigmoid(zf[:, 18:34] / FREQ_TEMP)
        pp = self._fuse(vp.reshape(-1), fp.reshape(-1))["p_blend"]
        return {"p_blend": (0.5 * (m["p_blend"] + tta["p_blend"])).cpu(),
                "z_sig": z_sig.cpu(),
                "z_freq": z_freq.cpu(), "patch_probs": pp.reshape(b, 16).cpu(),
                "embed_feat": (feat / (feat.norm(dim=-1, keepdim=True)
                                       + 1e-6)).cpu()}
