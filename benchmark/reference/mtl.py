"""The multi-task fine-tuning step (the port's `entry.build_mtl_trainer`)
in f32 with autograd: the SigLIP tower with its embeddings and layers
below `freeze_below` frozen, the 3-class head on the MAP-pooled output,
the SegFormer decoder over the tapped hidden states (per-tap projection,
depthwise 3x3 + pointwise 1x1, exact GELU, a sigmoid channel gate, a 1x1
fuse, bilinear upsampling to the image size, a 1x1 logit head), the loss
cls_w · cross-entropy + seg_w · the six-part segmentation loss averaged
over the images that have a mask, then optax's
clip_by_global_norm(1) → AdamW on a linear-warmup cosine schedule (the
rate read at the count before the step), written out here.

`run(batches)` trains its own copy of the trainable leaves from the
benchmark's weights and returns each step's loss, each leaf's first
gradient as the optimizer receives it (after the clip), each leaf's
change after the steps and its first moment after them (CPU tensors),
under the program's leaf names, and the first step's global gradient
norm before the clip."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import siglip
from benchmark.reference.common import gelu_exact, no_tf32, ste

B1, B2, ADAM_EPS, CLIP, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1.0, 1e-4


def leaf_paths(tree, prefix=()):
    """(path, leaf) in the tree's insertion order (lists by index)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def trainable_names(params, freeze_below: int) -> dict:
    """{name: first row}: every leaf but the embeddings'; the stacked
    block leaves from row freeze_below."""
    return {leaf_name(p): (freeze_below if p[:2] == ("backbone", "blocks")
                           else 0)
            for p, _ in leaf_paths(params) if p[:2] != ("backbone", "embed")}


def schedule(count: int, peak: float, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total)."""
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, total - warmup)
    return peak * 0.5 * (1 + math.cos(math.pi * t / (total - warmup)))


def _conv(x, p, prec, groups=1):
    w = p["w"].permute(3, 2, 0, 1)          # HWIO → OIHW
    return F.conv2d(ste(x, prec.lowp), ste(w, prec.lowp), p["b"],
                    padding=w.shape[-1] // 2, groups=groups)


def decoder(p, feats, grid: int, size: int, prec):
    """K tapped (B, N, W) states → (B, size, size) logits."""
    outs = []
    for proj, smooth, tok in zip(p["projs"], p["smooth"], feats):
        x = ste(tok, prec.lowp) @ ste(proj["w"], prec.lowp) + proj["b"]
        b, _, e = x.shape
        x = x.reshape(b, grid, grid, e).permute(0, 3, 1, 2)
        x = _conv(_conv(x, smooth["dw"], prec, groups=e), smooth["pw"],
                  prec)
        outs.append(gelu_exact(x))
    x = torch.cat(outs, 1)
    a = torch.sigmoid(_conv(gelu_exact(_conv(x, p["attn1"], prec)),
                            p["attn2"], prec))
    x = _conv(a * x, p["fuse"], prec)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return _conv(x, p["head"], prec)[:, 0]


def _pool(x, op):
    y = F.max_pool2d((x if op == "max" else -x)[:, None], 3, 1, 1)[:, 0]
    return y if op == "max" else -y


def _bce(l, t):
    return -(t * F.logsigmoid(l) + (1 - t) * F.logsigmoid(-l))


def seg_loss(l, t):
    """(B, S, S) logits and masks → (B,) six-part loss of each image:
    0.4 BCE + 0.3 focal (alpha .25, gamma 2) + 0.5 Dice + 0.4 boundary
    BCE (4x on the 3x3 morphological gradient of the mask) + 0.4 soft IoU
    + 0.2 opening/closing consistency."""
    ax = (1, 2)
    p = torch.sigmoid(l)
    bce = _bce(l, t).mean(ax)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = 0.25 * t + 0.75 * (1 - t)
    focal = (a_t * (1 - p_t) ** 2 * _bce(l, t)).mean(ax)
    inter = (p * t).sum(ax)
    dice = 1 - 2 * inter / (p.sum(ax) + t.sum(ax) + 1e-6)
    edge = _pool(t, "max") - _pool(t, "min")
    boundary = (_bce(l, t) * (1 + 3 * edge)).mean(ax)
    iou = 1 - inter / (p.sum(ax) + t.sum(ax) - inter + 1e-6)

    def opening(x):
        return _pool(_pool(x, "min"), "max")

    def closing(x):
        return _pool(_pool(x, "max"), "min")

    morph = (((opening(p) - opening(t)) ** 2).mean(ax)
             + ((closing(p) - closing(t)) ** 2).mean(ax)) / 2
    return (0.4 * bce + 0.3 * focal + 0.5 * dice + 0.4 * boundary
            + 0.4 * iou + 0.2 * morph)


class MTLReference:
    def __init__(self, params, cfg: dict, mix: dict, prec):
        self.cfg, self.mix, self.prec = cfg, mix, prec
        self.k = mix["freeze_below"]
        self.rows = trainable_names(params, self.k)
        self.params = params
        self.train = {}
        for path, leaf in leaf_paths(params):
            name = leaf_name(path)
            if name in self.rows:
                self.train[name] = leaf[self.rows[name]:].detach().clone() \
                    .requires_grad_(True)

    def _tree(self):
        """The parameter tree with the trainable leaves in place (the
        stacked block leaves: frozen rows, then the trainable ones)."""
        def build(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (k,)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [build(v, prefix + (i,)) for i, v in enumerate(tree)]
            name = leaf_name(prefix)
            if name not in self.train:
                return tree
            r = self.rows[name]
            return torch.cat([tree[:r], self.train[name]]) if r else \
                self.train[name]
        return build(self.params)

    def loss(self, batch, cls_w: float, seg_w: float):
        p, cfg, prec = self._tree(), self.cfg, self.prec
        tokens, hs = siglip.float_tower(p["backbone"], batch["pixels"], cfg,
                                        prec, hidden=True, grad_from=self.k)
        pooled = siglip.map_head(tokens, p["backbone"]["head"], cfg, prec)
        cls = ste(pooled, prec.lowp) @ ste(p["cls_head"]["w"], prec.lowp) \
            + p["cls_head"]["b"]
        last = len(hs) - 1
        feats = [hs[i + 1 if i >= 0 else last] for i in self.mix["taps"]]
        size = batch["pixels"].shape[1]
        seg = decoder(p["decoder"], feats, size // cfg["patch_size"], size,
                      prec)
        ce = -(F.log_softmax(cls, -1).gather(
            1, batch["cls"].long()[:, None])).mean()
        hm = batch["has_mask"]
        l_seg = (seg_loss(seg, batch["mask"]) * hm).sum() / hm.sum().clamp(
            min=1.0)
        return cls_w * ce + seg_w * l_seg

    def run(self, batches, cls_w: float, seg_w: float) -> dict:
        names = list(self.train)
        leaves = [self.train[n] for n in names]
        start = [t.detach().clone() for t in leaves]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        losses, first, norm1 = [], None, None
        mix = self.mix
        with no_tf32():
            for count, batch in enumerate(batches):
                for t in leaves:
                    t.grad = None
                loss = self.loss(batch, cls_w, seg_w)
                loss.backward()
                grads = [t.grad if t.grad is not None else
                         torch.zeros_like(t) for t in leaves]
                norm = torch.sqrt(sum((g.double() ** 2).sum()
                                      for g in grads))
                scale = float(CLIP / norm) if norm > CLIP else 1.0
                grads = [g * scale for g in grads]
                if first is None:
                    first = {n: g.detach().cpu() for n, g in
                             zip(names, grads)}
                    norm1 = float(norm)
                lr = schedule(count, mix["lr"], mix["warmup_steps"],
                              mix["total_steps"])
                with torch.no_grad():
                    for t, g, m, v in zip(leaves, grads, mu, nu):
                        m.mul_(B1).add_(g, alpha=1 - B1)
                        v.mul_(B2).addcmul_(g, g, value=1 - B2)
                        upd = (m / (1 - B1 ** (count + 1))) / (
                            torch.sqrt(v / (1 - B2 ** (count + 1)))
                            + ADAM_EPS) + WEIGHT_DECAY * t
                        t.sub_(lr * upd)
                losses.append(float(loss.detach()))
        return {"losses": losses, "grad": first, "norm": norm1,
                "change": {n: (t.detach() - s).cpu() for n, t, s in
                           zip(names, leaves, start)},
                "trend": {n: m.cpu() for n, m in zip(names, mu)}}
