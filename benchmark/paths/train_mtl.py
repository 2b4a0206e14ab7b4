"""The MTL fine-tuning path: the port's trainer as `tpudf_torch.entry.
build_mtl_trainer` builds it for `cli/train_mtl.py` (float, the
embeddings and layers below freeze_below frozen, the SegFormer decoder,
AdamW on the CLI's warmup-cosine schedule), from the benchmark's weights,
stepped as the CLI's loop steps it: a generator a step, the epoch's loss
weights, the loss read back after every step.

Traffic keys: "batch", "image_size", "pool_batches" (distinct seeded
batches held on the card: uint8 pixels, labels, masks; step i takes entry
i mod pool_batches), "freeze_below", "taps", "embed_dim", "seg_loss",
"lr", "warmup_steps", "total_steps", "epochs" (the loss weights are
epoch 0's of that many). Set-up builds the trainer and runs its first
`SETUP_STEPS` steps on pool entries 0, 1, 2 through the window's own
call; the window continues the same trainer. The reference follows those
steps and the window's first `WINDOW_STEPS`: every one of their losses,
the first gradient as the optimizer took it, and the trainable leaves
after the window's third step (copied on the card there) are compared;
after the window, every frozen entry has to equal the benchmark's
weights.
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark.harness import inputs, weights
from benchmark.paths import Window
from benchmark.reference.common import CONTROL, SOUND
from benchmark.reference.mtl import (B1, MTLReference, leaf_name,
                                     leaf_paths, trainable_names)

SETUP_STEPS = 3       # set-up's steps, before the window
WINDOW_STEPS = 3      # the window's first steps the reference follows
GRAD_FLOOR = 1e-3     # entries whose reference gradient is under this
                      # share of the median leaf's rms move by round-off


def check_port_config(config: dict):
    """The port's SigLIPConfig named by the configuration file, which has
    to hold the file's widths (the trainer takes a name)."""
    from tpudf_torch.models.siglip import CONFIGS
    c = CONFIGS[config["port_name"]]
    want = (config["hidden_size"], config["num_hidden_layers"],
            config["num_attention_heads"], config["intermediate_size"],
            config["image_size"], config["patch_size"])
    got = (c.width, c.layers, c.heads, c.mlp_dim, c.image_size,
           c.patch_size)
    if got != want:
        raise ValueError(f"the port's {config['port_name']} is {got}, the "
                         f"configuration file {want}")
    return c


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from tpudf_torch.entry import build_mtl_trainer
        from tpudf_torch.train.mtl import dynamic_loss_weights
        self.cell, self.seed, self.device, self.spans = (cell, seed, device,
                                                         spans)
        mix, config = cell.mix, cell.config
        check_port_config(config)
        self.pool_n, size = mix["pool_batches"], mix["image_size"]
        with spans("inputs"):
            g = weights.generator(seed, weights.INPUTS, device)
            self.pool = []
            for _ in range(self.pool_n):
                b = inputs.mtl_batch(g, mix["batch"], size, device)
                b["pixels"] = ((b["pixels"] + 1.0) * 127.5).round().to(
                    torch.uint8)
                self.pool.append(b)
        with spans("weights"):
            params = self._weights()
        with spans("build"):
            self.state, self.step, _ = build_mtl_trainer(
                params, cfg_name=config["port_name"],
                freeze_below=mix["freeze_below"],
                embed_dim=mix["embed_dim"], seg_layers=tuple(mix["taps"]),
                lr=mix["lr"], warmup_steps=mix["warmup_steps"],
                total_steps=mix["total_steps"], seg_loss=mix["seg_loss"],
                image_size=size)
            _sync(device)
        self.cls_w, self.seg_w = dynamic_loss_weights(0, mix["epochs"])
        rows = trainable_names(params, mix["freeze_below"])
        self.names = [leaf_name(p) for p, _ in leaf_paths(params)
                      if leaf_name(p) in rows]
        self.rows = rows
        with spans("first_steps"):
            self.losses = []
            for i in range(SETUP_STEPS):
                self.losses.append(self._step(i))
                if i == 0:
                    self.grad1 = [m.cpu() / (1 - B1) for m in
                                  self.state.opt_state["mu"]]
        self.steps, self.refs = SETUP_STEPS, {}

    def _weights(self):
        mix = self.cell.mix
        return weights.make(
            weights.mtl_spec(self.cell.config, mix["taps"],
                             mix["embed_dim"]),
            weights.generator(self.seed, weights.WEIGHTS, self.device),
            self.device)

    def _batch(self, j: int) -> dict:
        b = self.pool[j % self.pool_n]
        return dict(b, pixels=b["pixels"].float() / 127.5 - 1.0)

    def _step(self, i: int) -> float:
        """One step as the CLI's loop takes it; returns the loss read
        back."""
        with self.spans("step"):
            gen = torch.Generator(device=self.device).manual_seed(i)
            self.state, m = self.step(self.state, self._batch(i), gen,
                                      self.cls_w, self.seg_w)
        with self.spans("loss_readback"):
            return float(m["loss"])

    def _trainable(self) -> list:
        """Copies, on the card, of the trainable rows of each leaf."""
        leaves = dict((leaf_name(p), t) for p, t in
                      leaf_paths(self.state.params))
        return [leaves[n].detach()[self.rows[n]:].clone()
                for n in self.names]

    def window(self, seconds: float, spans) -> Window:
        from tpudf_torch.core.backend import LAUNCHES
        LAUNCHES.reset()
        n0 = self.steps
        t0 = time.perf_counter()
        while True:
            loss = self._step(self.steps)
            self.steps += 1
            k = self.steps - n0
            if k <= WINDOW_STEPS:
                self.losses.append(loss)
                if k == WINDOW_STEPS:
                    self.after = self._trainable()
            if k >= WINDOW_STEPS and time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        t1 = time.perf_counter()
        n = self.steps - n0
        images = n * self.cell.mix["batch"]
        return Window(t0, t1, {"steps": n, "images": images},
                      LAUNCHES.snapshot(), n, 0)

    def end_to_end(self, win: Window) -> dict:
        return {"train_img_per_s": win.work["images"] / win.seconds}

    def release(self):
        """Keeps the compared leaves on the host, counts the frozen
        entries that differ from the benchmark's weights, and frees the
        trainer."""
        start = dict((leaf_name(p), t) for p, t in
                     leaf_paths(self._weights()))
        self.frozen = 0
        for p, t in leaf_paths(self.state.params):
            name = leaf_name(p)
            r = self.rows.get(name)           # None: frozen whole
            if r != 0:
                self.frozen += int((t.detach()[:r] != start[name][:r])
                                   .sum())
        self.change = {n: (a - start[n][self.rows[n]:]).cpu()
                       for n, a in zip(self.names, self.after)}
        del self.state, self.step, self.after, start
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec, rows=None) -> dict:
        ref = MTLReference(self._weights(), self.cell.config, self.cell.mix,
                           prec)
        batches = [self._batch(i)
                   for i in range(SETUP_STEPS + WINDOW_STEPS)]
        if rows:
            batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        return dict(ref.run(batches, self.cls_w, self.seg_w), frozen=0)

    def _program(self) -> dict:
        return {"losses": self.losses,
                "grad": dict(zip(self.names, self.grad1)),
                "change": self.change, "frozen": self.frozen}

    def readings(self, candidate: str = "program") -> dict:
        """The candidate: "program", "control", or "half" (the fault of
        half the batch left out, planted in the reference)."""
        if "sound" not in self.refs:
            self.refs["sound"] = self._reference(SOUND)
        ref = self.refs["sound"]
        if candidate == "program":
            got = self._program()
        elif candidate == "half":
            got = self._reference(SOUND, rows=self.cell.mix["batch"] // 2)
        else:
            got = self._reference(CONTROL)
        return gaps(got, ref)


def gaps(got: dict, ref: dict) -> dict:
    """loss: the largest gap of a step's loss over the reference's.
    grad and change: the worst leaf's gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf. direction: the worst leaf's
    sum w·|Δgot − Δref| over sum w·|Δref| of the change, w the
    reference's last first moment, so that an entry weighs by the
    gradient that steers it. change and direction count only entries
    whose reference gradient is at least GRAD_FLOOR of the median leaf's
    rms (a key's bias under softmax has a gradient of rounding alone,
    which Adam turns into whole steps of either sign on either side).
    frozen: the frozen entries that moved."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 ref["losses"]))
    names = list(ref["grad"])
    rms = statistics.median(float(g.norm()) / g.numel() ** 0.5
                            for g in ref["grad"].values())
    moving = {n: ref["grad"][n].abs() >= GRAD_FLOOR * rms for n in names}

    def worst(key, mask=None):
        def norm(t, n):
            return float((t[moving[n]] if mask else t).norm())
        r = {n: norm(ref[key][n], n) for n in names}
        g = {n: norm(got[key][n], n) for n in names}
        med = statistics.median(r.values())
        return max(abs(g[n] - r[n]) / max(r[n], med) for n in names)

    def direction(n):
        m = moving[n]
        w = ref["trend"][n][m].abs()
        d = ref["change"][n][m]
        den = float((w * d.abs()).sum())
        return float((w * (got["change"][n][m] - d).abs()).sum()) / den \
            if den > 0 else 0.0

    return {"loss": loss, "grad": worst("grad"),
            "change": worst("change", mask=True),
            "direction": max(direction(n) for n in names),
            "frozen": float(got["frozen"])}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
