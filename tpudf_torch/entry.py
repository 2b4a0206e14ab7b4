"""The detect-core main path (tpudf's `__graft_entry__.entry()`), and the
serving engine as the inference CLI builds it (`build_engine`).

Pixels in [0,1] (B, 256, 256, 3) → SigLIP-normalised → static-W8A8
base-256 tower with ToMe at the deployed schedule (r=96, floor S/8: tokens
256→160→80→40→32) → MAP head → v5 binary head (z_sig); in parallel grey
pixels → 24-d FFT/SRM/Haar vector → frequency MLP (z_freq); then the
Linear(2→1) fusion of the two probabilities and CORAL.

`build(device, seed, cfg_name)` initialises seeded random weights,
calibrates the activation scales on 32 seeded images, quantises (with
`prepad_siglip_static`: so400m-512's heads of 72 and MLP of 4304 padded
to 128 and 4352), and returns a `DetectCore` whose `forward(pixels)` is
that path at the config's image size; base-256 by default, also
large-384 (576 → 72 tokens) and so400m-512 (1024 → 128).
`build_engine(device, ...)` returns the `serve.engine.DetectEngine` of
`tpudf/cli/infer.py` (`build_engine`) with seeded random weights, or with
the backbone read from an HF SiglipVisionModel state dict
(`backbone_ckpt`, through `models/convert.py`): by default the bf16 tower,
no ToMe, linear fusion; base-256, large-384 or so400m-512 (its float MLP
of 4304 padded to 4352 once, `siglip.tower_params`).
`build_mtl_trainer(params, ...)` returns the multi-task trainer of
`tpudf/cli/train_mtl.py` (SegFormer decoder over the tower's hidden
states, frozen prefix, AdamW) of a tree from `mtl_params(device, ...)`
(seeded random weights or a converted backbone), at the config's image
size or another (`image_size`: the position table is interpolated, as
the CLI's default large-384 at 256 px does).
`build_binary_trainer(device, ...)` returns the binary classifier
trainer of `tpudf/cli/train_binary.py` (a frozen tower, bf16 or static
W8A8 with optional ToMe, or the tower trained with the head; the v5 or
fast head; EMA, mixup, AdamW or Adafactor), the one function that the
`train_binary` CLI and chip_smoke.py both drive.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from tpudf_torch.calib.coral import CoralCutpoints, coral_blend
from tpudf_torch.convert import add_kernel_layout
from tpudf_torch.core.precision import DEFAULT_POLICY, Policy, tree_map
from tpudf_torch.models.freq_mlp import apply_freq_mlp, init_freq_mlp
from tpudf_torch.models.fusion import apply_fusion_linear, init_fusion_linear
from tpudf_torch.models.convert import _load_state_dict, from_hf_state_dict
from tpudf_torch.models.heads import (apply_binary_head,
                                     apply_fast_binary_head,
                                     init_binary_head, init_fast_binary_head)
from tpudf_torch.models.segformer import MTLConfig, init_mtl
from tpudf_torch.models.siglip import (CONFIGS, SigLIPConfig, init_siglip,
                                       siglip_forward, tower_params)
from tpudf_torch.ops.fft_features import extract_freq_vector
from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                   quantize_siglip_static)
from tpudf_torch.ops.routes import KERNELS, KernelSet
from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                  deployed_floor, deployed_patch_floor)
from tpudf_torch.serve.engine import DetectEngine
from tpudf_torch.train.mtl import (make_mtl_eval_step, make_mtl_train_step,
                                   quantize_frozen_prefix)
from tpudf_torch.train.steps import (TrainState, init_train_state,
                                     make_binary_train_step, make_optimizer)

ENTRY_KEYS = ("p_blend", "risk_probs", "z_sig", "z_freq")
GRAY = (0.299, 0.587, 0.114)


@torch.no_grad()
def detect_core(params, pixels, cfg: SigLIPConfig, cuts: CoralCutpoints,
                policy: Policy = DEFAULT_POLICY, *,
                kernels: KernelSet = KERNELS):
    """params: {"backbone", "head", "freq", "fusion"}; pixels (B, H, W, 3)
    in [0,1]. Returns the entry keys plus "pooled". `kernels=TWINS` runs
    the same composition through the plain twins (a reference run)."""
    cdt = policy.compute_dtype
    px = pixels.to(cdt)
    norm = (px - 0.5) / 0.5
    feats = siglip_forward(params["backbone"], norm, cfg, policy,
                           tome_r=DEPLOYED_TOME_R,
                           tome_floor=deployed_floor(cfg.num_patches),
                           kernels=kernels)["pooled"]
    z_sig = apply_binary_head(params["head"], feats)
    coeff = torch.tensor(GRAY, dtype=cdt, device=pixels.device)
    gray = torch.matmul(px.float(), coeff.float())
    fv = extract_freq_vector(gray, kernels)
    z_freq = apply_freq_mlp(params["freq"], fv)
    p_sig = torch.sigmoid(z_sig)
    p_freq = torch.sigmoid(z_freq)
    z_fused = apply_fusion_linear(params["fusion"], p_sig, p_freq)
    out = coral_blend(z_fused, cuts)
    return {"p_blend": out["p_blend"], "risk_probs": out["risk_probs"],
            "z_sig": z_sig, "z_freq": z_freq, "pooled": feats}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


class DetectCore(nn.Module):
    """Holds the parameter tree as buffers; forward(pixels) is the main
    path. `.to(device)` moves every tensor."""

    def __init__(self, params, cfg: SigLIPConfig, cuts: CoralCutpoints):
        super().__init__()
        self.cfg, self.cuts = cfg, cuts
        self._paths = []
        for path, leaf in _flatten(params):
            name = path.replace("/", "__")
            self.register_buffer(name, leaf)
            self._paths.append((path, name))

    def param_tree(self):
        tree: dict = {}
        for path, name in self._paths:
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = getattr(self, name)
        return tree

    def forward(self, pixels):
        out = detect_core(self.param_tree(), pixels, self.cfg, self.cuts)
        return {k: out[k] for k in ENTRY_KEYS}


def init_params(generator: torch.Generator, cfg: SigLIPConfig):
    """Seeded float parameters of the four models."""
    return {"backbone": init_siglip(generator, cfg),
            "head": init_binary_head(generator, cfg.width),
            "freq": init_freq_mlp(generator),
            "fusion": init_fusion_linear(generator)}


def build(device, seed: int = 0, cfg_name: str = "base-256",
          calib_images: int = 32):
    """Initialise, calibrate on `calib_images` seeded images, quantise:
    the deployed detect core on `device`."""
    cfg = CONFIGS[cfg_name]
    gen = torch.Generator().manual_seed(seed)
    params = init_params(gen, cfg)
    calib = (torch.rand((calib_images, cfg.image_size, cfg.image_size, 3),
                        generator=gen) - 0.5) / 0.5
    params = tree_map(lambda t: t.to(device), params)
    scales = calibrate_siglip_act_scales(params["backbone"], cfg,
                                         calib.to(device), DEFAULT_POLICY)
    params["backbone"] = quantize_siglip_static(params["backbone"], scales,
                                                cfg)
    return DetectCore(add_kernel_layout(params), cfg,
                      CoralCutpoints.default()).to(device)


def load_backbone(path: str, cfg: SigLIPConfig):
    """The tower tree of an HF SiglipVisionModel state dict file (a
    `.safetensors` file, or a torch `.pt` of {name: tensor}), on the CPU,
    as the JAX CLIs read `--backbone_ckpt`."""
    return from_hf_state_dict(_load_state_dict(path), cfg)


def build_engine(device, seed: int = 0, cfg_name: str = "base-256",
                 int8: bool = False, tome: bool = False,
                 patch_tome: bool = False, fusion: bool = True,
                 backbone_ckpt: str | None = None):
    """The serving engine on `device` with seeded random weights.

    int8: quantize() to static W8A8 (calibrated on the engine's default
    noise batch); tome / patch_tome: the deployed ToMe schedule (r=96,
    floor S/8) / the deployed deeper patch-view schedule (r=128, floor
    S/16); fusion=False: no fusion head (the MoE fallback);
    backbone_ckpt: the tower from this HF state dict file (`load_backbone`)
    in place of the random one, loaded onto `device`. base-256, large-384
    and so400m-512."""
    cfg = CONFIGS[cfg_name]
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    if backbone_ckpt:
        params["backbone"] = load_backbone(backbone_ckpt, cfg)
    params = tree_map(lambda t: t.to(device), params)
    n = cfg.num_patches
    eng = DetectEngine(
        cfg=cfg, backbone=params["backbone"], head=params["head"],
        freq=params["freq"], fusion=params["fusion"] if fusion else None,
        cuts=CoralCutpoints.default(), policy=DEFAULT_POLICY,
        tome_r=DEPLOYED_TOME_R if tome else 0,
        tome_floor=deployed_floor(n) if tome else 0,
        patch_tome_r=DEPLOYED_PATCH_TOME_R if patch_tome else 0,
        patch_tome_floor=deployed_patch_floor(n) if patch_tome else 0)
    if int8:
        eng.quantize()
    return eng


def mtl_params(device="cuda", seed: int = 0, cfg_name: str = "base-256",
               embed_dim: int = 256, seg_layers=(2, 6, 10, -1),
               backbone_ckpt: str | None = None):
    """The MTL tree on `device` that `build_mtl_trainer` trains: seeded
    random weights, or the tower of `backbone_ckpt` (an HF state dict
    file, `load_backbone`) as `init_mtl(..., backbone)` takes it in the
    JAX CLI, with the head and decoder from the seed. The CLI builds it
    before it loads its data, as the JAX CLI does."""
    cfg = MTLConfig(backbone=CONFIGS[cfg_name], seg_layers=tuple(seg_layers),
                    embed_dim=embed_dim)
    backbone = (load_backbone(backbone_ckpt, cfg.backbone) if backbone_ckpt
                else None)
    return tree_map(lambda t: t.to(device),
                    init_mtl(torch.Generator().manual_seed(seed), cfg,
                             backbone))


def _check_mtl_tree(params, cfg: MTLConfig):
    """Raise unless the tree has cfg's depth, width, taps and embed_dim."""
    b = cfg.backbone
    got = (tuple(params["backbone"]["blocks"]["attn"]["qkv_w"].shape[:2]),
           [tuple(p["w"].shape) for p in params["decoder"]["projs"]])
    want = ((b.layers, b.width),
            [(b.width, cfg.embed_dim)] * len(cfg.seg_layers))
    if got != want:
        raise ValueError(f"the MTL tree has (layers, width) and decoder "
                         f"projections {got}, the config {want}")


def build_mtl_trainer(params, cfg_name: str = "base-256",
                      freeze_below: int = 9, int8_frozen: bool = False,
                      embed_dim: int = 256, seg_layers=(2, 6, 10, -1),
                      lr: float = 5e-5, warmup_steps: int = 100,
                      total_steps: int = 10_000, accum_steps: int = 1,
                      seg_loss: str = "combined",
                      kernels: KernelSet = KERNELS, calib_pixels=None,
                      seed: int = 0, image_size: int | None = None):
    """The MTL trainer of the tree `params` (from `mtl_params` with the
    same cfg_name, embed_dim and seg_layers; it trains on the tree's
    device), the default policy (bf16 compute, f32 master weights) and
    make_optimizer(lr, warmup_steps=warmup_steps, total_steps=total_steps).
    image_size: the training images' size (the config's by default;
    another one interpolates the position table in the forward).
    Returns (state, step, eval_step): step(state, batch,
    generator, cls_w, seg_w) → (state, metrics) updates the state in place;
    eval_step(params, pixels) → (cls_logits, seg_probs).

    freeze_below: the embeddings and layers below it are frozen (None
    trains everything). int8_frozen: those layers run on the static-W8A8
    kernels, calibrated on `calib_pixels` (SigLIP-normalised, (N, S, S, 3);
    default 16 images of image_size drawn from `seed`), as the CLI
    calibrates on the first 16 training images. kernels=TWINS runs the
    same trainer through the plain twins."""
    cfg = MTLConfig(backbone=CONFIGS[cfg_name], seg_layers=tuple(seg_layers),
                    embed_dim=embed_dim)
    _check_mtl_tree(params, cfg)
    device = params["cls_head"]["w"].device
    frozen_q = None
    if int8_frozen:
        if freeze_below is None:
            raise ValueError("int8_frozen needs freeze_below")
        if calib_pixels is None:
            s = image_size or cfg.backbone.image_size
            calib_pixels = (torch.rand(
                (16, s, s, 3), generator=torch.Generator().manual_seed(seed))
                - 0.5) / 0.5
        frozen_q = quantize_frozen_prefix(params, cfg,
                                          calib_pixels.to(device),
                                          DEFAULT_POLICY, freeze_below)
    init_fn, step = make_mtl_train_step(
        cfg, make_optimizer(lr, warmup_steps=warmup_steps,
                            total_steps=total_steps), DEFAULT_POLICY,
        freeze_below=freeze_below, seg_loss=seg_loss,
        accum_steps=accum_steps, frozen_q=frozen_q, kernels=kernels)
    return (init_fn(params), step,
            make_mtl_eval_step(cfg, DEFAULT_POLICY, kernels))


class BinaryTrainer(NamedTuple):
    """What `build_binary_trainer` returns. step(state, backbone, batch,
    generator) → (state, metrics) updates the state in place (`make_binary
    _train_step`); logits(params, pixels) → (B,) evaluates a head (or
    {"backbone", "head"} when the tower trains) without dropout, with the
    trainer's ToMe, as the CLI's eval does."""
    state: TrainState
    backbone: Any              # the frozen tower as the step reads it
    step: Callable
    logits: Callable


def build_binary_trainer(device="cuda", seed: int = 0,
                         cfg_name: str = "base-256", head: str = "v5",
                         int8_backbone: bool = False,
                         tome_r: int | None = None,
                         ema_decay: float | None = None,
                         mixup_alpha: float = 0.0,
                         train_backbone: bool = False, remat: bool = False,
                         backbone_ckpt: str | None = None, lr: float = 1e-4,
                         weight_decay: float = 1e-4, warmup_steps: int = 100,
                         total_steps: int = 10_000, calib_pixels=None,
                         kernels: KernelSet = KERNELS):
    """The binary classifier trainer of `tpudf/cli/train_binary.py` on
    `device`: the tower from `backbone_ckpt` (an HF state dict file,
    `load_backbone`) or seeded random weights (seed), the head ("v5", or
    "fast": the CiFake "small" head) from seed + 1, the default policy
    (bf16 compute, f32 masters) and make_optimizer(lr, weight_decay,
    warmup_steps, total_steps).

    Frozen tower (the default): bf16 (`tower_params`), or with
    int8_backbone statically quantised to W8A8 after calibrating its
    activation scales on `calib_pixels` (SigLIP-normalised (N, S, S, 3);
    default 16 seeded images), as the CLI calibrates on the first training
    batch. tome_r: None no ToMe, -1 the deployed schedule (r = 96, floor
    S/8: the CLI's bare --tome_r), else that r with the default floor.
    train_backbone: the tower's f32 masters train with the head (remat:
    each block recomputed in the backward); ToMe is refused there, as in
    JAX. ema_decay: an EMA of the trainable parameters; mixup_alpha > 0:
    mixup on each batch. Returns a `BinaryTrainer`."""
    cfg = dataclasses.replace(CONFIGS[cfg_name], remat=remat)
    policy = DEFAULT_POLICY
    gen = torch.Generator().manual_seed(seed)
    backbone = (load_backbone(backbone_ckpt, cfg) if backbone_ckpt
                else init_siglip(gen, cfg))
    hgen = torch.Generator().manual_seed(seed + 1)
    head_p = (init_binary_head(hgen, cfg.width) if head == "v5"
              else init_fast_binary_head(hgen, cfg.width, "small"))
    backbone = tree_map(lambda t: t.to(device), backbone)
    head_p = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t,
                      head_p)
    r, floor = 0, 0
    if tome_r is not None:
        r = DEPLOYED_TOME_R if tome_r < 0 else int(tome_r)
        floor = deployed_floor(cfg.num_patches) if tome_r < 0 else 0
    if train_backbone and (int8_backbone or r):
        raise ValueError("int8_backbone and tome_r are frozen-backbone "
                         "modes")
    if int8_backbone:
        if calib_pixels is None:
            s = cfg.image_size
            calib_pixels = (torch.rand((16, s, s, 3), generator=gen)
                            - 0.5) / 0.5
        with torch.no_grad():
            scales = calibrate_siglip_act_scales(
                backbone, cfg, calib_pixels.to(device), policy)
            backbone = quantize_siglip_static(backbone, scales, cfg)
    opt = make_optimizer(lr, weight_decay, warmup_steps, total_steps)
    if train_backbone:
        state = init_train_state({"backbone": backbone, "head": head_p}, opt,
                                 ema_decay)
        frozen = None
    else:
        state = init_train_state(head_p, opt, ema_decay)
        frozen = tower_params(backbone, policy.compute_dtype)
    step = make_binary_train_step(
        cfg, opt, policy, head, ema_decay=ema_decay, mixup_alpha=mixup_alpha,
        train_backbone=train_backbone, tome_r=r, tome_floor=floor,
        kernels=kernels)
    apply = apply_binary_head if head == "v5" else functools.partial(
        apply_fast_binary_head, kernels=kernels)

    @torch.no_grad()
    def logits(params, pixels):
        bb, hp = ((params["backbone"], params["head"]) if train_backbone
                  else (frozen, params))
        feats = siglip_forward(bb, pixels, cfg, policy, tome_r=r,
                               tome_floor=floor, kernels=kernels)["pooled"]
        return apply(hp, feats)

    return BinaryTrainer(state, frozen, step, logits)


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Multi-rank validation (`__graft_entry__.dryrun_multichip`): n ranks
    under torchrun each run one binary train step with the tower trained
    over a (n/2, 2) mesh when n >= 4 and even, else (n, 1): the data
    axis' gradient all-reduce and the model axis' tensor-parallel
    collectives, forward and backward. device="cuda": one card a rank
    over NCCL, at base-256 cut to 2 layers at 64 px (the kernels' widths);
    raises with fewer than n cards. device="cpu": gloo ranks at test-32.
    Raises when a rank fails."""
    from tpudf_torch.parallel.dist import torchrun

    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) on cuda needs {n} cards, "
                           f"{torch.cuda.device_count()} visible")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    rc = torchrun(n, ["-m", "tpudf_torch.entry", "--dryrun", "--device",
                      device]).wait()
    if rc != 0:
        raise RuntimeError(f"dryrun_multichip({n}, {device!r}) failed "
                           f"(rc={rc})")


def _dryrun_rank(device: str) -> None:
    """One rank of `dryrun_multichip` (started by torchrun)."""
    import numpy as np

    from tpudf_torch.core.mesh import make_mesh
    from tpudf_torch.parallel.dist import (initialize_from_env, shutdown,
                                           world)
    from tpudf_torch.parallel.training import ShardedTrainer, batch_generator
    from tpudf_torch.train.steps import make_binary_train_step, make_optimizer

    if not initialize_from_env(device=device):
        raise RuntimeError("the dryrun rank runs under torchrun")
    rank, n = world()
    model = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = make_mesh(n // model, model)
    if device == "cuda":
        cfg = dataclasses.replace(CONFIGS["base-256"], layers=2,
                                  image_size=64)
    else:
        cfg = CONFIGS["test-32"]
    backbone = init_siglip(torch.Generator().manual_seed(0), cfg)
    head = init_binary_head(torch.Generator().manual_seed(1), cfg.width)
    opt = make_optimizer(lr=1e-3, total_steps=10)
    step = make_binary_train_step(cfg, opt, train_backbone=True)
    trainer = ShardedTrainer(mesh, step, opt,
                             {"backbone": backbone, "head": head}, cfg=cfg)
    b = 2 * mesh.data
    s = cfg.image_size
    pixels = np.random.default_rng(0).random((b, s, s, 3), np.float32)
    labels = (np.arange(b) % 2).astype(np.float32)
    rows = slice(mesh.data_index * 2, mesh.data_index * 2 + 2)
    m = trainer.step({"pixels": pixels[rows], "labels": labels[rows]},
                     batch_generator(0, 0, mesh.device))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"rank {rank}: loss {loss}")
    if rank == 0:
        print(f"[dryrun_multichip] n={n} mesh=({mesh.data}, {mesh.model}) "
              f"{device} loss={loss:.6f} ok", flush=True)
    shutdown()


if __name__ == "__main__":
    import argparse

    _p = argparse.ArgumentParser(description="tpudf_torch entry points")
    _p.add_argument("--dryrun", action="store_true",
                    help="one rank of dryrun_multichip (under torchrun)")
    _p.add_argument("--device", default="cuda")
    _a = _p.parse_args()
    if _a.dryrun:
        _dryrun_rank(_a.device)
