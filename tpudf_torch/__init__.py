"""tpudf_torch — the PyTorch/CUDA port of tpudf for NVIDIA Hopper.

The JAX package `tpudf/` is the reference; this package mirrors its layout
and names and imports neither JAX nor `tpudf`.

Layering:
  core/      device probes, launch counters, precision policy
  ops/       hand-written Hopper kernels (csrc/*.cu, built by ops/_build.py)
             with their plain PyTorch twins, plus plain-torch ops
  models/    SigLIP tower (W8A8 and bf16 blocks), heads, frequency MLP, fusion,
             the SegFormer decoder and the MTL model
  calib/     CORAL ordinal calibration and the MoE fallback blend
  data/      device-side preprocessing: crops, patch grid, JAX-rule resize;
             the folder image and video datasets; the synthetic generators
  serve/     the batched detection engine (53-view and fast paths)
  train/     losses, AdamW, the multi-task (MTL) and binary steps, the
             expert stack's fits, the video step, loops, checkpoints
  eval/      metrics (numpy)
  cli/       the trainers (`python -m tpudf_torch.cli.train_mtl`,
             `train_binary`, `train_experts`, `train_video`,
             `face_pretrain`), the inference and forensics CLIs
  probes/    kernels 15-17, the JAX probe scripts' kernels, each a runnable
             module (`python -m tpudf_torch.probes.micro_epilogue`)
  utils/     small numeric helpers; the safetensors format in numpy
  convert.py numpy copy of a tpudf params pytree -> tensors of this package
  entry.py   the detect-core main path (`build`, `DetectCore`), the
             serving engine as the inference CLI builds it (`build_engine`)
             and the MTL trainer (`build_mtl_trainer`)
"""

__version__ = "0.1.0"
