"""tpudf_torch — the PyTorch/CUDA port of tpudf for NVIDIA Hopper.

The JAX package `tpudf/` is the reference; this package mirrors its layout
and names and imports neither JAX nor `tpudf`.

Layering:
  core/      device probes, launch counters, precision policy
  ops/       hand-written Hopper kernels (csrc/*.cu, built by ops/_build.py)
             with their plain PyTorch twins, plus plain-torch ops
  models/    SigLIP tower, heads, frequency MLP, fusion
  calib/     CORAL ordinal calibration
  convert.py numpy copy of a tpudf params pytree -> tensors of this package
  entry.py   the detect-core main path (`build`, `DetectCore`)
"""

__version__ = "0.1.0"
