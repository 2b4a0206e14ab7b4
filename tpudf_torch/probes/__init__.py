"""The port's probes: kernels 15, 16 and 17, each a hand-written Hopper
kernel with its plain PyTorch twin, in a runnable module named after the
JAX probe script it mirrors (`scripts/micro_*.py`). No user path reaches
them; each runs on the card as its own entry point:

    python -m tpudf_torch.probes.micro_attn_static   # kernel 17
    python -m tpudf_torch.probes.micro_pallas_int8   # kernel 15
    python -m tpudf_torch.probes.micro_epilogue      # kernel 16
"""
