"""The plain references of the port's timed paths: PyTorch in float32
with TF32 off, no kernels, no caches. They import nothing of the program
(`tpudf_torch`), of `tpudf` or of JAX, take only the weights and inputs
the benchmark made, and work out every derived table themselves (the
activation scales, the int8 codes, the ToMe merges, the optimizer state).

`Precision` selects the arithmetic: `SOUND` is the reference;
`CONTROL` is the same reference one precision step below what each stage
of the configuration states (int8 → int4, bf16 → fp8 e4m3, f32 → bf16),
the control that the comparison has to fail.
"""
