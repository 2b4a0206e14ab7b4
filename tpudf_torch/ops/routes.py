"""The kernels of the detect-core, engine, MTL-training and weights-in
paths, and their plain twins (with the port's int8 GEMM for the W8A8
block's XLA products, which is no TPU kernel's port: `int8_acc`).

The main path always runs `KERNELS`: each wrapper takes its plain twin for
a CPU tensor and launches its CUDA kernel for a CUDA tensor. `TWINS` holds
the twins with the same signatures, so that a reference run on the card
(chip_smoke.py) can push the same parameters through the same composition
without any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from tpudf_torch.ops import (attention, int8_block, layernorm, linear, mlp,
                             quant, srm)


@dataclasses.dataclass(frozen=True)
class KernelSet:
    layer_norm: Callable            # K4
    attn_sublayer_int8: Callable    # K1
    mlp_block_fused_int8: Callable  # K2
    srm_raw_moments: Callable       # K3
    attention_qkv: Callable         # K9
    attention_qkv_bwd: Callable     # K10
    linear_fused: Callable          # K13
    mlp_block_fused: Callable       # K14
    ln_qkv_int8: Callable           # K5
    attn_out_int8: Callable         # K6
    siglip_layer_int8: Callable     # K7
    layer_norm_quant: Callable      # K8
    int8_acc: Callable              # exact int32 product of quant.py's
                                    # int8_matmul* (XLA in JAX)
    attention_qkv_int8: Callable    # 9b (K9's dynamic-int8 mode; the
                                    # reference route of attn_out_int8)
    attention: Callable             # 11 (B, H, S, D): the multi-query _mha
    attention_bshd: Callable        # 12 (B, S, H, D)


KERNELS = KernelSet(
    layer_norm=layernorm.layer_norm_fused,
    attn_sublayer_int8=int8_block.attn_sublayer_int8,
    mlp_block_fused_int8=mlp.mlp_block_fused_int8,
    srm_raw_moments=srm.srm_raw_moments,
    attention_qkv=attention.attention_qkv,
    attention_qkv_bwd=attention.attention_qkv_bwd,
    linear_fused=linear.linear_fused,
    mlp_block_fused=mlp.mlp_block_fused,
    ln_qkv_int8=int8_block.ln_qkv_int8,
    attn_out_int8=int8_block.attn_out_int8,
    siglip_layer_int8=int8_block.siglip_layer_int8,
    layer_norm_quant=layernorm.layer_norm_quant,
    int8_acc=quant.int8_acc,
    attention_qkv_int8=attention.attention_qkv_int8,
    attention=attention.attention,
    attention_bshd=attention.attention_bshd,
)

TWINS = KernelSet(
    layer_norm=layernorm.layer_norm_reference,
    attn_sublayer_int8=int8_block.attn_sublayer_reference,
    mlp_block_fused_int8=mlp.mlp_block_int8_reference,
    srm_raw_moments=srm.srm_raw_moments_reference,
    attention_qkv=attention.attention_qkv_reference,
    attention_qkv_bwd=attention.attention_qkv_bwd_reference,
    linear_fused=linear.linear_fused_reference,
    mlp_block_fused=mlp.mlp_block_reference,
    ln_qkv_int8=int8_block.ln_qkv_reference,
    attn_out_int8=int8_block.attn_out_reference,
    siglip_layer_int8=int8_block.siglip_layer_int8_reference,
    layer_norm_quant=layernorm.layer_norm_quant_reference,
    int8_acc=quant.int8_acc_reference,
    attention_qkv_int8=attention.attention_qkv_int8_reference,
    attention=attention.attention_reference,
    attention_bshd=attention._reference_bshd,
)
