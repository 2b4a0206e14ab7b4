"""The four kernels of the detect-core path, and their plain twins.

The main path always runs `KERNELS`: each wrapper takes its plain twin for
a CPU tensor and launches its CUDA kernel for a CUDA tensor. `TWINS` holds
the twins with the same signatures, so that a reference run on the card
(chip_smoke.py) can push the same parameters through the same composition
without any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from tpudf_torch.ops import int8_block, layernorm, mlp, srm


@dataclasses.dataclass(frozen=True)
class KernelSet:
    layer_norm: Callable            # K4
    attn_sublayer_int8: Callable    # K1
    mlp_block_fused_int8: Callable  # K2
    srm_raw_moments: Callable       # K3


KERNELS = KernelSet(
    layer_norm=layernorm.layer_norm_fused,
    attn_sublayer_int8=int8_block.attn_sublayer_int8,
    mlp_block_fused_int8=mlp.mlp_block_fused_int8,
    srm_raw_moments=srm.srm_raw_moments,
)

TWINS = KernelSet(
    layer_norm=layernorm.layer_norm_reference,
    attn_sublayer_int8=int8_block.attn_sublayer_reference,
    mlp_block_fused_int8=mlp.mlp_block_int8_reference,
    srm_raw_moments=srm.srm_raw_moments_reference,
)
