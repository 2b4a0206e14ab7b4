"""Card-only tests: each CUDA kernel of tpudf_torch against its plain twin
on the card, at small shapes (the main path's shapes are checked by
chip_smoke.py). Marked `gpu`; each test skips inside its body when no card
is visible, so every worker collects the same tests. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import pytest
import torch

from tpudf_torch.ops import int8_block, layernorm, mlp, quant, srm

W, HEADS, HD, INTER = 128, 2, 64, 256


def _card_case(name, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
    ln = {"scale": 1.0 + r(W, std=0.1), "bias": r(W, std=0.1)}
    if name == "K4":
        x = (r(300, W) * 3).to(torch.bfloat16)
        return (layernorm.layer_norm_fused(x, ln["scale"], ln["bias"]),
                layernorm.layer_norm_reference(x, ln["scale"], ln["bias"]),
                1e-6, 2 ** -7)
    if name == "K3":
        gray = torch.rand((3, 64, 128), generator=g, device=dev)
        return (srm.srm_raw_moments(gray),
                srm.srm_raw_moments_reference(gray), 1e-6, 1e-4)
    if name == "K1":
        wq = quant.quantize_weight(r(W, 3 * W, std=W ** -0.5))
        oq = quant.quantize_weight(r(W, W, std=W ** -0.5))
        x = r(4, 40, W).to(torch.bfloat16)
        lb = torch.log(torch.randint(1, 5, (4, 40), generator=g,
                                     device=dev).float())
        args = (x, ln, wq, r(3 * W, std=0.1), oq, r(W, std=0.1),
                torch.tensor(4.0, device=dev), torch.tensor(2.0, device=dev),
                HEADS, HD)
        return (int8_block.attn_sublayer_int8(*args, logit_bias=lb),
                int8_block.attn_sublayer_reference(*args, logit_bias=lb),
                5e-2, 2e-2)
    mq = {"fc1_w": quant.quantize_weight(r(W, INTER, std=W ** -0.5)),
          "fc1_b": r(INTER, std=0.1),
          "fc2_w": quant.quantize_weight(r(INTER, W, std=INTER ** -0.5)),
          "fc2_b": r(W, std=0.1)}
    sc = {"fc1": torch.tensor(4.0, device=dev),
          "fc2": torch.tensor(3.0, device=dev)}
    x = r(3, 50, W).to(torch.bfloat16)
    return (mlp.mlp_block_fused_int8(x, ln, mq, sc),
            mlp.mlp_block_int8_reference(x, ln, mq, sc), 5e-2, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4"])
def test_kernel_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, ref, atol, rtol = _card_case(name, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
