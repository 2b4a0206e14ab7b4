"""A/B timing of the probes' kernels on one card, in the tree whose root is
the first argument: run it once per tree and per turn, in one chip call
(parent, change, change, parent), the other tree unpacked under the
git-ignored build/ (git archive).

    python3 tpudf_torch/tools/ab_probes.py build/parent old
    python3 tpudf_torch/tools/ab_probes.py . new

Prints one line "AB {json}" with the card's name and power limit: the
device ms (profiler: the kernels' summed durations) of
  15-16  kernel 15's `int8_matmul_staticq` and kernel 16's `fc1_matmul`
         full / nogelu / bf16_epi at (M, K, N) = (16384 | 65536, 768,
         3072) on kernel 16's seeded inputs (M = 16384: their first rows),
         k_noquant's (int8 x read from memory) as the control, and where
         the tree has the split form (`common.quant_gemm_split`) that
         form's device ms and its GEMM on the codes alone;
  17     kernel 17's `attention_qkv_int8_static` at the probe's (8, 1024,
         6144), 16 heads of 128, on its seeded inputs: each launch's
         device ms by kernel name and their sum (the signature is the
         same in every tree that has the probe).
Needs a card; builds the tree's kernels into its own build/.
"""
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpudf_torch.ops import _build  # noqa: E402
from tpudf_torch.probes import common  # noqa: E402
from tpudf_torch.probes import micro_epilogue as p16  # noqa: E402
from tpudf_torch.probes import micro_pallas_int8 as p15  # noqa: E402

_build.load()
dev = torch.device("cuda")
act = common.act_scale(dev)
split = hasattr(common, "quant_gemm_split")
out = {"tree": sys.argv[2], "card": cs.card_line()}


def forms(key, mode, x, wt, s, b):
    """The split form and its GEMM on the codes, where the tree has them."""
    if not split:
        return
    m, k = x.shape
    n = wt.shape[0]
    codes = common.quant_codes(x, common.INV_ACT).to(torch.int8)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    out[f"{key} split"] = cs.device_ms(lambda: common.quant_gemm_split(
        mode, x, wt, s, b, act))
    out[f"{key} GEMM on codes"] = cs.device_ms(lambda: _build.call(
        "tpudf_i8_gemm", codes, wt, s, b, act, None, y, None, None, m, n, k,
        common.QUANT_MODES[mode]))


def k17():
    """Kernel 17's launches at the probe's shape: {kernel: device ms}."""
    from tpudf_torch.probes import micro_attn_static as p17
    _, b, s, w, d = p17.GEOMETRIES[0]
    heads, scale = w // d, d ** -0.5
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, s, 3 * w), generator=g, device=dev).to(
        torch.bfloat16)
    call = lambda: p17.attention_qkv_int8_static(qkv, heads, d, scale)
    per = cs.kernel_events(call, 10)[0]
    out["17 launches"] = {k.split("(")[0][-60:]: v for k, v in per.items()}
    out["17"] = cs.device_ms(call)


k17()
t = p16.inputs(dev)
wt, s, b = t["wt"], t["s"], t["b"]
for m in (16384, 65536):
    x, xi = t["x_bf"][:m], t["x_i8"][:m]
    out[f"15-int8 M={m}"] = cs.device_ms(
        lambda: p15.int8_matmul_staticq(x, wt, s, act=act))
    forms(f"15-int8 M={m}", "staticq", x, wt, s, None)
    for v in p16.QUANTISED:
        out[f"16-{v} M={m}"] = cs.device_ms(
            lambda: p16.fc1_matmul(v, x, wt, s, b, act=act))
        forms(f"16-{v} M={m}", v, x, wt, s, b)
    out[f"16-noquant M={m}"] = cs.device_ms(
        lambda: p16.fc1_matmul("noquant", xi, wt, s, b, act=act))
print("AB " + json.dumps(out), flush=True)
