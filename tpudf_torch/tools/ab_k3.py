"""A/B timing of K3 (the SRM moments) alone and of base-256's tower
without ToMe under TPUDF_INT8_KERNELS=LLL on one card, in the tree whose
root is the first argument: run it once per tree and per turn, in one chip
call (parent, change, change, parent), the other tree unpacked under the
git-ignored build/ (git archive).

    python3 tpudf_torch/tools/ab_k3.py build/parent old
    python3 tpudf_torch/tools/ab_k3.py . new

Prints one line "AB {json}": K3's device ms at B = 8, 64, 128 and 256
images of 256 x 256, the LLL tower's device ms and launches at B = 8 (the
tree's own routing: K7, or FPP where JAX's K7 does not fit), and the
default (FPP) detect cores' device ms, base-256 at B = 256 and large-384
at B = 128, with the card's name and power limit. Needs a card; builds
the tree's kernels into its own build/.
"""
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpudf_torch.core.backend import LAUNCHES  # noqa: E402
from tpudf_torch.entry import build  # noqa: E402
from tpudf_torch.models.siglip import siglip_forward  # noqa: E402
from tpudf_torch.ops import _build, srm  # noqa: E402

_build.load()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
out = {"tree": sys.argv[2], "card": cs.card_line()}
for b in (8, 64, 128, 256):
    gray = torch.rand((b, 256, 256), generator=g, device=dev)
    out[f"K3 B={b}"] = cs.device_ms(lambda: srm.srm_raw_moments(gray),
                                    iters=20)
model = build(dev, seed=0)
params = model.param_tree()
norm = torch.rand((8, 256, 256, 3), generator=g, device=dev).to(
    torch.bfloat16) * 2 - 1
os.environ["TPUDF_INT8_KERNELS"] = "LLL"
with torch.no_grad():
    LAUNCHES.reset()
    siglip_forward(params["backbone"], norm, model.cfg)
    torch.cuda.synchronize()
    out["LLL tower launches"] = LAUNCHES.snapshot()
    out["LLL tower B=8 device ms"] = cs.device_ms(
        lambda: siglip_forward(params["backbone"], norm, model.cfg))
os.environ.pop("TPUDF_INT8_KERNELS")
for cfg_name, b, px_size in (("base-256", 256, 256), ("large-384", 128, 384)):
    if cfg_name != "base-256":
        model = build(dev, seed=0, cfg_name=cfg_name)
    px = torch.rand((b, px_size, px_size, 3), generator=g, device=dev).to(
        torch.bfloat16)
    with torch.no_grad():
        out[f"{cfg_name} core B={b} device ms"] = cs.device_ms(
            lambda: model(px), iters=5)
    del px
print("AB " + json.dumps(out), flush=True)
