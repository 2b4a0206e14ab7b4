"""A/B timing of K1's attention launch alone and of the three detect
cores on one card, in the tree whose root is the first argument: run it
once per tree and per turn, in one chip call (parent, change, change,
parent), each tree unpacked under the git-ignored build/ (git archive).

    python3 tpudf_torch/tools/ab_k1.py build/parent old
    python3 tpudf_torch/tools/ab_k1.py . new

`old` drives a tree whose K1 attention is the mma.sync entry point
`tpudf_attention_i8` (before the wgmma kernel); `new` calls
`int8_block.attention_i8`. Prints one line "AB {json}": device ms of the
attention launch at the detect cores' first layers (B = 8 and the cores'
B), CUDA-event ms of the cores at B = 256 / 128 / 64, engine B's full
analysis of 8, and the base-256 core at B = 8 (events and device), with
the card's name and power limit. Needs a card; builds the tree's kernels
into its own build/.
"""
import os, sys, time, json, subprocess
root = os.path.abspath(sys.argv[1]); old = sys.argv[2] == "old"
os.chdir(root); sys.path.insert(0, root)
import torch
from tpudf_torch.ops import _build, int8_block
from tpudf_torch.entry import build
from tpudf_torch.core.backend import LAUNCHES
_build.load()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"], capture_output=True, text=True).stdout.strip()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(5)
def dev_ms(fn, iters=20):
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters): fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in p.events() if e.device_type == DeviceType.CUDA) / 1e3 / iters
def ev_ms(fn, iters=10):
    for _ in range(2): fn()
    torch.cuda.synchronize(); a = torch.cuda.Event(True); b = torch.cuda.Event(True)
    a.record()
    for _ in range(iters): fn()
    b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / iters
act = torch.tensor(6.0, device=dev)
out = {"tree": "parent" if old else "change", "card": card}
for label, bs, s, heads, hd, live in [("base-256", (8, 256), 256, 12, 64, 64), ("large-384", (8, 128), 576, 16, 64, 64), ("so400m-512", (8, 64), 1024, 16, 128, 72)]:
    for b in bs:
        t = torch.randn((b, s, 3, heads, hd), generator=g, device=dev) * 1.5
        t[..., live:] = 0
        qkv = t.reshape(b, s, -1).to(torch.bfloat16); del t
        sc = live ** -0.5
        if old:
            o8 = torch.empty((b * s, heads * hd), dtype=torch.int8, device=dev)
            fn = lambda: _build.call("tpudf_attention_i8", qkv, None, act, o8, b, s, heads, hd, float(sc))
        else:
            fn = lambda: int8_block.attention_i8(qkv, heads, hd, act, sc, live=None if live == hd else live)
        out[f"attn {label} B={b}"] = dev_ms(fn)
        del qkv
for name, b in (("base-256", 256), ("large-384", 128), ("so400m-512", 64)):
    model = build("cuda", cfg_name=name)
    size = model.cfg.image_size
    px = torch.rand((b, size, size, 3), generator=g, device=dev).to(torch.bfloat16)
    out[f"core {name} B={b}"] = ev_ms(lambda: model(px), 5)
    del model, px; torch.cuda.empty_cache()
import numpy as np
from tpudf_torch.entry import build_engine
eng = build_engine(dev, seed=0, int8=True, tome=True, patch_tome=True)
req = np.random.default_rng(3).integers(0, 256, (8, 256, 256, 3), np.uint8)
out["engine B full 8"] = ev_ms(lambda: eng.fetch_batch(eng.dispatch_batch(req, False), False), 5)
model = build("cuda", cfg_name="base-256")
px = torch.rand((8, 256, 256, 3), generator=g, device=dev).to(torch.bfloat16)
out["core base-256 B=8"] = ev_ms(lambda: model(px), 20)
out["core base-256 B=8 device"] = dev_ms(lambda: model(px), 5)
print("AB", json.dumps(out), flush=True)
