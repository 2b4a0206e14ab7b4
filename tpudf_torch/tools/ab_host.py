"""A/B of host-bound paths in the tree whose root is the first argument,
run once per tree and per turn in one chip call (parent, change, change,
parent):

    python3 tpudf_torch/tools/ab_host.py build/parent
    python3 tpudf_torch/tools/ab_host.py build/final

Prints one line "ABH {json}": engine B's full analysis of 8 (CUDA events,
three runs of 10 requests, sorted) and the host's cost of one K1 sublayer
call (its Python and launches: 400 calls at (8, 160, 768) with a key bias,
one synchronize at the end; three runs, sorted), with the card's name and
power limit. Needs a card.
"""
import os, sys, json, time, subprocess, statistics
root = os.path.abspath(sys.argv[1]); os.chdir(root); sys.path.insert(0, root)
import numpy as np, torch
from tpudf_torch.ops import _build, int8_block
from tpudf_torch.ops.quant import quantize_weight
from tpudf_torch.convert import add_kernel_layout
from tpudf_torch.entry import build_engine
_build.load()
dev = torch.device("cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"], capture_output=True, text=True).stdout.strip()
def ev_ms(fn, iters):
    for _ in range(2): fn()
    torch.cuda.synchronize(); a = torch.cuda.Event(True); b = torch.cuda.Event(True)
    a.record()
    for _ in range(iters): fn()
    b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / iters
out = {"tree": root, "card": card}
eng = build_engine(dev, seed=0, int8=True, tome=True, patch_tome=True)
req = np.random.default_rng(3).integers(0, 256, (8, 256, 256, 3), np.uint8)
out["engine B full 8"] = sorted(ev_ms(lambda: eng.fetch_batch(eng.dispatch_batch(req, False), False), 10) for _ in range(3))
g = torch.Generator(device=dev).manual_seed(0)
r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
w = 768
x = r(8, 160, w).to(torch.bfloat16)
args = (x, {"scale": 1 + r(w, std=0.1), "bias": r(w, std=0.1)},
        add_kernel_layout(quantize_weight(r(w, 3 * w, std=w ** -0.5))), r(3 * w, std=0.1),
        add_kernel_layout(quantize_weight(r(w, w, std=w ** -0.5))), r(w, std=0.1),
        torch.tensor(4.0, device=dev), torch.tensor(6.0, device=dev), 12, 64)
lb = torch.log(torch.randint(1, 9, (8, 160), generator=g, device=dev).float())
fn = lambda: int8_block.attn_sublayer_int8(*args, logit_bias=lb)
for _ in range(20): fn()
torch.cuda.synchronize()
host = []
for _ in range(3):
    t0 = time.perf_counter()
    for _ in range(400): fn()
    host.append((time.perf_counter() - t0) / 400 * 1e6)
    torch.cuda.synchronize()
out["K1 sublayer host us a call"] = sorted(host)
print("ABH", json.dumps(out), flush=True)
