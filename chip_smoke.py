#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (tpudf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing falls
back to the CPU or to a twin):
  1. card name and power limit (nvidia-smi), build of the four kernels from
     tpudf_torch/csrc with nvcc for sm_90a;
  2. each kernel against its plain PyTorch twin on the card at the main
     path's shapes (TF32 off for cuBLAS and cuDNN), tolerances below;
  3. the detect-core slice: build("cuda", seed=0) at base-256, requests of
     8 and 256 seeded bf16 images through DetectCore; finite outputs,
     p_blend in [0, 1], risk_probs rows summing to 1, launch counts per
     forward (K1 12, K2 12 of which 4 emit Σout², K3 1, K4 2), and the same
     parameters through the twins: pooled cosine >= 0.99, |Δp_blend| <= 1e-2;
  4. CUDA-event timings: each kernel vs its twin, and the B=8 and B=256
     forwards, kernels vs twins; then a torch.profiler trace of the B=256
     forward: the largest kernels and the device's idle share.
Prints a JSON line of the kernels, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPLACES = {
    "K1": "tpudf/ops/int8_block.py:121",
    "K2": "tpudf/ops/mlp.py:116",
    "K3": "tpudf/ops/srm.py:97",
    "K4": "tpudf/ops/layernorm.py:18",
}
SOURCES = {
    "K1": "tpudf_torch/csrc/attention.cu",
    "K2": "tpudf_torch/csrc/int8_gemm.cu",
    "K3": "tpudf_torch/csrc/srm.cu",
    "K4": "tpudf_torch/csrc/layernorm.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, twin_fn, iters):
    """Twin, kernel, kernel, twin in one process; mean of each pair."""
    t1 = cuda_ms(twin_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    t2 = cuda_ms(twin_fn, iters)
    return (k1 + k2) / 2, (t1 + t2) / 2


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, ref, atol, rtol):
    import torch
    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    bad = int((err > bound).sum())
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(
            f"{name}: {bad} of {got.numel()} elements outside atol={atol} "
            f"rtol={rtol} (max |Δ| {float(err.max()):.3e})")


def profile_forward(model, px, card, iters=5, top=12):
    """Kernel-level device time of the forward (torch.profiler): the
    largest kernels, their share, and the device's idle share of the
    traced wall time."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(px)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    per_name = collections.defaultdict(float)
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3 / iters
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, e in sorted(spans):               # union of kernel intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy /= 1e3 * iters
    total = sum(per_name.values())
    print(f"profile B={px.shape[0]}: traced wall {wall:.3f} ms/forward, "
          f"kernels {total:.3f} ms, device idle share {1 - busy / wall:.3f} "
          f"[{card}]")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}%  {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES, has_triton
    from tpudf_torch.entry import build, detect_core
    from tpudf_torch.ops import _build, int8_block, layernorm, mlp, srm
    from tpudf_torch.ops.quant import quantize_weight
    from tpudf_torch.ops.routes import TWINS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | triton {'present' if has_triton() else 'absent'} (unused: "
          f"all four kernels are CUDA C++)", flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds} s) -> {_build.build_log}", flush=True)
    for line in _build.build_log.read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels vs twins at the main path's shapes
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    w, heads, hd, inter = 768, 12, 64, 3072
    ln1 = {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)}
    qkv_wq = add_kernel_layout(quantize_weight(randn(w, 3 * w, std=w ** -0.5)))
    out_wq = add_kernel_layout(quantize_weight(randn(w, w, std=w ** -0.5)))
    qkv_b, out_b = randn(3 * w, std=0.1), randn(w, std=0.1)
    a_qkv = torch.tensor(4.0, device=dev)
    a_out = torch.tensor(2.0, device=dev)
    mlp_q = add_kernel_layout({
        "fc1_w": quantize_weight(randn(w, inter, std=w ** -0.5)),
        "fc1_b": randn(inter, std=0.1),
        "fc2_w": quantize_weight(randn(inter, w, std=inter ** -0.5)),
        "fc2_b": randn(w, std=0.1)})
    mlp_sc = {"fc1": torch.tensor(4.0, device=dev),
              "fc2": torch.tensor(3.0, device=dev)}

    results = {}

    def record(key, name, err, kernel_fn, twin_fn, iters=20):
        ms, plain = paired_ms(kernel_fn, twin_fn, iters)
        results.setdefault(key, {"name": name, "route": "cuda",
                                 "source": SOURCES[key],
                                 "replaces": REPLACES[key],
                                 "max_abs_err": 0.0, "cases": []})
        r = results[key]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append({"ms": ms, "plain_ms": plain})
        print(f"  {key} {name}: max|Δ| {err:.3e}  kernel {ms:.4f} ms  "
              f"twin {plain:.4f} ms  [{card}]", flush=True)

    # K1: (8, 256, 768) without bias, (256, 32, 768) with bias log(size)
    for b, s, with_bias in ((8, 256, False), (256, 32, True)):
        x = randn(b, s, w).to(torch.bfloat16)
        lb = (torch.log(torch.randint(1, 9, (b, s), generator=g, device=dev)
                        .float()) if with_bias else None)
        args = (x, ln1, qkv_wq, qkv_b, out_wq, out_b, a_qkv, a_out, heads, hd)
        got = int8_block.attn_sublayer_int8(*args, logit_bias=lb)
        ref = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
        torch.cuda.synchronize()
        # bf16 output: within a few bf16 steps; the twin rounds the
        # attention output to bf16 before its int8 quant (JAX reference
        # form), the kernel quantises the f32 output (TPU kernel)
        check_close(f"K1 {(b, s, w)} bias={with_bias}", got, ref,
                    atol=5e-2, rtol=2e-2)
        record("K1", "attn_sublayer_int8", max_abs(got, ref),
               lambda: int8_block.attn_sublayer_int8(*args, logit_bias=lb),
               lambda: int8_block.attn_sublayer_reference(*args,
                                                          logit_bias=lb))

    # K2: (8*256, 768) rows, with and without Σout²
    x = randn(8, 256, w).to(torch.bfloat16)
    for ss in (False, True):
        got = mlp.mlp_block_fused_int8(x, ln1, mlp_q, mlp_sc, emit_sumsq=ss)
        ref = mlp.mlp_block_int8_reference(x, ln1, mlp_q, mlp_sc,
                                           emit_sumsq=ss)
        torch.cuda.synchronize()
        if ss:
            (got, got_ss), (ref, ref_ss) = got, ref
            own = torch.sum(got.float() ** 2, dim=-1)
            check_close("K2 sumsq vs own output", got_ss, own, 0.0, 1e-4)
            check_close("K2 sumsq vs twin", got_ss, ref_ss, 0.0, 1e-3)
        check_close(f"K2 (2048, 768) sumsq={ss}", got, ref, atol=5e-2,
                    rtol=2e-2)
        record("K2", "mlp_block_fused_int8", max_abs(got, ref),
               lambda: mlp.mlp_block_fused_int8(x, ln1, mlp_q, mlp_sc,
                                                emit_sumsq=ss),
               lambda: mlp.mlp_block_int8_reference(x, ln1, mlp_q, mlp_sc,
                                                    emit_sumsq=ss))

    # K3: (8, 256, 256) f32 grey images; f64 sums in the kernel vs f32
    # means in the twin
    gray = torch.rand((8, 256, 256), generator=g, device=dev)
    got = srm.srm_raw_moments(gray)
    ref = srm.srm_raw_moments_reference(gray)
    torch.cuda.synchronize()
    check_close("K3 (8, 256, 256)", got, ref, atol=1e-6, rtol=1e-4)
    record("K3", "srm_raw_moments", max_abs(got, ref),
           lambda: srm.srm_raw_moments(gray),
           lambda: srm.srm_raw_moments_reference(gray))

    # K4: (256*32, 768) bf16 rows; one bf16 rounding step
    x = (randn(256 * 32, w) * 3.0 + 0.5).to(torch.bfloat16)
    got = layernorm.layer_norm_fused(x, ln1["scale"], ln1["bias"])
    ref = layernorm.layer_norm_reference(x, ln1["scale"], ln1["bias"])
    torch.cuda.synchronize()
    check_close("K4 (8192, 768)", got, ref, atol=1e-6, rtol=2 ** -7)
    record("K4", "layer_norm_fused", max_abs(got, ref),
           lambda: layernorm.layer_norm_fused(x, ln1["scale"], ln1["bias"]),
           lambda: layernorm.layer_norm_reference(x, ln1["scale"],
                                                  ln1["bias"]))

    # ---- 3. the slice
    t0 = time.perf_counter()
    model = build(dev, seed=0)
    torch.cuda.synchronize()
    print(f"slice: build (init + calibrate on 32 images + quantise) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    params = model.param_tree()
    expect = {int8_block.KERNEL: 12, mlp.KERNEL: 12, mlp.KERNEL_SUMSQ: 4,
              srm.KERNEL: 1, layernorm.KERNEL: 2}
    pg = torch.Generator(device=dev).manual_seed(2)
    launches = {}
    for b in (8, 256):
        px = torch.rand((b, 256, 256, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        LAUNCHES.reset()
        out = model(px)
        torch.cuda.synchronize()
        launches = LAUNCHES.snapshot()
        if launches != expect:
            raise AssertionError(f"B={b}: launches {launches} != {expect}")
        for k, v in out.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"B={b}: {k} not finite")
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"p_blend": (b,), "risk_probs": (b, 5), "z_sig": (b,),
                      "z_freq": (b,)}:
            raise AssertionError(f"B={b}: shapes {shapes}")
        pb = out["p_blend"]
        if not ((pb >= 0) & (pb <= 1)).all():
            raise AssertionError(f"B={b}: p_blend outside [0, 1]")
        rs = out["risk_probs"].sum(-1)
        if not torch.allclose(rs, torch.ones_like(rs), atol=1e-5):
            raise AssertionError(f"B={b}: risk_probs rows do not sum to 1")
        kern = detect_core(params, px, model.cfg, model.cuts)
        twin = detect_core(params, px, model.cfg, model.cuts, kernels=TWINS)
        torch.cuda.synchronize()
        cos = torch.nn.functional.cosine_similarity(
            kern["pooled"].float(), twin["pooled"].float(), dim=-1)
        dpb = float((kern["p_blend"] - twin["p_blend"]).abs().max())
        dmain = float((out["p_blend"] - kern["p_blend"]).abs().max())
        print(f"slice B={b}: launches {launches}; pooled cosine min "
              f"{float(cos.min()):.6f} mean {float(cos.mean()):.6f}; "
              f"max|Δp_blend| twin {dpb:.3e}, repeat {dmain:.3e}; "
              f"p_blend mean {float(pb.float().mean()):.4f}", flush=True)
        if float(cos.min()) < 0.99 or dpb > 1e-2:
            raise AssertionError(f"B={b}: kernels vs twins disagree")

    # ---- 4. the forward at B=8 (a small request) and B=256: kernels vs twins
    for b, iters in ((8, 20), (256, 5)):
        px = torch.rand((b, 256, 256, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        fwd_ms, fwd_plain = paired_ms(
            lambda: model(px),
            lambda: detect_core(params, px, model.cfg, model.cuts,
                                kernels=TWINS), iters=iters)
        print(f"forward B={b}: kernels {fwd_ms:.3f} ms = "
              f"{b * 1e3 / fwd_ms:.1f} img/s; twins {fwd_plain:.3f} ms = "
              f"{b * 1e3 / fwd_plain:.1f} img/s [{card}]", flush=True)
    print(f"peak device memory of this script "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    profile_forward(model, px, card)

    names = {"K1": int8_block.KERNEL, "K2": mlp.KERNEL, "K3": srm.KERNEL,
             "K4": layernorm.KERNEL}
    kernels = []
    for key in ("K1", "K2", "K3", "K4"):
        r = dict(results[key])
        cases = r.pop("cases")
        r["launches"] = launches[names[key]]
        r["ms"] = sum(c["ms"] for c in cases) / len(cases)
        r["plain_ms"] = sum(c["plain_ms"] for c in cases) / len(cases)
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
