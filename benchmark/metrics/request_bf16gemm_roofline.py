"""The roofline share of the bf16 GEMM kernel (`bf16_gemm_sm90`: K13's
qkv and out-projection, K14's fc1 and fc2 in every block) in the full
analysis: the least time of the window's requests' block products on an
H100 (`counts.request_bf16gemm_work`, `peaks.bound_s`) over the device
time of the kernels named below in the trace, in %."""

from benchmark.harness import counts, devtrace, peaks

KERNELS = ("bf16_gemm_sm90",)


def read(rec):
    n = rec.window.work.get("requests")
    if rec.trace is None or not n:
        return None
    busy = devtrace.kernel_seconds(rec.trace["by_name"], KERNELS)
    bound = peaks.bound_s(*counts.request_bf16gemm_work(
        rec.cell.config, rec.cell.mix["request_images"]))
    return peaks.share(bound * n, busy)
