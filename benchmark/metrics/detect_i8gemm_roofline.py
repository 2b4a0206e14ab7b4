"""The roofline share of the int8 GEMM kernel (`i8_gemm_sm90`: qkv,
out-projection, fc1 and fc2 of every block) in the detect core: the least
time of the window's batches' int8 products on an H100
(`counts.detect_i8gemm_work`, `peaks.bound_s`) over the device time of
the kernels named below in the trace, in %."""

from benchmark.harness import counts, devtrace, peaks

KERNELS = ("i8_gemm_sm90",)


def read(rec):
    if rec.trace is None or not rec.window.work.get("batches"):
        return None
    busy = devtrace.kernel_seconds(rec.trace["by_name"], KERNELS)
    bound = peaks.bound_s(*counts.detect_i8gemm_work(
        rec.cell.config, rec.cell.mix["batch"]))
    return peaks.share(bound * rec.window.work["batches"], busy)
