"""The full analysis's matrix-product operations over the window
(`counts.request_ops`: 53 views an image through the bf16 tower and the
v5 head, the frequency MLP on 34; the view resampling is not counted)
against the H100's bf16 dense peak of 989 TFLOP/s, in %."""

from benchmark.harness import counts, peaks


def read(rec):
    n = rec.window.work.get("requests")
    if not n:
        return None
    ops = counts.request_ops(rec.cell.config,
                             rec.cell.mix["request_images"]) * n
    return peaks.share(ops / peaks.PEAK["bf16"], rec.window.seconds)
