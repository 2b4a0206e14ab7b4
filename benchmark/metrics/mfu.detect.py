"""The detect core's matrix-product operations over the window
(`counts.detect_ops_per_image`: the ToMe tower, the merges' similarity
products, the MAP and v5 heads, the frequency MLP) against the H100's
int8 dense peak of 1,979 TOP/s, in %."""

from benchmark.harness import counts, peaks


def read(rec):
    images = rec.window.work.get("images")
    if not images:
        return None
    ops = counts.detect_ops_per_image(rec.cell.config) * images
    return peaks.share(ops / peaks.PEAK["int8"], rec.window.seconds)
