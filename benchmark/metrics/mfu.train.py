"""The MTL step's matrix-product operations over the window
(`counts.mtl_ops_per_image`: the frozen prefix's forward, the trainable
blocks' and heads' forward and backward, the decoder's products both
ways) against the H100's bf16 dense peak of 989 TFLOP/s, in %."""

from benchmark.harness import counts, peaks


def read(rec):
    images = rec.window.work.get("images")
    if not images or "steps" not in rec.window.work:
        return None
    mix = rec.cell.mix
    ops = counts.mtl_ops_per_image(rec.cell.config, mix["image_size"],
                                   mix["freeze_below"], mix["taps"],
                                   mix["embed_dim"]) * images
    return peaks.share(ops / peaks.PEAK["bf16"], rec.window.seconds)
