"""SID visualization suite (tpudf/eval/visualize.py): overlays,
collages, the IoU-bucket matrix, results tables.

A copy of the JAX package's module (host numpy, PIL for WebP), kept here
so that this package imports nothing of `tpudf`. Re-design of
siglip2siddataset.py:191-691: TP/FP/FN color overlays, prediction
collages, the IoU-bucket distribution and CSV/LaTeX results tables.
"""

from __future__ import annotations

import os

import numpy as np


def mask_overlay(image_uint8, pred_mask, true_mask=None, alpha=0.45):
    """TP green / FP red / FN blue overlay (siglip2siddataset.py:191-243).
    image: (H, W, 3) uint8; masks: (H, W) in {0,1}. Returns uint8 RGB."""
    img = image_uint8.astype(np.float32)
    pred = np.asarray(pred_mask) > 0.5
    color = np.zeros_like(img)
    if true_mask is None:
        color[pred] = (255, 0, 0)
        hit = pred
    else:
        true = np.asarray(true_mask) > 0.5
        tp = pred & true
        fp = pred & ~true
        fn = ~pred & true
        color[tp] = (0, 255, 0)
        color[fp] = (255, 0, 0)
        color[fn] = (0, 90, 255)
        hit = tp | fp | fn
    out = img.copy()
    out[hit] = img[hit] * (1 - alpha) + color[hit] * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def collage(images, cols=4, pad=2):
    """Stack uint8 images (same size) into a grid collage
    (siglip2siddataset.py:283-390)."""
    if not len(images):
        return None
    h, w = images[0].shape[:2]
    rows = (len(images) + cols - 1) // cols
    canvas = np.full(((h + pad) * rows - pad, (w + pad) * cols - pad, 3),
                     255, np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * (h + pad):r * (h + pad) + h,
               c * (w + pad):c * (w + pad) + w] = im
    return canvas


def iou_bucket_matrix(ious, labels_true, labels_pred,
                      buckets=(0.0, 0.25, 0.5, 0.75, 1.01)):
    """Joint distribution of IoU bucket x classification correctness
    (siglip2siddataset.py:605-689)."""
    ious = np.asarray(ious, np.float64)
    correct = np.asarray(labels_true) == np.asarray(labels_pred)
    nb = len(buckets) - 1
    mat = np.zeros((nb, 2), np.int64)
    for i in range(nb):
        in_b = (ious >= buckets[i]) & (ious < buckets[i + 1])
        mat[i, 0] = int((in_b & ~correct).sum())
        mat[i, 1] = int((in_b & correct).sum())
    names = [f"[{buckets[i]:.2f},{buckets[i+1]:.2f})" for i in range(nb)]
    return mat, names


def results_table(metrics: dict, save_dir=None, name="results",
                  caption="tpudf results"):
    """CSV + LaTeX results table export (hidf publication tables :843-899).
    metrics: {row_name: {col: value}}."""
    rows = sorted(metrics)
    cols = sorted({c for r in metrics.values() for c in r})
    csv_lines = [",".join(["run"] + cols)]
    for r in rows:
        csv_lines.append(",".join(
            [r] + [f"{metrics[r].get(c, float('nan')):.4f}"
                   if isinstance(metrics[r].get(c), (int, float))
                   else str(metrics[r].get(c, "")) for c in cols]))
    csv_text = "\n".join(csv_lines)

    tex = ["\\begin{table}[t]", "\\centering",
           "\\begin{tabular}{l" + "c" * len(cols) + "}", "\\toprule",
           " & ".join(["Run"] + cols) + " \\\\", "\\midrule"]
    for r in rows:
        tex.append(" & ".join(
            [r.replace('_', '\\_')] +
            [f"{metrics[r].get(c, float('nan')):.3f}"
             if isinstance(metrics[r].get(c), (int, float))
             else str(metrics[r].get(c, "")) for c in cols]) + " \\\\")
    tex += ["\\bottomrule", "\\end{tabular}",
            f"\\caption{{{caption}}}", "\\end{table}"]
    tex_text = "\n".join(tex)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, name + ".csv"), "w") as f:
            f.write(csv_text)
        with open(os.path.join(save_dir, name + ".tex"), "w") as f:
            f.write(tex_text)
    return csv_text, tex_text


def save_webp(image_uint8, path, quality=80):
    """WebP overlay export (siglip2siddataset.py:1479-1488)."""
    from PIL import Image
    Image.fromarray(image_uint8).save(path, "WEBP", quality=quality)
