"""Block-map forensic CLI on PyTorch (tpudf/cli/forensics.py;
ultra_forensics.py:226-269 / ultra_diagnostics.py:109-149 parity): the
anomaly-map battery of an image on the device (the card unless `--device
cpu`), saved as jet heatmaps, and the forensic battery's scores as JSON.

Usage: python -m tpudf_torch.cli.forensics IMAGE [--out_dir ultra_out]
           [--reduced] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="tpudf_torch forensic map "
                                            "battery")
    p.add_argument("image")
    p.add_argument("--out_dir", default="ultra_out")
    p.add_argument("--reduced", action="store_true",
                   help="PRNU + JPEG maps only (ultra_diagnostics parity)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from tpudf_torch.data.media import load_image_any, validate_image
    from tpudf_torch.ops.forensic_maps import (forensic_map_battery,
                                               heatmap_overlay,
                                               jpeg_residual_map,
                                               prnu_fft_consistency_map,
                                               prnu_strength_map)
    from tpudf_torch.ops.forensics import _gray, f32_math, forensic_battery

    arr = validate_image(load_image_any(args.image))
    img256 = np.array(Image.fromarray(arr).resize((256, 256)), np.uint8)
    x = torch.from_numpy(img256[None]).to(args.device).float() / 255.0
    with f32_math():
        gray = _gray(x)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.reduced:
        maps = {"prnu_strength": prnu_strength_map(gray),
                "prnu_fft": prnu_fft_consistency_map(gray),
                "jpeg_residual": jpeg_residual_map(x)}
    else:
        maps = forensic_map_battery(x, gray)

    for name, m in maps.items():
        ov = heatmap_overlay(img256, m[0])
        Image.fromarray(ov).save(os.path.join(args.out_dir, f"{name}.png"))

    scores = {k: float(v[0]) for k, v in forensic_battery(x).items()}
    with open(os.path.join(args.out_dir, "scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps({"maps": sorted(maps), "out_dir": args.out_dir,
                      "top_scores": dict(sorted(
                          scores.items(), key=lambda kv: -kv[1])[:8])},
                     indent=2))


if __name__ == "__main__":
    main()
