"""Run one cell of the benchmark on the card and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last checks
(each number compared, beside its limit). The numbers compared are also
the last lines of standard error. No card, too few cards, or a module of
JAX or of the JAX package loaded in this process: a message on standard
error, no result, and a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpudf")
CACHE = ROOT / "build" / "bench_cache"     # fixed, inside the checkout


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: tpudf_torch is not tpudf."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.clock import process_start
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    from benchmark.harness import manifest
    cell = manifest.find_cell(manifest.load_manifest(ROOT), args.workload,
                              ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    from benchmark.harness import runner
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start, root=ROOT)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
