"""The readings an output limit is set from, in one process:

    python benchmark/tools/calibrate.py --workload <cell> --seeds 1,...,12
        --control-seeds 1,2,3 [--seconds 2] [--out readings.json]

For each seed the cell's driver is built at the cell's own size, runs a
short window at the cell's own load, and its numbers are read against
the reference as a run reads them; for each control seed the control
(the reference one precision step down, in the program's place) is read
too, and each planted fault named by --faults. Prints a line a reading
and, a number at a time, the largest program reading (the lower end of
its limit) and the smallest control and fault readings (the upper end).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import manifest
    from benchmark.harness.clock import Spans
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="further candidates read on the control seeds "
                         "(a driver's planted faults, e.g. half)")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = manifest.find_cell(manifest.load_manifest(ROOT), a.workload,
                              ROOT)
    ctl_seeds = {int(s) for s in a.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        spans = Spans()
        d = manifest.path_driver(cell.mix["path"]).Driver(cell, seed, dev,
                                                          spans)
        d.window(a.seconds, spans)
        d.release()
        extra = ["control"] + [f for f in a.faults.split(",") if f]
        for cand in ["program"] + (extra if seed in ctl_seeds else []):
            r = {"seed": seed, "candidate": cand, **d.readings(cand)}
            rows.append(r)
            print(json.dumps(r), flush=True)
        del d
        torch.cuda.empty_cache()
    names = [k for k in rows[0] if k not in ("seed", "candidate")]
    summary = {}
    for k in names:
        by = {}
        for r in rows:
            by.setdefault(r["candidate"], []).append(r[k])
        summary[k] = {"program_max": max(by["program"]),
                      "limit": cell.limits.get(k),
                      **{f"{c}_min": min(v) for c, v in by.items()
                         if c != "program"}}
        print(f"{k}: {json.dumps(summary[k])} over "
              f"{ {c: len(v) for c, v in by.items()} }", flush=True)
    if a.out:
        out = ROOT / a.out
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"rows": rows, "summary": summary},
                                  indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
