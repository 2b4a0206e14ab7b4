"""The benchmark's CPU tests: a checkout of its own in a temporary
folder (BENCHMARK.json and this folder's files, with cells at test sizes
from `data/`), driven without a card. The program runs its plain twins on
CPU tensors."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEST_CELLS = {
    # cell: (configuration in data/, traffic, {traffic overrides}); its
    # limits are data/limits/<cell>.json, set at this size by the rule of
    # the real cells' (the widest sound reading, the control's least)
    "tiny.detect": ("tiny", "detect_b8192",
                    {"batch": 32, "pool_batches": 2, "calib_images": 4,
                     "check_batches": 2}),
    "tiny.mtl": ("tiny", "mtl384_b16",
                 {"batch": 4, "image_size": 64, "pool_batches": 4,
                  "freeze_below": 1, "taps": [0, -1], "embed_dim": 16}),
    "tiny.full": ("tiny", "full8",
                  {"request_images": 2, "pool_images": 6,
                   "check_requests": 2}),
}


def make_root(tmp: Path, cells=TEST_CELLS) -> Path:
    """A checkout at tmp: the benchmark folder, the test configurations,
    and a BENCHMARK.json that lists the test cells beside the real ones."""
    shutil.copytree(BENCH, tmp / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (cfg, mix, over) in cells.items():
        dst = tmp / BENCH.name
        shutil.copy(DATA / f"{cfg}.json", dst / "configs" / f"{cfg}.json")
        m = json.loads((dst / "traffic" / f"{mix}.json").read_text())
        (dst / "traffic" / f"{cell}.json").write_text(
            json.dumps(dict(m, **over)))
        shutil.copy(DATA / "limits" / f"{cell}.json",
                    dst / "limits" / f"{cell}.json")
        if cfg not in {c["name"] for c in man["configs"]}:
            man["configs"].append({"name": cfg, "source": "test",
                                   "file": f"benchmark/configs/{cfg}.json",
                                   "reduced": [], "why": "test"})
        man["workloads"].append({"name": cell, "config": cfg,
                                 "traffic": cell, "chips": 1, "why": "t"})
        twin = [w["name"] for w in man["workloads"] if w["traffic"] == mix]
        for m in man["end_to_end"] + man["per_layer"]:
            if any(t in m.get("workloads", ()) for t in twin):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return tmp


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """Tiny ops on torch's CPU pool are far slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cpu(root: Path, cell: str, seed: int = 3, seconds: float = 0.2,
            trace: bool = False) -> dict:
    """runner.run on the CPU (the check for a card left out)."""
    import time

    from benchmark.harness import runner
    return runner.run(cell, seed, seconds, trace, time.time(),
                      device=torch.device("cpu"), root=root)
