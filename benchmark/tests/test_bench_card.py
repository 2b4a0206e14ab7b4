"""On the card only (marked gpu; each skips inside its body without
one): a short run of every cell through run.py, correct and with its
metrics, and the control at each cell's own size on three seeds, not
correct. Run on the card with
`python -m pytest -m gpu benchmark/tests/test_bench_card.py`."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest
from conftest import ROOT

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_runs_on_the_card(cell):
    _card()
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", cell, "--seed", "977", "--seconds",
                        "3", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_fails_on_the_card(cell):
    _card()
    import torch

    from benchmark.harness import runner
    from benchmark.harness.clock import Spans
    c = manifest.find_cell(manifest.load_manifest(ROOT), cell, ROOT)
    for seed in (1, 2, 3):
        spans = Spans()
        d = manifest.path_driver(c.mix["path"]).Driver(
            c, seed, torch.device("cuda", 0), spans)
        d.window(1.0, spans)
        d.release()
        ok, checks = runner.judge(d.readings("control"), c.limits)
        assert not ok, checks
