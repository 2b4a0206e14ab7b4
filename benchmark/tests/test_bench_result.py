"""The result's last line: its keys and their order, the checks last;
and no result without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, run_cpu


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.full", "tiny.mtl"])
def test_bench_result_keys(bench_root, cell):
    out = run_cpu(bench_root, cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.full", "tiny.mtl"])
def test_bench_traced_result_holds_per_layer_metrics(bench_root, cell):
    out = run_cpu(bench_root, cell, trace=True)
    assert "setup_s" not in out["metrics"]
    assert out["metrics"]["setup.build_s"]["value"] > 0
    mfu = [k for k in out["metrics"] if k.startswith("mfu.")]
    assert len(mfu) == 1 and 0 < out["metrics"][mfu[0]]["value"] < 100


def test_bench_no_card_no_result():
    """run.py on a machine without a CUDA card: a code other than 0 and
    nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "base-256.detect_b8192", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
