"""A configuration, a traffic mix and a per-layer metric are added as
new files plus new BENCHMARK.json entries, with no edit to a file that is
there; the loader finds each by its name."""

import json

import pytest

from benchmark.harness import manifest
from conftest import run_cpu


def test_bench_every_cell_of_the_manifest_loads():
    man = manifest.load_manifest(manifest.ROOT)
    for w in man["workloads"]:
        cell = manifest.find_cell(man, w["name"], manifest.ROOT)
        assert cell.chips == w["chips"] == 1
        manifest.path_driver(cell.mix["path"])
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in man["per_layer"]:
        assert callable(manifest.metric_reader(m["name"], manifest.ROOT))


def test_bench_added_files_make_a_cell(bench_root, tmp_path):
    """New files only: a configuration, a mix (data for a driver that is
    there), the cell's limits and a metric reader; then entries."""
    import shutil
    root = tmp_path
    shutil.copytree(bench_root / "benchmark", root / "benchmark")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tiny.json").read_text())
    (b / "configs" / "tiny2.json").write_text(json.dumps(
        dict(cfg, name="tiny2")))
    (b / "traffic" / "detect_b2.json").write_text(json.dumps(
        {"path": "detect", "batch": 2, "pool_batches": 2,
         "calib_images": 2, "check_batches": 1}))
    (b / "limits" / "tiny2.detect_b2.json").write_text(json.dumps(
        {"z_sig": 0.1, "z_freq": 0.01, "p_blend": 0.02,
         "risk_probs": 0.02}))
    (b / "metrics" / "images.detect.py").write_text(
        "def read(rec):\n    return rec.window.work['images']\n")
    man = json.loads((bench_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny2", "source": "test",
                           "file": "benchmark/configs/tiny2.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny2.detect_b2", "config": "tiny2",
                             "traffic": "detect_b2", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "detect_img_per_s":
            m["workloads"].append("tiny2.detect_b2")
    man["per_layer"].append({"name": "images.detect", "unit": "img",
                             "better": "higher", "source": "host_clock",
                             "layer": "model step",
                             "moves": "detect_img_per_s",
                             "workloads": ["tiny2.detect_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p: p.read_bytes() for p in before}
    assert after == before                  # nothing there was edited
    cell = manifest.find_cell(manifest.load_manifest(root),
                              "tiny2.detect_b2", root)
    assert cell.config["name"] == "tiny2" and cell.mix["batch"] == 2
    out = run_cpu(root, "tiny2.detect_b2", trace=True)
    assert out["metrics"]["images.detect"]["value"] == out["attempted"]
    out = run_cpu(root, "tiny2.detect_b2")
    assert set(out["metrics"]) == {"detect_img_per_s", "setup_s"}


def test_bench_unknown_workload_raises():
    with pytest.raises(KeyError):
        manifest.find_cell(manifest.load_manifest(manifest.ROOT), "nope",
                           manifest.ROOT)
