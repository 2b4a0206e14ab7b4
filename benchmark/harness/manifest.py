"""The manifest (BENCHMARK.json) and the files it names.

A cell names a configuration and a traffic mix; each is a file of its own:
`configs/<config>.json` (through the manifest's `file`),
`traffic/<mix>.json`, whose `path` names the driver under `paths/`, and
`limits/<cell>.json`, the limits of the numbers that decide `correct`.
A per-layer metric is `metrics/<metric>.py`, whose `read(record)` returns
its value or None. A later cell, mix or metric is new files plus new
manifest entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict          # the configuration file as run
    mix: dict             # the traffic file
    limits: dict          # {number: limit}
    end_to_end: tuple     # the manifest's end_to_end entries of this cell
    per_layer: tuple      # the manifest's per_layer entries of this cell


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of the manifest with its files read; raises
    KeyError for a name the manifest does not hold."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / BENCH.name
    return Cell(
        name=workload, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=_read_json(root / cfg["file"]),
        mix=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench / "limits" / f"{workload}.json"),
        end_to_end=tuple(m for m in manifest["end_to_end"]
                         if _in_cell(m, workload)),
        per_layer=tuple(m for m in manifest["per_layer"]
                        if _in_cell(m, workload)))


def path_driver(name: str):
    """The driver module `paths/<name>.py` that a traffic file names."""
    return importlib.import_module(f"benchmark.paths.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """`read(record)` of `metrics/<name>.py` (a name may hold dots, so the
    file is loaded by its path)."""
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
