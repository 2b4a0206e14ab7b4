"""What the comparison has to fail, at the test size: the control (the
reference one precision step down in the program's place) and the faults
a cell can have, planted in the timed path underneath a whole run (the
look for a card left out). Each has to come out not correct."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, runner
from benchmark.harness.clock import Spans
from conftest import run_cpu


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.full", "tiny.mtl"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_bench_control_is_not_correct(bench_root, cell, seed):
    c = manifest.find_cell(manifest.load_manifest(bench_root), cell,
                           bench_root)
    spans = Spans()
    d = manifest.path_driver(c.mix["path"]).Driver(c, seed,
                                                   torch.device("cpu"), spans)
    d.window(0.05, spans)
    d.release()
    ok, checks = runner.judge(d.readings("control"), c.limits)
    assert not ok, checks


def _detect_fault(kind):
    from tpudf_torch.entry import DetectCore
    real = DetectCore.forward
    last = {}

    def forward(self, pixels):
        if kind == "half":            # the second half left out
            h = pixels.shape[0] // 2
            out = real(self, pixels[:h])
            return {k: torch.cat([v, v[:pixels.shape[0] - h]])
                    for k, v in out.items()}
        out = real(self, pixels)
        if kind == "altered":         # an answer altered where produced
            out["z_sig"] = out["z_sig"].clone()
            out["z_sig"][0] += 1.0
        if kind == "stale":           # the last batch's answers again
            prev, last["out"] = last.get("out"), out
            return prev or out
        return out
    return DetectCore, "forward", forward


def _request_fault(kind):
    from tpudf_torch.serve.engine import DetectEngine
    real = DetectEngine.predict_batch

    def predict_batch(self, px):
        if kind == "half":
            h = px.shape[0] // 2
            out = real(self, px[:h])
            return {k: np.concatenate([v, v[:px.shape[0] - h]])
                    for k, v in out.items()}
        out = real(self, px)
        out["p_blend"] = out["p_blend"].copy()
        out["p_blend"][0] += 0.1
        return out
    return DetectEngine, "predict_batch", predict_batch


def _mtl_fault(kind):
    import tpudf_torch.entry as entry
    real = entry.build_mtl_trainer

    def build(*a, **kw):
        state, step, ev = real(*a, **kw)

        calls = []

        def faulty(state, batch, gen, cls_w, seg_w):
            calls.append(1)
            if kind == "half":        # the mean over the first half only
                h = batch["cls"].shape[0] // 2
                return step(state, {k: v[:h] for k, v in batch.items()},
                            gen, cls_w, seg_w)
            if kind == "unchanged" or (kind == "stale_window"
                                       and len(calls) > 3):
                # the state handed back unchanged (from the window's
                # first step on: set-up ran three)
                keep = [(t, t.detach().clone()) for t in
                        _tensors(state.params)]
                _, m = step(state, batch, gen, cls_w, seg_w)
                with torch.no_grad():
                    for t, v in keep:
                        t.copy_(v)
                return state, m
            new, m = step(state, batch, gen, cls_w, seg_w)
            if kind == "frozen":      # a frozen entry moved
                with torch.no_grad():
                    new.params["backbone"]["blocks"]["ln1"]["scale"][0, 0] \
                        += 1e-3
                return new, m
            if kind == "stale_window":
                return new, m
            return new, dict(m, loss=m["loss"] * 1.05)     # altered
        return state, faulty, ev
    return entry, "build_mtl_trainer", build


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("cell,fault,kind", [
    ("tiny.detect", _detect_fault, "altered"),
    ("tiny.detect", _detect_fault, "half"),
    ("tiny.detect", _detect_fault, "stale"),
    ("tiny.full", _request_fault, "altered"),
    ("tiny.full", _request_fault, "half"),
    ("tiny.mtl", _mtl_fault, "unchanged"),
    ("tiny.mtl", _mtl_fault, "half"),
    ("tiny.mtl", _mtl_fault, "altered"),
    ("tiny.mtl", _mtl_fault, "frozen"),
    ("tiny.mtl", _mtl_fault, "stale_window")])
def test_bench_planted_fault_is_not_correct(bench_root, monkeypatch, cell,
                                            fault, kind):
    assert run_cpu(bench_root, cell, seed=31)["correct"]
    monkeypatch.setattr(*fault(kind))
    out = run_cpu(bench_root, cell, seed=31)
    assert not out["correct"], out["checks"]
