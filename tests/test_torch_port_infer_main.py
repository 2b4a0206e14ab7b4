"""Parity of the port's inference CLI's `main` with the JAX package's, on
the CPU: `tpudf_torch.cli.infer.main` and `tpudf.cli.infer.main` with
`build_engine` patched to one engine (test-32, MoE fallback, F32 on both
sides; the port's converted from JAX's by `convert.engine_from_numpy`), on
a folder of 16 seeded PNG + JPEG images.

Tolerances:
  JSONL        every report under tests/test_torch_port_report.py's rules
               (the float engine's); "inverted" and "path" equal
  support CSV  equal
  summary      floats atol 1e-4, counts and strings equal (F32 engines on
               both sides: the core's floats agree to ~1e-5, so no
               probability crosses a threshold)
  --video      the port's own predict_video of the sampler's frames: equal
"""

import csv
import json
import os

import jax
import numpy as np
import pytest

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tests.test_torch_port_infer import _numpy_backbone, folder  # noqa: F401
from tests.test_torch_port_report import _compare
from tpudf.calib import coral as J_coral
from tpudf.cli import infer as J_infer
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models import freq_mlp as J_freq
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.serve.engine import DetectEngine as JEngine
from tpudf_torch.cli import infer as T_infer
from tpudf_torch.convert import engine_from_numpy
from tpudf_torch.core.precision import F32_POLICY


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, the port's engine converted from it): test-32, MoE
    fallback, F32 on both sides."""
    jcfg = J_CONFIGS["test-32"]
    tree = {"backbone": _numpy_backbone("test-32"),
            "head": numpy_params(lambda: j_init_head(jax.random.key(1), 64),
                                 1),
            "freq": numpy_params(lambda: J_freq.init_freq_mlp(
                jax.random.key(2)), 2),
            "fusion": None}
    jeng = JEngine(cfg=jcfg, cuts=J_coral.CoralCutpoints.default(),
                   policy=J_F32, **tree)
    return jeng, engine_from_numpy(jeng, "cpu", F32_POLICY)


def _summary(text):
    """The summary JSON main prints last."""
    return json.loads(text[text.index("\n{") + 1:])


def _close(path, got, want, errors):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(f"{path}.{k}", got[k], want[k], errors)
    elif isinstance(want, float) and not isinstance(got, bool):
        if not (abs(got - want) <= 1e-4 or (np.isnan(got)
                                             and np.isnan(want))):
            errors.append(f"{path}: {got} != {want}")
    elif got != want:
        errors.append(f"{path}: {got!r} != {want!r}")


def test_main_matches_jax(folder, engines, tmp_path, monkeypatch, capsys):
    """--fast --labels_from_dirs --invert_logits --calibrate --few_shot
    prototype --support_csv on 16 PNG + JPEG images: JSONL, support CSV and
    summary as JAX's. A second run of the port's loads that support CSV,
    from a CSV input (path, label; reversed order) in chunks of 8, with the
    kernel probe: its rows in the CSV's order, labels from the column."""
    jeng, eng = engines
    monkeypatch.setattr(J_infer, "build_engine", lambda args, calib=None:
                        jeng)
    monkeypatch.setattr(T_infer, "build_engine", lambda args, calib=None:
                        eng)
    val = os.path.join(folder, "val")
    out, text = {}, {}
    for side, mod in (("jax", J_infer), ("port", T_infer)):
        argv = ["--input", val, "--out", str(tmp_path / f"{side}.jsonl"),
                "--model_size", "test-32", "--batch_size", "16", "--fast",
                "--labels_from_dirs", "--invert_logits", "--calibrate",
                "--few_shot", "prototype", "--few_shot_n", "4",
                "--support_csv", str(tmp_path / f"{side}.csv")]
        mod.main(argv + (["--device", "cpu"] if side == "port" else []))
        text[side] = capsys.readouterr().out
        with open(tmp_path / f"{side}.jsonl") as f:
            out[side] = [json.loads(line) for line in f]
    assert len(out["port"]) == len(out["jax"]) == 16
    errors = []
    for i, (g, w) in enumerate(zip(out["port"], out["jax"])):
        assert g["inverted"] is True and g["path"] == w["path"]
        _compare("float", f"img{i}", g, w, errors)
    assert not errors, "\n".join(errors[:20])
    with open(tmp_path / "port.csv") as a, open(tmp_path / "jax.csv") as b:
        rows = a.read()
        assert rows == b.read()
    assert rows.splitlines()[0] == "path,label" and len(
        rows.splitlines()) == 9
    got, want = _summary(text["port"]), _summary(text["jax"])
    assert set(got) == {"metrics", "auc_ci", "calibrated", "few_shot"}
    _close("summary", got, want, errors)
    assert not errors, "\n".join(errors)

    paths = [r["path"] for r in out["port"]][::-1]
    with open(tmp_path / "in.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "label"])
        for p in paths:
            w.writerow([p, int("FAKE" in p)])
    T_infer.main(["--input", str(tmp_path / "in.csv"), "--out",
                  str(tmp_path / "again.jsonl"), "--model_size", "test-32",
                  "--batch_size", "8", "--fast", "--few_shot", "kernel",
                  "--support_csv", str(tmp_path / "port.csv"),
                  "--device", "cpu"])
    again = capsys.readouterr().out
    assert "[few-shot] loaded support set: 8 examples" in again
    with open(tmp_path / "again.jsonl") as f:
        reps = [json.loads(line) for line in f]
    assert [r["path"] for r in reps] == paths
    by_path = {r["path"]: r for r in out["port"]}
    assert all(r["final_prob"] == by_path[r["path"]]["final_prob"]
               for r in reps)
    summary = _summary(again)
    assert summary["metrics"] == got["metrics"]
    assert summary["few_shot"]["method"] == "kernel"
    assert summary["few_shot"]["n_support"] == 8


def test_main_video_matches_predict_video(engines, tmp_path, monkeypatch):
    """--video on a folder with one cv2-written clip: the JSONL report is
    the port's predict_video of the sampler's frames."""
    cv2 = pytest.importorskip("cv2")
    from tpudf_torch.data.video import sample_video
    _, eng = engines
    monkeypatch.setattr(T_infer, "build_engine", lambda args, calib=None:
                        eng)
    seen = []

    def predict_video(engine, frames):
        seen.append((engine, frames, T_infer.predict_video.__wrapped__(
            engine, frames)))
        return dict(seen[-1][2])

    predict_video.__wrapped__ = T_infer.predict_video
    monkeypatch.setattr(T_infer, "predict_video", predict_video)
    os.makedirs(tmp_path / "clips")
    clip = str(tmp_path / "clips" / "a.mp4")
    w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (32, 32, 3), np.uint8)
    for i in range(6):
        w.write(np.roll(base, 2 * i, axis=1))
    w.release()
    T_infer.main(["--input", str(tmp_path / "clips"), "--out",
                  str(tmp_path / "v.jsonl"), "--model_size", "test-32",
                  "--video", "--device", "cpu"])
    with open(tmp_path / "v.jsonl") as f:
        reps = [json.loads(line) for line in f]
    assert len(reps) == 1 and reps[0].pop("path") == clip
    (engine, frames, want), = seen
    assert engine is eng
    np.testing.assert_array_equal(frames, sample_video(clip, size=32)[0])
    assert reps[0] == json.loads(json.dumps(want))
