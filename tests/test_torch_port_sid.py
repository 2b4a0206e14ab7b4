"""The port's SID_Set route against the JAX package's, on the CPU, with no
network: a stand-in `datasets` module in `sys.modules` serves seeded
in-memory records, so neither package reaches the real
`datasets.load_dataset`.

  sid_example_to_arrays  every schema variant of a record (labels int
        0 / 1 / 2 and the strings real, fully_synthetic, tampered,
        full_synthetic, synthetic, any case; images PIL in RGB / RGBA / L,
        {"bytes"} of a PNG and of a JPEG, {"path"}, a uint8 array; masks
        3-channel 0-255, 1-channel, all zero, float 0-1, bool, PIL, an
        undecodable dict, none): pixels and masks bit-equal, cls, binary
        and has_mask equal
  sid_label_to_index     the spelling-variant warning printed once a
        variant, the same lines as JAX's
  load_sid_set           the same name, split spec and streaming flag
        handed to load_dataset ("train", "train[:10%]")
  cli/train_mtl.main     without --data_dir (test-32, 32 px, one epoch):
        it trains, writes what the --data_dir route writes, and reads
        exactly the records JAX's `materialize` reads at subset_train 0.25
        and 1.0 (JAX's main run up to its optimizer, its tree init
        stubbed); a stand-in that raises exits with "provide --data_dir"
"""

import csv
import io
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.data import datasets as J_ds
from tpudf_torch.data import datasets as T_ds

SIZE = 32


def _rgb(rng, h=48, w=40):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _image(kind, rng, tmp_path, i):
    a = _rgb(rng)
    if kind == "pil":
        return Image.fromarray(a)
    if kind == "pil_rgba":
        return Image.fromarray(np.dstack([a, a[..., :1]]), "RGBA")
    if kind == "pil_l":
        return Image.fromarray(a[..., 0])
    if kind in ("png_bytes", "jpeg_bytes"):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "PNG" if kind == "png_bytes" else "JPEG")
        return {"bytes": buf.getvalue()}
    if kind == "path":
        p = os.path.join(tmp_path, f"img{i}.png")
        Image.fromarray(a).save(p)
        return {"bytes": None, "path": p}
    return a                                       # "array"


def _mask(kind, rng):
    m = np.zeros((48, 40), np.uint8)
    y, x = rng.integers(0, 24, 2)
    m[y:y + 20, x:x + 16] = rng.integers(128, 256)
    m[0, :8] = 127                                 # at the threshold: 0
    if kind == "rgb255":
        return np.dstack([m, 255 - m, m])
    if kind == "gray255":
        return m
    if kind == "zeros":
        return np.zeros((48, 40), np.uint8)
    if kind == "float01":
        return (m > 127).astype(np.float32) * rng.uniform(0.6, 1.0)
    if kind == "bool":
        return m > 127
    if kind == "pil":
        return Image.fromarray(m)
    if kind == "undecodable":
        return {"bytes": None, "path": None}
    return None                                    # "none"


# (image encoding, mask encoding, label): every variant at least once
CASES = [
    ("pil", "none", 0), ("pil_rgba", "rgb255", 2), ("pil_l", "gray255", 2),
    ("png_bytes", "float01", "tampered"), ("jpeg_bytes", "bool", 1),
    ("path", "pil", "fully_synthetic"), ("array", "undecodable", "real"),
    ("array", "zeros", 2), ("pil", "rgb255", "Full_Synthetic"),
    ("png_bytes", "none", " synthetic "), ("path", "gray255", "spliced"),
    ("jpeg_bytes", "float01", "REAL"),
]


def _record(case, tmp_path, i):
    rng = np.random.default_rng(100 + i)
    img_kind, mask_kind, label = case
    ex = {"image": _image(img_kind, rng, tmp_path, i), "label": label}
    mask = _mask(mask_kind, rng)
    if mask is not None:
        ex["mask"] = mask
    return ex


@pytest.fixture
def fresh_variants(monkeypatch):
    """Both packages' once-per-variant warning sets, empty."""
    monkeypatch.setattr(J_ds, "_SID_VARIANTS_SEEN", set())
    monkeypatch.setattr(T_ds, "_SID_VARIANTS_SEEN", set())


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)).replace(" ", "")
                              for c in CASES])
def test_sid_example_matches_jax(i, tmp_path, fresh_variants):
    ex = _record(CASES[i], str(tmp_path), i)
    want = J_ds.sid_example_to_arrays(ex, SIZE)
    got = T_ds.sid_example_to_arrays(ex, SIZE)
    assert got.keys() == want.keys()
    for k in ("cls", "binary", "has_mask"):
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    for k in ("pixels", "mask"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    mask_kind = CASES[i][1]
    assert got["has_mask"] == (mask_kind not in ("none", "undecodable"))
    if mask_kind not in ("none", "undecodable", "zeros"):
        assert 0 < got["mask"].sum() < SIZE * SIZE


def test_label_variant_warns_once_as_jax(capsys, fresh_variants):
    labels = [0, "real", "full_synthetic", "Full_Synthetic", "synthetic",
              " SYNTHETIC", "fully_synthetic", "tampered", "spliced", 2]
    want = [J_ds.sid_label_to_index(v) for v in labels]
    out_j = capsys.readouterr().out
    got = [T_ds.sid_label_to_index(v) for v in labels]
    out_t = capsys.readouterr().out
    assert got == want == [0, 0, 1, 1, 1, 1, 1, 2, 2, 2]
    assert out_t == out_j
    assert out_t.count("[sid][warn]") == 2       # full_synthetic, synthetic
    assert T_ds.SID_LABELS == J_ds.SID_LABELS


def _stand_in(calls, records=None, fail=None):
    """A `datasets` module whose load_dataset records its arguments and
    serves `records[split]` (a Split that counts its item reads), or
    raises `fail`."""
    mod = types.ModuleType("datasets")

    def load_dataset(name, split=None, streaming=False):
        calls.append((name, split, streaming))
        if fail is not None:
            raise fail
        return records[split.split("[")[0]]

    mod.load_dataset = load_dataset
    return mod


class Split:
    def __init__(self, rows):
        self.rows, self.reads = rows, []

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        self.reads.append(i)
        return self.rows[i]


@pytest.mark.parametrize("subset", [None, ":10%"])
def test_load_sid_set_hands_jax_spec(monkeypatch, subset):
    calls = []
    monkeypatch.setitem(sys.modules, "datasets",
                        _stand_in(calls, {"train": "rows"}))
    for mod in (J_ds, T_ds):
        assert mod.load_sid_set("train", subset) == "rows"
        assert mod.load_sid_set("train", subset, streaming=True) == "rows"
    assert calls[:2] == calls[2:]
    spec = "train" if subset is None else "train[:10%]"
    assert calls[:2] == [("saberzl/SID_Set", spec, False),
                         ("saberzl/SID_Set", spec, True)]


N_TRAIN, N_VAL, BATCH = 20, 12, 4
CLI = ["--model_size", "test-32", "--image_size", "32", "--seg_layers", "0",
       "-1", "--embed_dim", "16", "--freeze_below", "1", "--epochs", "1",
       "--batch_size", str(BATCH)]


def _sid_records(tmp_path):
    """Seeded SID_Set-like splits over the schema variants (CASES)."""
    return {split: [_record(CASES[i % len(CASES)], str(tmp_path), i + off)
                    for i in range(n)]
            for split, n, off in (("train", N_TRAIN, 0),
                                  ("validation", N_VAL, 50))}


def _jax_reads(monkeypatch, records, subset):
    """The records JAX's CLI reads: its main run up to its optimizer, the
    tree init stubbed (the data route does not read the tree)."""
    import tpudf.cli.train_mtl as J_cli
    import tpudf.models.segformer as J_seg
    import tpudf.train.steps as J_steps

    class Reached(Exception):
        pass

    def stop(*a, **k):
        raise Reached

    calls = []
    splits = {k: Split(v) for k, v in records.items()}
    monkeypatch.setitem(sys.modules, "datasets", _stand_in(calls, splits))
    monkeypatch.setattr(J_seg, "init_mtl", lambda *a, **k: None)
    monkeypatch.setattr(J_steps, "make_optimizer", stop)
    with pytest.raises(Reached):
        J_cli.main(CLI + ["--subset_train", str(subset)])
    return calls, {k: s.reads for k, s in splits.items()}


@pytest.mark.parametrize("subset", [0.25, 1.0])
def test_cli_trains_on_sid_set_reads_as_jax(monkeypatch, tmp_path, subset,
                                            fresh_variants):
    from tpudf_torch.cli.train_mtl import main
    from tpudf_torch.train.checkpoint import load_metrics, restore_checkpoint
    records = _sid_records(tmp_path)
    want_calls, want_reads = _jax_reads(monkeypatch, records, subset)
    calls = []
    splits = {k: Split(v) for k, v in records.items()}
    monkeypatch.setitem(sys.modules, "datasets", _stand_in(calls, splits))
    save = tmp_path / "run"
    main(CLI + ["--subset_train", str(subset), "--save_dir", str(save),
                "--device", "cpu"])
    assert calls == want_calls == [("saberzl/SID_Set", "train", False),
                                   ("saberzl/SID_Set", "validation", False)]
    reads = {k: s.reads for k, s in splits.items()}
    assert reads == want_reads
    take = {0.25: (5, 6), 1.0: (N_TRAIN, N_VAL)}[subset]
    assert [len(reads["train"]), len(reads["validation"])] == list(take)
    # what the --data_dir route writes (test_torch_port_train's CLI test)
    assert sorted(os.listdir(save)) == ["best", "best.metrics.json",
                                        "training_log.csv"]
    rows = list(csv.DictReader(open(save / "training_log.csv")))
    assert len(rows) == 1 and "val_dice" in rows[0]
    assert np.isfinite(float(rows[0]["train_loss"]))
    state = restore_checkpoint(str(save / "best"))
    assert state["step"] == take[0] // BATCH and state["epoch"] == 0
    assert load_metrics(str(save / "best"))["epoch"] == 0


def test_cli_exits_when_sid_set_is_unavailable(monkeypatch):
    from tpudf_torch.cli.train_mtl import main
    calls = []
    monkeypatch.setitem(sys.modules, "datasets", _stand_in(
        calls, fail=ConnectionError("offline")))
    with pytest.raises(SystemExit, match=r"SID_Set unavailable \(offline\); "
                       r"provide --data_dir"):
        main(CLI + ["--device", "cpu"])
    assert calls == [("saberzl/SID_Set", "train", False)]
