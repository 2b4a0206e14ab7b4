"""Batch inference CLI on PyTorch (tpudf/cli/infer.py): images or videos →
JSON reports.

Loads the expert stack onto the device (the card unless `--device cpu`),
runs the batched engine over a folder or CSV of media through the image
report (`serve.report.predict_images`) or, with `--video`, the frame
sampler and the video report, and writes one JSON line a file, then the
metrics against the labels (CSV column or `--labels_from_dirs`), a
calibrated split (`--calibrate`) and few-shot probes over the tower's
features (`--few_shot`).

Usage:
  python -m tpudf_torch.cli.infer --input /path/imgs --out reports.jsonl \\
      [--device cuda] [--artifacts /path/siglip] [--labels_from_dirs] \\
      [--int8 --tome_r --patch_tome] [--video]

`--head_ckpt` reads a checkpoint of `python -m tpudf_torch.cli.train_binary`
(torch.save); the JAX package's orbax checkpoints are not read.
`--backbone_ckpt` reads an HF SiglipVisionModel state dict (`.safetensors`,
or a torch `.pt` of {name: tensor}).
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from tpudf_torch.calib.coral import CoralCutpoints, fit_temperature
from tpudf_torch.core.precision import DEFAULT_POLICY, tree_map
from tpudf_torch.data.datasets import IMG_EXTS, VIDEO_EXTS, _decode_image
from tpudf_torch.data.prefetch import prefetch
from tpudf_torch.data.video import sample_video
from tpudf_torch.entry import load_backbone
from tpudf_torch.eval.metrics import binary_metrics
from tpudf_torch.eval.stats import (apply_isotonic, bootstrap_ci,
                                    expected_calibration_error, isotonic_fit)
from tpudf_torch.fuse.bayesian import BayesCalibration
from tpudf_torch.models.freq_mlp import freq_mlp_from_safetensors, init_freq_mlp
from tpudf_torch.models.fusion import (TreeEnsemble,
                                       fusion_linear_from_safetensors,
                                       init_fusion_linear)
from tpudf_torch.models.heads import init_binary_head
from tpudf_torch.models.siglip import CONFIGS, init_siglip
from tpudf_torch.ops.tome import (CONSERVATIVE_TOME_R, DEPLOYED_PATCH_TOME_R,
                                  DEPLOYED_TOME_R, deployed_floor,
                                  deployed_patch_floor)
from tpudf_torch.serve.adapt import (kernel_probe_predict,
                                     linear_probe_predict, prototype_classify,
                                     train_kernel_probe, train_linear_probe)
from tpudf_torch.serve.engine import DetectEngine
from tpudf_torch.serve.report import predict_images, predict_video
from tpudf_torch.train.checkpoint import restore_train_state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpudf_torch batch inference")
    p.add_argument("--input", required=True,
                   help="folder of images/videos, or a CSV with columns "
                        "path[,label] (inference_ai_human_images.py-style "
                        "metadata input)")
    p.add_argument("--out", default="reports.jsonl")
    p.add_argument("--model_size", default="base-256")
    p.add_argument("--backbone_ckpt", default=None,
                   help="HF SiglipVisionModel state dict (.safetensors or a "
                        "torch .pt of {name: tensor})")
    p.add_argument("--artifacts", default=None,
                   help="dir with freq_mlp/fusion_head safetensors + coral "
                        "jsons (reference artifact layout)")
    p.add_argument("--head_ckpt", default=None,
                   help="checkpoint from tpudf_torch.cli.train_binary "
                        "(loads the trained v5 head; EMA params if present)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--video", action="store_true")
    p.add_argument("--labels_from_dirs", action="store_true",
                   help="REAL/FAKE parent dirs → compute metrics")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="deploy the calibrated W8A8 tower (engine.quantize)")
    p.add_argument("--tome_r", type=int, default=None, const=-1, nargs="?",
                   help="ToMe token merging (ops/tome.py): merge r token "
                        "pairs between tower blocks (deployed "
                        f"r={DEPLOYED_TOME_R}; conservative "
                        f"r={CONSERVATIVE_TOME_R}). Bare --tome_r uses the "
                        "deployed schedule (incl. its S/8 token floor); an "
                        "explicit r keeps the S/4 floor unless --tome_floor "
                        "is given.")
    p.add_argument("--patch_tome", action="store_true",
                   help="deeper ToMe schedule on the 32 patch-grid views "
                        "of the full-analysis path (main path untouched)")
    p.add_argument("--tome_floor", type=int, default=0,
                   help="minimum token count the ToMe schedule may merge "
                        "down to (0 = S/4 default; the deployed schedule "
                        "uses S/8)")
    p.add_argument("--random_fusion", action="store_true",
                   help="random-init the 2->1 fusion head when no artifact "
                        "exists instead of the reference's MoE fallback "
                        "(smoke/parity testing)")
    p.add_argument("--invert_logits", action="store_true",
                   help="negate the visual head's output logits before any "
                        "fusion/decision math, repairing a head trained "
                        "with y=1 for REAL (inference_ai_human_images.py"
                        ":728 INVERT_LOGITS)")
    p.add_argument("--few_shot", default="none",
                   choices=["none", "prototype", "linear", "kernel"],
                   help="few-shot adaptation over frozen SigLIP features "
                        "(inference_deepfakeface_complete.py:835-1013, "
                        "inference_ai_human_images.py:436-543); requires "
                        "labels (CSV label column or --labels_from_dirs)")
    p.add_argument("--few_shot_n", type=int, default=100,
                   help="support examples per class (reference "
                        "FEW_SHOT_N_SHOT=100)")
    p.add_argument("--support_csv", default=None,
                   help="support-set CSV (path,label). Loaded if it exists; "
                        "otherwise the sampled support set is saved there "
                        "(reference save_support_set/load_support_set "
                        ":544-555)")
    p.add_argument("--calibrate", action="store_true",
                   help="fit isotonic calibration + temperature on a held "
                        "split of the labeled inputs and report calibrated "
                        "metrics (inference_deepfakeface_complete.py"
                        ":383-478)")
    p.add_argument("--calibration_split", type=float, default=0.2)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    return p.parse_args(argv)


def _same_tree(a, b) -> bool:
    """True when two parameter trees have the same keys and tensor shapes."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape
    return True


def restore_head(path, template):
    """The v5 head of a `tpudf_torch.cli.train_binary` checkpoint (its EMA
    when it kept one, else its params), on the CPU; SystemExit when the
    file holds no train state or its head is not shaped as `template`."""
    try:
        restored = restore_train_state(path)
    except ValueError as e:
        raise SystemExit(f"cannot restore head from {path}: {e}")
    got = restored["ema"] if restored["ema"] is not None \
        else restored["params"]
    if not _same_tree(template, got):
        raise SystemExit(f"cannot restore head from {path}: not a v5 head "
                         "of this model size")
    print(f"[head] restored {path}")
    return got


def build_engine(args, calib_uint8=None):
    """The serving engine the flags describe, on `args.device` (the card
    by default): the tower (random from --seed, or --backbone_ckpt), the
    v5 head (random from --seed + 1, or --head_ckpt's EMA or params), the
    artifacts of --artifacts (each random or default where absent; no
    fusion head → the MoE fallback), the ToMe schedules, and --int8's W8A8
    tower calibrated on `calib_uint8` (uint8 (N, S, S, 3) images)."""
    device = torch.device(getattr(args, "device", "cuda"))
    seed = args.seed
    cfg = CONFIGS[args.model_size]
    if args.backbone_ckpt:
        backbone = load_backbone(args.backbone_ckpt, cfg)
    else:
        print("[warn] random backbone (smoke mode)")
        # the seeds of cli/train_binary, so a head trained in smoke mode
        # pairs with the identical random backbone
        backbone = init_siglip(torch.Generator().manual_seed(seed), cfg)
    head = init_binary_head(torch.Generator().manual_seed(seed + 1),
                            cfg.width)
    if getattr(args, "head_ckpt", None):
        head = restore_head(args.head_ckpt, head)
    if getattr(args, "invert_logits", False):
        # negate the head's output layer: sigmoid(-z) = 1 - sigmoid(z), so
        # the whole expert stack (fusion, cascade, verdict, report) sees the
        # corrected orientation (inference_ai_human_images.py:728)
        head = dict(head) | {"fc3": {"w": -head["fc3"]["w"],
                                     "b": -head["fc3"]["b"]}}
        print("[head] logits inverted (y=1-was-REAL repair)")

    art = args.artifacts
    path = lambda name: os.path.join(art, name) if art else None
    has = lambda name: bool(art) and os.path.exists(path(name))
    if has("freq_mlp.safetensors"):
        freq = freq_mlp_from_safetensors(path("freq_mlp.safetensors"))
    else:
        freq = init_freq_mlp(torch.Generator().manual_seed(seed + 2))
    if has("fusion_head.safetensors"):
        fusion = fusion_linear_from_safetensors(path("fusion_head.safetensors"))
    elif getattr(args, "random_fusion", False):
        fusion = init_fusion_linear(torch.Generator().manual_seed(seed + 3))
    else:
        # reference parity: missing fusion-head artifact → probability-space
        # MoE fallback blend (deepfake-detector-v2/app.py:534, :1380-1390)
        print("[fusion] fusion head missing → MoE fallback")
        fusion = None
    if has("coral_cutpoints.json"):
        cuts = CoralCutpoints.from_json(
            path("coral_cutpoints.json"),
            path("coral_temp.json") if has("coral_temp.json") else None)
    else:
        cuts = CoralCutpoints.default()
    bayes_cal = None
    if has("bayes_calibration.json"):
        with open(path("bayes_calibration.json")) as f:
            bayes_cal = BayesCalibration.from_json(json.load(f))
    gbdt = None
    if has("xgb_fusion.json"):
        # v6 booster override (appv3.py:5576-5578): the 19-feature tree
        # ensemble overrides the fusion probability in full reports
        gbdt = TreeEnsemble.from_xgboost_json(
            path("xgb_fusion.json"),
            path("platt.json") if has("platt.json") else None)
        print("[fusion] xgb_fusion.json booster attached "
              f"(platt={'yes' if has('platt.json') else 'no'})")
    tome_r = getattr(args, "tome_r", None)
    tome_floor = getattr(args, "tome_floor", 0) or 0
    if tome_r is not None and tome_r < 0:
        # bare --tome_r → the deployed schedule (r + floor)
        tome_r = DEPLOYED_TOME_R
        if not tome_floor:
            tome_floor = deployed_floor(cfg.num_patches)
    patch_r = patch_floor = 0
    if getattr(args, "patch_tome", False):
        patch_r = DEPLOYED_PATCH_TOME_R
        patch_floor = deployed_patch_floor(cfg.num_patches)
    on = lambda tree: tree_map(
        lambda t: t.to(device) if torch.is_tensor(t) else t, tree)
    eng = DetectEngine(cfg=cfg, backbone=on(backbone), head=on(head),
                       freq=on(freq), fusion=on(fusion), cuts=cuts,
                       policy=DEFAULT_POLICY, gbdt=gbdt,
                       bayes_calibration=bayes_cal, tome_r=tome_r or 0,
                       tome_floor=tome_floor, patch_tome_r=patch_r,
                       patch_tome_floor=patch_floor)
    if getattr(args, "int8", False):
        # calibrate activation scales on the actual inputs when available
        # (synthetic-noise amax need not bound real-image activations)
        eng.quantize(calib_uint8)
    return eng


def _is_csv(path: str) -> bool:
    return os.path.isfile(path) and path.lower().endswith(".csv")


def _folder_paths(root: str, exts) -> list[str]:
    """The files under root with an extension in `exts` (walk order,
    names sorted in each directory)."""
    return [os.path.join(dp, f) for dp, _, fs in os.walk(root)
            for f in sorted(fs) if f.lower().endswith(exts)]


def _calib_batch(args, size, n=16):
    """First n decodable input images as a quantization-calibration batch."""
    if not getattr(args, "int8", False):
        return None
    paths = []
    if _is_csv(args.input):
        with open(args.input) as f:
            paths = [r["path"] for r in csv.DictReader(f)]
    elif os.path.isdir(args.input):
        paths = _folder_paths(args.input, IMG_EXTS)
    imgs = []
    for p in paths[:n]:
        try:
            imgs.append(_decode_image(p, size))
        except Exception:
            continue
    return np.stack(imgs) if imgs else None


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(
        args, _calib_batch(args, CONFIGS[args.model_size].image_size))
    size = engine.cfg.image_size

    if args.video:
        paths = _folder_paths(args.input, VIDEO_EXTS)
        sampled = prefetch((p, sample_video(p, size=size)) for p in paths)
        with open(args.out, "w") as fo:
            for p, (frames, _) in sampled:
                if frames is None:
                    continue
                rep = predict_video(engine, frames)
                rep["path"] = p
                fo.write(json.dumps(rep) + "\n")
        print(f"[done] {len(paths)} videos → {args.out}")
        return

    csv_labels = {}
    if _is_csv(args.input):
        with open(args.input) as f:
            rows = list(csv.DictReader(f))
        paths = [r["path"] for r in rows]
        for r in rows:
            if "label" in r and r["label"] != "":
                csv_labels[r["path"]] = float(r["label"])
    else:
        paths = _folder_paths(args.input, IMG_EXTS)
    labels, probs, lab_paths = [], [], []
    feats = []       # pooled SigLIP features of LABELED images (few-shot)
    have_labels = bool(csv_labels) or args.labels_from_dirs
    # few-shot adaptation needs labels; without any, skip the extra
    # embedding forward instead of embedding a corpus it can never use
    want_feats = args.few_shot != "none" and have_labels
    if args.few_shot != "none" and not want_feats:
        print("[few-shot] skipped: no labels (need a CSV label column or "
              "--labels_from_dirs)")

    def _label_of(p):
        if p in csv_labels:
            return csv_labels[p]
        if args.labels_from_dirs:
            parent = os.path.basename(os.path.dirname(p)).upper()
            return 1.0 if "FAKE" in parent else 0.0
        return None

    def decoded_chunks():
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(8) as ex:
            for s in range(0, len(paths), args.batch_size):
                chunk = paths[s:s + args.batch_size]
                imgs = list(ex.map(lambda p: _decode_image(p, size), chunk))
                yield chunk, np.stack(imgs)

    with open(args.out, "w") as fo:
        for chunk, px in prefetch(decoded_chunks()):
            reports = predict_images(engine, px, fast=args.fast)
            lab_mask = [_label_of(p) is not None for p in chunk]
            if want_feats and any(lab_mask):
                # embed only the labeled rows — unlabeled features are
                # never consumed by _few_shot_metrics
                feats.append(engine.embed_batch(px[np.asarray(lab_mask)]))
            for p, r in zip(chunk, reports):
                if args.invert_logits:
                    r["inverted"] = True   # orientation fixed at the head
                r["path"] = p
                fo.write(json.dumps(r) + "\n")
                lab = _label_of(p)
                if lab is not None:
                    labels.append(lab)
                    probs.append(r["final_prob"])
                    lab_paths.append(p)
    print(f"[done] {len(paths)} images → {args.out}")
    if labels:
        summary = {}
        m = binary_metrics(labels, probs)
        summary["metrics"] = {k: v for k, v in m.items()
                              if not isinstance(v, np.ndarray)}
        summary["auc_ci"] = bootstrap_ci(labels, probs, "auc", n_boot=500)
        if args.calibrate:
            summary["calibrated"] = _calibrate_metrics(
                np.asarray(labels), np.asarray(probs),
                args.calibration_split, args.seed)
        if want_feats and feats:
            # feats rows were collected labeled-row-by-labeled-row in the
            # same order as lab_paths
            summary["few_shot"] = _few_shot_metrics(
                args, lab_paths, np.asarray(labels),
                np.concatenate(feats, axis=0))
        print(json.dumps(summary, default=float, indent=2))


def _calibrate_metrics(labels, probs, split, seed):
    """Isotonic + temperature calibration on a held split, evaluated on the
    rest (inference_deepfakeface_complete.py:383-478)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    n_cal = max(2, int(split * len(labels)))
    cal, ev = order[:n_cal], order[n_cal:]
    if len(ev) < 2 or len(set(labels[cal])) < 2:
        return {"skipped": "too few labeled examples for a split"}
    x_fit, y_fit = isotonic_fit(probs[cal], labels[cal])
    iso_probs = apply_isotonic(x_fit, y_fit, probs[ev])
    z = np.log(np.clip(probs, 1e-6, 1 - 1e-6)
               / np.clip(1 - probs, 1e-6, 1 - 1e-6))
    temp = fit_temperature(z[cal], labels[cal])
    t_probs = 1.0 / (1.0 + np.exp(-z[ev] / temp))
    out = {"n_calibration": int(n_cal), "fitted_temperature": temp}
    for name, p in (("raw", probs[ev]), ("isotonic", iso_probs),
                    ("temperature", t_probs)):
        mm = binary_metrics(labels[ev], p)
        out[name] = {"auc": mm["auc"], "f1": mm["f1"],
                     "brier": float(np.mean((p - labels[ev]) ** 2)),
                     "ece": expected_calibration_error(labels[ev], p)}
    return out


def _few_shot_metrics(args, lab_paths, labels, feats):
    """Few-shot adaptation over frozen features with a reproducible support
    set (inference_deepfakeface_complete.py:835-1013 methods;
    inference_ai_human_images.py:436-543 support-set CSV save/load). The
    probes run on `args.device`."""
    path_idx = {p: i for i, p in enumerate(lab_paths)}
    sup_csv = args.support_csv
    if sup_csv and os.path.exists(sup_csv):
        with open(sup_csv) as f:
            rows = [(r["path"], float(r["label"]))
                    for r in csv.DictReader(f)]
        sup_idx = [path_idx[p] for p, _ in rows if p in path_idx]
        print(f"[few-shot] loaded support set: {len(sup_idx)} examples")
    else:
        rng = np.random.default_rng(args.seed)
        sup_idx = []
        for c in (0.0, 1.0):
            cls = np.flatnonzero(labels == c)
            if len(cls) == 0:
                return {"skipped": f"no examples of class {int(c)} to "
                                   "sample a support set from"}
            take = min(args.few_shot_n, len(cls) // 2 or 1)
            sup_idx.extend(rng.choice(cls, size=take, replace=False))
        sup_idx = [int(i) for i in sup_idx]
        if sup_csv:
            with open(sup_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["path", "label"])
                for i in sup_idx:
                    w.writerow([lab_paths[i], labels[i]])
            print(f"[few-shot] support set saved to: {sup_csv}")
    sup_set = set(sup_idx)
    sup = np.asarray(sorted(sup_set), int)
    qry = np.asarray([i for i in range(len(labels)) if i not in sup_set],
                     int)
    if len(qry) < 2 or len(set(labels[sup])) < 2:
        return {"skipped": "too few examples outside the support set"}
    f_norm = feats / (np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-6)
    on = lambda a: torch.as_tensor(a).to(args.device)
    f_sup, y_sup, f_qry = on(f_norm[sup]), on(labels[sup]), on(f_norm[qry])
    if args.few_shot == "prototype":
        p_fake = prototype_classify(f_sup, y_sup, f_qry)[:, 1]
    elif args.few_shot == "linear":
        p_fake = linear_probe_predict(train_linear_probe(f_sup, y_sup), f_qry)
    else:
        p_fake = kernel_probe_predict(train_kernel_probe(f_sup, y_sup), f_qry)
    mm = binary_metrics(labels[qry], p_fake.cpu().numpy())
    return {"method": args.few_shot, "n_support": int(len(sup)),
            "n_query": int(len(qry)),
            "auc": mm["auc"], "f1": mm["f1"], "accuracy": mm["accuracy"]}


if __name__ == "__main__":
    main()
