"""Video frame sampling: uniform + scene-adaptive (tpudf/data/video.py, a
copy: the module is numpy and cv2 only).

Re-implements the reference's sampling stack (appv3.py:611-786):
  * stride-histogram scene-change scan (Bhattacharyya over 64-bin grayscale
    histograms)
  * primary-scene selection (longest stable segment)
  * adaptive index selection: uniform base + high-change candidates with a
    minimum index gap
Host-side (container parsing is inherently host work; the decoded frame
stack then moves to device once).
"""

from __future__ import annotations

import numpy as np


def _gray_hist(frame, bins=64):
    g = np.asarray(frame)
    if g.ndim == 3:
        g = (0.299 * g[..., 0] + 0.587 * g[..., 1] + 0.114 * g[..., 2])
    h, _ = np.histogram(g, bins=bins, range=(0, 256))
    h = h.astype(np.float64)
    n = np.linalg.norm(h)
    return h / n if n > 0 else h


def _bhattacharyya(p, q):
    pn = p / (p.sum() + 1e-12)
    qn = q / (q.sum() + 1e-12)
    return float(np.sqrt(max(0.0, 1.0 - np.sum(np.sqrt(pn * qn)))))


def scan_video_changes(read_frame, total_frames: int, stride: int = 5):
    """Histogram-difference scan (appv3.py:611-648). `read_frame(i)` returns
    an RGB array or None. Returns (sampled_indices, diffs)."""
    idxs = list(range(0, max(total_frames, 1), max(stride, 1)))
    hists = []
    kept = []
    for i in idxs:
        f = read_frame(i)
        if f is None:
            continue
        hists.append(_gray_hist(f))
        kept.append(i)
    diffs = [0.0]
    for a, b in zip(hists[:-1], hists[1:]):
        diffs.append(_bhattacharyya(a, b))
    return kept, np.asarray(diffs)


def pick_primary_scene(indices, diffs, cut_thresh=0.45):
    """Longest run between scene cuts (appv3.py:651-675)."""
    if len(indices) == 0:
        return 0, 0
    cuts = [0] + [i for i, d in enumerate(diffs) if d > cut_thresh] \
        + [len(indices)]
    best_lo, best_hi = 0, len(indices)
    best_len = -1
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi - lo > best_len:
            best_len = hi - lo
            best_lo, best_hi = lo, hi
    return indices[best_lo], indices[min(best_hi, len(indices)) - 1]


def adaptive_sample_indices(indices, diffs, max_samples=12, min_gap=2):
    """Uniform base + top-change candidates with min gap
    (appv3.py:677-716)."""
    n = len(indices)
    if n == 0:
        return []
    if n <= max_samples:
        return list(indices)
    base_k = max(max_samples // 2, 1)
    base = [indices[int(i)] for i in
            np.linspace(0, n - 1, base_k).round()]
    order = np.argsort(-np.asarray(diffs))
    chosen = list(base)
    for j in order:
        cand = indices[int(j)]
        if len(chosen) >= max_samples:
            break
        if all(abs(cand - c) >= min_gap for c in chosen):
            chosen.append(cand)
    return sorted(set(chosen))[:max_samples]


def sample_video(path: str, max_samples=12, stride=5, cut_thresh=0.45,
                 size=256, scene_aware=True, prefer_native=True):
    """Full sampler: scan → primary scene → adaptive pick → decode frames.
    Returns (uint8 (T, size, size, 3), frame_indices).

    Prefers the native libavcodec sampler (cpp/video.cc via
    tpudf_torch/data/video_native.py — two multithreaded sequential passes instead of
    cv2's per-index GOP re-decodes); falls back to the cv2 path below, and
    to uniform linspace when scene data is unavailable. Set
    TPUDF_NO_NATIVE_VIDEO=1 or prefer_native=False to force cv2."""
    import os
    if prefer_native and not os.environ.get("TPUDF_NO_NATIVE_VIDEO"):
        from tpudf_torch.data.video_native import sample_video_native
        frames, idxs = sample_video_native(
            path, max_samples=max_samples, stride=stride,
            cut_thresh=cut_thresh, size=size, scene_aware=scene_aware)
        if frames is not None:
            return frames, idxs
    try:
        import cv2
    except ImportError:
        return None, []
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        cap.release()
        return None, []

    def read(i):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, f = cap.read()
        if not ok:
            return None
        return cv2.cvtColor(f, cv2.COLOR_BGR2RGB)

    if scene_aware and total > max_samples * stride:
        kept, diffs = scan_video_changes(read, total, stride)
        if kept:
            lo, hi = pick_primary_scene(kept, diffs, cut_thresh)
            scoped = [(i, d) for i, d in zip(kept, diffs) if lo <= i <= hi]
            if scoped:
                kept = [i for i, _ in scoped]
                diffs = [d for _, d in scoped]
            picks = adaptive_sample_indices(kept, diffs, max_samples,
                                            min_gap=max(stride, 2))
        else:
            picks = []
    else:
        picks = []
    if not picks:
        picks = sorted(set(np.linspace(0, total - 1,
                                       min(max_samples, total)).astype(int)
                           .tolist()))

    frames = []
    out_idx = []
    for i in picks:
        f = read(i)
        if f is None:
            continue
        frames.append(cv2.resize(f, (size, size),
                                 interpolation=cv2.INTER_AREA))
        out_idx.append(int(i))
    cap.release()
    if not frames:
        return None, []
    return np.stack(frames).astype(np.uint8), out_idx
