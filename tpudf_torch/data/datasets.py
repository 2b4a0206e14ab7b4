"""Host-side folder image dataset (tpudf/data/datasets.py, numpy only):
the CIFAKE-style TRAIN/VAL/TEST x REAL|FAKE layout
(cifake_binary_classifier.py:112-209, simple_classifier.py:65-114).

Decode runs on the host in a thread pool, in the JAX package's order: the
native C++ JPEG decoder (`data/decode.py`, cpp/libtpudf_decode.so, `.jpg` /
`.jpeg` only) where it loads, else PIL; batches are uint8 NHWC numpy arrays
for the device's preprocessing (data/pipeline.py). A file that fails to
decode becomes a noise image, the reference's graceful degradation (hidf
:243-247, simple_classifier.py:108-114). The video folder dataset reads
clips through `extract_frames`. `load_sid_set` reads SID_Set through the
Hugging Face `datasets` package (imported at the call, so this module
needs none) and `sid_example_to_arrays` maps one of its records to numpy
arrays with PIL.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator

import numpy as np

from tpudf_torch.data.decode import decode_resize

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def list_images(root: str) -> list[str]:
    """Every image file under root (by extension), sorted."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _decode_image(path: str, size: int) -> np.ndarray:
    """uint8 (size, size, 3): the native decoder's decode and resize of a
    JPEG where the library loads; else PIL decode, EXIF orientation, RGB,
    bicubic resize; a noise image (seeded by the path's hash) if that
    fails."""
    arr = decode_resize(path, size)
    if arr is not None:
        return arr
    try:
        from PIL import Image, ImageOps
        with Image.open(path) as im:
            im = ImageOps.exif_transpose(im).convert("RGB")
            im = im.resize((size, size), Image.BICUBIC)
            return np.asarray(im, np.uint8)
    except Exception:
        return np.random.default_rng(abs(hash(path)) % 2**32).integers(
            0, 256, (size, size, 3), np.uint8)


class FolderImageDataset:
    """TRAIN/VAL/TEST x REAL|FAKE folder dataset
    (cifake_binary_classifier.py:112-209). label 1 = FAKE."""

    def __init__(self, root: str, split: str = "train", image_size: int = 256,
                 class_dirs=("REAL", "FAKE")):
        split_dir = None
        for cand in (split.upper(), split.lower(), split.capitalize(), ""):
            p = os.path.join(root, cand) if cand else root
            if all(os.path.isdir(os.path.join(p, c)) for c in class_dirs):
                split_dir = p
                break
        if split_dir is None:
            raise FileNotFoundError(f"no {class_dirs} dirs under {root}")
        self.samples: list[tuple[str, int]] = []
        for label, cdir in enumerate(class_dirs):
            for f in list_images(os.path.join(split_dir, cdir)):
                self.samples.append((f, label))
        self.image_size = image_size

    def __len__(self):
        return len(self.samples)

    def batches(self, batch_size: int, *, shuffle=False, seed=0,
                drop_last=False, workers: int = 8
                ) -> Iterator[dict[str, np.ndarray]]:
        """{"pixels": uint8 (B, S, S, 3), "labels": f32 (B,), "paths"}."""
        idx = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        if drop_last:
            idx = idx[:len(idx) - len(idx) % batch_size]
        with cf.ThreadPoolExecutor(workers) as ex:
            for s in range(0, len(idx), batch_size):
                chunk = idx[s:s + batch_size]
                paths = [self.samples[i][0] for i in chunk]
                labels = np.asarray([self.samples[i][1] for i in chunk],
                                    np.float32)
                imgs = list(ex.map(
                    lambda p: _decode_image(p, self.image_size), paths))
                yield {"pixels": np.stack(imgs), "labels": labels,
                       "paths": paths}


def extract_frames(path: str, num_frames: int, size: int) -> np.ndarray:
    """Uniform frame sampling from a video → uint8 (T, size, size, 3) RGB
    (hidf_video_classifier.py:106-149): T linspace indices over the frame
    count, each read by a cv2 seek and resized with INTER_AREA; a read
    that fails ends the clip, and black frames pad it to T."""
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        frames = []
        if total > 0:
            wanted = np.linspace(0, max(total - 1, 0), num_frames).astype(int)
            for fi in wanted:
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(fi))
                ok, frame = cap.read()
                if not ok:
                    break
                frame = cv2.resize(frame, (size, size),
                                   interpolation=cv2.INTER_AREA)
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
    except Exception:
        frames = []
    while len(frames) < num_frames:          # black-pad short/failed reads
        frames.append(np.zeros((size, size, 3), np.uint8))
    return np.stack(frames[:num_frames]).astype(np.uint8)


class FolderVideoDataset:
    """HiDF layout: a split dir (TRAIN / train / the root) holding REAL and
    FAKE folders of clips, walked recursively
    (hidf_video_classifier.py:172-247). label 1 = FAKE."""

    def __init__(self, root: str, split: str = "train", num_frames: int = 8,
                 image_size: int = 224, class_dirs=("REAL", "FAKE")):
        split_dir = None
        for cand in (split.upper(), split.lower(), ""):
            p = os.path.join(root, cand) if cand else root
            if all(os.path.isdir(os.path.join(p, c)) for c in class_dirs):
                split_dir = p
                break
        if split_dir is None:
            raise FileNotFoundError(f"no {class_dirs} dirs under {root}")
        self.samples = []
        for label, cdir in enumerate(class_dirs):
            d = os.path.join(split_dir, cdir)
            for dirpath, _, files in os.walk(d):
                for f in sorted(files):
                    if f.lower().endswith(VIDEO_EXTS):
                        self.samples.append((os.path.join(dirpath, f), label))
        self.num_frames = num_frames
        self.image_size = image_size

    def __len__(self):
        return len(self.samples)

    def batches(self, batch_size: int, *, shuffle=False, seed=0,
                workers: int = 4) -> Iterator[dict[str, np.ndarray]]:
        """{"frames": uint8 (B, T, S, S, 3), "labels": f32 (B,), "paths"}."""
        idx = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        with cf.ThreadPoolExecutor(workers) as ex:
            for s in range(0, len(idx), batch_size):
                chunk = idx[s:s + batch_size]
                paths = [self.samples[i][0] for i in chunk]
                labels = np.asarray([self.samples[i][1] for i in chunk],
                                    np.float32)
                vids = list(ex.map(
                    lambda p: extract_frames(p, self.num_frames,
                                             self.image_size), paths))
                yield {"frames": np.stack(vids), "labels": labels,
                       "paths": paths}


def load_sid_set(split="train", subset: str | None = None, streaming=False):
    """SID_Set 3-class dataset via HF datasets (siglip2siddataset.py:863-956).
    label mapping: 0=real, 1=full_synthetic, 2=tampered (binary: fake if >0).
    Needs the `datasets` package and the dataset in its cache (or the
    network); callers gate on availability."""
    import datasets as hfd
    name = "saberzl/SID_Set"
    spec = f"{split}[{subset}]" if subset else split
    return hfd.load_dataset(name, split=spec, streaming=streaming)


SID_LABELS = ("real", "fully_synthetic", "tampered")


def _sid_decode_image(obj):
    """PIL image from an HF example field, tolerating the live dataset's
    encodings: PIL (decoded features), {bytes|path} dicts (streaming /
    undecoded Image features), raw arrays."""
    from PIL import Image
    if isinstance(obj, Image.Image):
        return obj
    if isinstance(obj, dict):
        if obj.get("bytes"):
            import io
            return Image.open(io.BytesIO(obj["bytes"]))
        if obj.get("path"):
            return Image.open(obj["path"])
        raise ValueError(f"undecodable image dict keys={sorted(obj)}")
    return Image.fromarray(np.asarray(obj))


def sid_label_to_index(lab) -> int:
    """Reference label semantics (siglip2siddataset.py:871-882): ints pass
    through; strings map real→0 / fully_synthetic→1 / anything else→2 (the
    reference's final `else` treats every other string as tampered).
    "full_synthetic" and "synthetic" (any case) map to 1, with one warning
    per variant, so that schema drift does not relabel silently."""
    if not isinstance(lab, str):
        return int(lab)
    s = lab.strip().lower()
    if s == "real":
        return 0
    if s == "fully_synthetic":
        return 1
    if s in ("full_synthetic", "synthetic"):
        if s not in _SID_VARIANTS_SEEN:
            _SID_VARIANTS_SEEN.add(s)
            print(f"[sid][warn] label spelling variant {lab!r} normalized "
                  "to fully_synthetic (class 1); the reference's else-"
                  "branch would have mapped it to tampered (2)")
        return 1
    return 2


_SID_VARIANTS_SEEN: set = set()


def sid_example_to_arrays(ex, image_size: int) -> dict:
    """One SID_Set example → {pixels uint8 (S,S,3), cls int, binary float,
    mask float32 (S,S), has_mask bool} with the reference's label mapping
    and mask semantics (siglip2siddataset.py:867-911): the image to RGB,
    bicubic-resized; a mask's channel 0, binarized at > 127 when its
    values exceed 1 (PNG masks) else at > 0.5 (float / bool masks), then
    nearest-resized; has_mask whenever a mask decodes, even an all-zero
    one. An undecodable mask gives a zero mask and has_mask False (the
    reference's ValueError fallback, :901-907)."""
    from PIL import Image
    img = _sid_decode_image(ex["image"])
    img = img.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    label = sid_label_to_index(ex["label"])
    mask = ex.get("mask")
    has_mask = False
    if mask is not None:
        try:
            m = np.asarray(_sid_decode_image(mask))
            if m.ndim == 3:
                m = m[..., 0]
            thr = 127 if m.max(initial=0) > 1 else 0.5
            m = (m > thr).astype(np.uint8)
            m = Image.fromarray(m).resize((image_size, image_size),
                                          Image.NEAREST)
            mask = np.asarray(m, np.float32)
            has_mask = True
        except Exception:
            mask = None
    if mask is None:
        mask = np.zeros((image_size, image_size), np.float32)
    return {"pixels": np.asarray(img, np.uint8), "cls": label,
            "binary": float(label > 0), "mask": mask,
            "has_mask": has_mask}
