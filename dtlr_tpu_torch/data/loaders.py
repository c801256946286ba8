"""Line datasets and the dataset registry (counterpart of
dtlr_tpu/data/loaders.py).

A sample is a dict {image float32 (H, W, 3) in [0, 1], labels (n,) int32,
boxes (n, 4) pixel xyxy or None, text}, as ``BucketBatcher`` takes it.

``NpzLines`` reads pre-rendered lines from an npz (uint8 ``images`` (N,
H, W, 3) with ``valid_hw``, ``texts``, ``charset``, and optionally per
line ``labels``, ``boxes`` normalized cxcywh and ``valid``): the port's
source of training and evaluation lines. ``HWDB_synth`` is the
generated Chinese stream (data/hwdb_synth.py). The JAX package's real
datasets (IAM, READ, RIMES, HWDB, the ciphers, Google1000) decode their
images with PIL, and ``synthetic_line_OCR_general`` renders with PIL and
fonts: their names are registered here and raise, and such lines reach
the port written to an npz.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

#: the JAX package's datasets that the port cannot build, and why
NEEDS_PIL = {
    "IAM": "decodes its line images with PIL",
    "READ": "decodes its line images with PIL",
    "RIMES": "decodes its line images with PIL",
    "HWDB": "decodes its line images with PIL",
    "borg": "decodes its line images with PIL",
    "copiale": "decodes its line images with PIL",
    "google1000": "decodes its line images with PIL",
    "synthetic_line_OCR_general": "renders its lines with PIL and fonts",
}


def _split(ground_truth: Dict, mode: str):
    """The split ``mode`` of a label file, taking 'val' and 'valid' for
    each other."""
    aliases = {"val": ("val", "valid"), "valid": ("valid", "val"),
               "train": ("train",), "test": ("test",)}
    for key in aliases.get(mode, (mode,)):
        if key in ground_truth:
            return ground_truth[key]
    raise KeyError(f"split {mode!r} not in {list(ground_truth)}")


def _as_items(gt) -> List[dict]:
    """A split as a list of {id/idx/path?, text} dicts (a dict keyed by
    id becomes a list)."""
    if isinstance(gt, dict):
        return [{"id": k, **(v if isinstance(v, dict) else {"text": v})}
                for k, v in gt.items()]
    return list(gt)


class LineDataset:
    """Base: text lines with charset-indexed labels."""

    charset: List[str]
    token_based = False

    def __init__(self):
        self._index = {c: i for i, c in enumerate(self.charset)}

    def encode(self, text: str, drop: Sequence[str] = ()) -> np.ndarray:
        if self.token_based:
            return np.asarray([self._index[t] for t in text.split(" ") if t in self._index],
                              np.int32)
        return np.asarray([self._index[c] for c in text if c not in drop and c in self._index],
                          np.int32)

    def __len__(self):
        return len(self.items)

    def text_of(self, idx: int) -> str:
        return self.items[idx]["text"]


class NpzLines(LineDataset):
    """Pre-rendered lines from an npz: each image cropped to its
    ``valid_hw`` as float32 / 255; its labels and boxes (normalized cxcywh
    to pixel xyxy) where the npz has them, else the text's labels and no
    boxes. A charset of multi-character tokens makes the texts
    space-separated tokens, as the ciphers' (dtlr_tpu/data/loaders.py
    ``Cipher``)."""

    def __init__(self, path: str):
        with np.load(path) as npz:
            self.arrays = {k: npz[k] for k in npz.files}
        self.charset = [str(c) for c in self.arrays["charset"]]
        self.token_based = any(len(c) > 1 for c in self.charset)
        super().__init__()
        self.items = [{"idx": i, "text": str(t)} for i, t in enumerate(self.arrays["texts"])]

    def __getitem__(self, idx: int) -> dict:
        a = self.arrays
        h, w = (int(v) for v in a["valid_hw"][idx])
        image = np.asarray(a["images"][idx, :h, :w], np.float32) / 255.0
        text = self.items[idx]["text"]
        if "labels" in a:
            keep = a["valid"][idx]
            labels = np.asarray(a["labels"][idx][keep], np.int32)
        else:
            labels = self.encode(text)
        boxes = None
        if "boxes" in a:
            cx, cy, bw, bh = np.asarray(a["boxes"][idx][a["valid"][idx]], np.float32).T
            boxes = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                              (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
        return {"image": image, "labels": labels, "boxes": boxes, "text": text}


def build_dataset(name: str, mode: str = "train", root: str = "./data", **kw):
    """The registry (reference datasets/__init__.py:17-47): ``lines`` reads
    an npz (``path=``), ``HWDB_synth`` is the generated Chinese stream
    (``SyntheticHWDBGenerator``'s arguments); the JAX package's other
    names raise."""
    if name == "lines":
        return NpzLines(kw["path"])
    if name == "HWDB_synth":
        from .hwdb_synth import SyntheticHWDBGenerator

        return SyntheticHWDBGenerator(root=root, **kw)
    if name in NEEDS_PIL:
        raise NotImplementedError(
            f"dataset {name!r} {NEEDS_PIL[name]}, which the port does not use, and its data is "
            "not in the repository: write its lines to an npz and pass that instead")
    raise ValueError(f"unknown dataset {name!r}")


def dataset_iter(ds):
    """The training order: ``ds`` reshuffled forever from
    ``default_rng(0)`` (dtlr_tpu/train/finetune.py:58-75)."""
    rng = np.random.default_rng(0)
    order = np.arange(len(ds))
    while True:
        rng.shuffle(order)
        for i in order:
            yield ds[int(i)]


def eval_iter(ds):
    """``ds`` once, in order."""
    for i in range(len(ds)):
        yield ds[i]
