"""Line datasets and the dataset registry (counterpart of
dtlr_tpu/data/loaders.py).

A sample is a dict {image float32 (H, W, 3) in [0, 1], labels (n,) int32,
boxes (n, 4) pixel xyxy or None, text}, as ``BucketBatcher`` takes it.

The real datasets keep the reference's on-disk layouts and label files
(reference datasets/*.py), as the JAX package reads them: ``IAM``,
``READ``, ``RIMES``, ``HWDB``, the ciphers (``borg``, ``copiale``) and
``google1000``. Their line images decode with ``data/images.py`` (PNG and
baseline JPEG, PIL's pixels without PIL); a TIFF, a progressive JPEG and
a 16-bit or interlaced PNG raise with the reason. Real lines have no
character boxes.

``NpzLines`` reads pre-rendered lines from an npz (uint8 ``images`` (N,
H, W, 3) with ``valid_hw``, ``texts``, ``charset``, and optionally per
line ``labels``, ``boxes`` normalized cxcywh and ``valid``).
``HWDB_synth`` is the generated Chinese stream (data/hwdb_synth.py).
``synthetic_line_OCR_general`` renders with PIL and fonts: its name is
registered and raises, and such lines reach the port written to an npz.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from .charset import load_default_charset
from .images import load_image

#: the JAX package's datasets that the port cannot build, and why
NEEDS_PIL = {
    "synthetic_line_OCR_general": "renders its lines with PIL and fonts",
}


def permuted_latin_charset() -> List[str]:
    """The permuted charset of google1000 and the ciphers' smart mapping
    (reference google1000.py:17-26): the 166-character Latin charset laid
    out without-accent first, permuted by ``RandomState(0)``."""
    charset_without_accent = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789!?")
    accent = list("àáâãäåāæçèéêëìíîïðñòóôõöōøùúûüýþÿÀÁÂÃÄÅÆÇÈÉÊËÌÍÎÏÐÑÒÓÔÕÖØÙÚÛÜÝÞŸ")
    weird = list("«»—’°–œ")
    symbols = list('"#$%&\'()*+,-./:;<=>@[\\]^_`{|}~') + [" "]
    charset = charset_without_accent + accent + weird + symbols
    return np.random.RandomState(0).permutation(charset).tolist()


def _load_labels(*parts: str) -> dict:
    with open(os.path.join(*parts), "rb") as fh:
        return pickle.load(fh)


def _code_points(charset) -> List[str]:
    return [chr(c) if isinstance(c, int) else c for c in charset]


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


class _ImageLines(LineDataset):
    """A real dataset: per item its image's path, labels from its text."""

    drop: Sequence[str] = ()

    def image_path(self, ex: dict) -> str:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        ex = self.items[idx]
        return {"image": load_image(self.image_path(ex)),
                "labels": self.encode(ex["text"], self.drop), "boxes": None, "text": ex["text"]}


class IAM(_ImageLines):
    """reference datasets/IAM.py:35-107: ``IAM_new/labels.pkl`` {charset,
    ground_truth: {train/valid/test: [{id, text, folder}]}}, the default
    Latin charset; images ``IAM_new/data/<image_folder>/lines/<id>.jpg``
    (``.png`` for ``image_folder="original"``)."""

    def __init__(self, root: str, mode: str, image_folder: str = "imgs"):
        data = _load_labels(root, "IAM_new", "labels.pkl")
        self.charset = load_default_charset()
        super().__init__()
        self.items = _as_items(_split(data["ground_truth"], mode))
        self.ext = "png" if image_folder == "original" else "jpg"
        self.img_dir = os.path.join(root, "IAM_new", "data", image_folder, "lines")

    def image_path(self, ex):
        return os.path.join(self.img_dir, f"{ex['id']}.{self.ext}")


class READ(_ImageLines):
    """reference datasets/READ.py:38-110: the charset stored as code
    points, the hyphenation mark '¬' dropped from the labels; an item's
    image at its repository-relative ``path``, else
    ``READ_2016/images/<mode>/<idx>.jpeg``."""

    drop = ("¬",)

    def __init__(self, root: str, mode: str):
        mode = {"val": "valid"}.get(mode, mode)
        self.root = root
        data = _load_labels(root, "READ_2016", "labels.pkl")
        self.charset = _code_points(data["charset"])
        super().__init__()
        self.items = _as_items(_split(data["ground_truth"], mode))
        self.img_dir = os.path.join(root, "READ_2016", "images", mode)

    def image_path(self, ex):
        if "path" in ex:
            return os.path.join(self.root, ex["path"])
        return os.path.join(self.img_dir, f"{ex['idx']}.jpeg")


class RIMES(_ImageLines):
    """reference datasets/RIMES.py:29-100: ``RIMES-2011-Lines/labels_corr.pkl``,
    images ``RIMES-2011-Lines/Images/<id>.jpg``."""

    def __init__(self, root: str, mode: str):
        data = _load_labels(root, "RIMES-2011-Lines", "labels_corr.pkl")
        self.charset = _code_points(data["charset"])
        super().__init__()
        self.items = _as_items(_split(data["ground_truth"], mode))
        self.img_dir = os.path.join(root, "RIMES-2011-Lines", "Images")

    def image_path(self, ex):
        return os.path.join(self.img_dir, f"{ex['id']}.jpg")


class HWDB(_ImageLines):
    """reference datasets/HWDB.py:30-100 (CASIA v2 lines): ``HWDB/data.pkl``,
    images ``HWDB/<mode>/<idx>.png``; ``val`` and ``valid`` are ``test``."""

    def __init__(self, root: str, mode: str):
        mode = {"val": "test", "valid": "test"}.get(mode, mode)
        data = _load_labels(root, "HWDB", "data.pkl")
        self.charset = list(data["charset"])
        super().__init__()
        self.items = _as_items(_split(data["ground_truth"], mode))
        self.img_dir = os.path.join(root, "HWDB", mode)

    def image_path(self, ex):
        # reference HWDB.py:54-59: the file name is under 'idx'
        return os.path.join(self.img_dir, f"{ex.get('idx', ex.get('id'))}.png")


class Cipher(_ImageLines):
    """borg and copiale (reference datasets/borg.py, copiale.py):
    ``old_cipher/labels_<Borg|Copiale>.pkl``. A charset of multi-character
    symbol names makes the texts space-separated tokens, else characters
    (copiale.py:72-79). Images are ``.tif`` (``images.decode_tiff``)."""

    def __init__(self, root: str, mode: str, which: str):
        name = {"borg": "labels_Borg.pkl", "copiale": "labels_Copiale.pkl"}[which]
        data = _load_labels(root, "old_cipher", name)
        self.charset = list(data["charset"])
        super().__init__()
        self.which = which
        self.token_based = any(len(str(t)) > 1 for t in self.charset)
        self.items = _as_items(_split(data["ground_truth"], mode))
        sub = {"borg": "Borgimages", "copiale": os.path.join("..", "copiale", "images")}[which]
        self.img_dir = os.path.join(root, "old_cipher", sub)

    def image_path(self, ex):
        fid = str(ex["id"])
        return os.path.join(self.img_dir, fid if "." in fid else fid + ".tif")


class Google1000(_ImageLines):
    """reference datasets/google1000.py: printed-book lines,
    ``google/labels.pkl``, the permuted Latin charset, images
    ``google/images/<key>``."""

    def __init__(self, root: str, mode: str):
        mode = {"val": "valid"}.get(mode, mode)
        data = _load_labels(root, "google", "labels.pkl")
        self.charset = permuted_latin_charset()
        super().__init__()
        self.items = _as_items(data["ground_truth"][mode])
        self.img_dir = os.path.join(root, "google", "images")

    def image_path(self, ex):
        return os.path.join(self.img_dir, str(ex["id"]))


#: the real datasets' names (reference datasets/__init__.py:17-47)
REAL_DATASETS = ("IAM", "READ", "RIMES", "HWDB", "borg", "copiale", "google1000")


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
    """The registry (reference datasets/__init__.py:17-47): the real
    datasets under ``root`` (``IAM`` takes ``image_folder=``), ``lines``
    reads an npz (``path=``), ``HWDB_synth`` is the generated Chinese
    stream (``SyntheticHWDBGenerator``'s arguments); the renderer's name
    raises."""
    if name == "IAM":
        return IAM(root, mode, **kw)
    if name == "READ":
        return READ(root, mode)
    if name == "RIMES":
        return RIMES(root, mode)
    if name == "HWDB":
        return HWDB(root, mode)
    if name in ("borg", "copiale"):
        return Cipher(root, mode, name)
    if name == "google1000":
        return Google1000(root, mode)
    if name == "lines":
        return NpzLines(kw["path"])
    if name == "HWDB_synth":
        from .hwdb_synth import SyntheticHWDBGenerator

        return SyntheticHWDBGenerator(root=root, **kw)
    if name in NEEDS_PIL:
        raise NotImplementedError(
            f"dataset {name!r} {NEEDS_PIL[name]}, which the port does not use: write its "
            "lines to an npz and pass that instead")
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
