"""Synthetic Chinese (CASIA HWDB) lines composed from GNT glyph files
(the port's own copy of dtlr_tpu/data/hwdb_synth.py, reference
datasets/HWDB_Synth.py:36-306).

``parse_gnt`` reads CASIA's GNT records (little-endian: sample size u32,
GBK tag 2 bytes, width u16, height u16, the bitmap's bytes); a
``GlyphBank`` keeps every exemplar of each character of a folder of
them; ``SyntheticHWDBGenerator`` draws lines of random glyphs at random
offsets with their boxes, then a random 1.5-2x anisotropic upscale.
The upscale is PIL's 8-bit bilinear resampler, as the JAX package calls
it, in the port's copy (``transforms._pil_pass``), so the lines equal
JAX's bit for bit. Sample dicts are ``BucketBatcher``'s: image float32
(H, W, 3) in [0, 1], labels (n,) int32, boxes (n, 4) pixel xyxy, text.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .transforms import _pil_pass


def parse_gnt(path: str, max_samples: Optional[int] = None):
    """The (char, bitmap uint8 (h, w)) records of one .gnt file; a tag
    that is not GBK is skipped."""
    out = []
    with open(path, "rb") as fh:
        while True:
            header = fh.read(10)
            if len(header) < 10:
                break
            _, tag, w, h = struct.unpack("<I2sHH", header)
            bitmap = np.frombuffer(fh.read(w * h), np.uint8).reshape(h, w)
            try:
                char = tag.decode("gbk")
            except UnicodeDecodeError:
                continue
            out.append((char, bitmap))
            if max_samples and len(out) >= max_samples:
                break
    return out


class GlyphBank:
    """char -> its glyph bitmaps, from the .gnt files of a folder (in
    sorted file order)."""

    def __init__(self, gnt_dir: str, max_per_file: Optional[int] = None):
        self.glyphs: Dict[str, List[np.ndarray]] = {}
        for name in sorted(os.listdir(gnt_dir)):
            if not name.lower().endswith(".gnt"):
                continue
            for char, bmp in parse_gnt(os.path.join(gnt_dir, name), max_per_file):
                self.glyphs.setdefault(char, []).append(bmp)
        self.chars = sorted(self.glyphs)

    def sample(self, rng: np.random.Generator, char: Optional[str] = None):
        if char is None:
            char = self.chars[rng.integers(0, len(self.chars))]
        cands = self.glyphs[char]
        return char, cands[rng.integers(0, len(cands))]


def pil_upscale(canvas: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``Image.fromarray(canvas).resize((new_w, new_h), BILINEAR)`` of a
    uint8 (h, w) canvas: PIL's horizontal pass, then its vertical one."""
    x = torch.from_numpy(np.ascontiguousarray(canvas)).long()[:, :, None]
    if new_w != x.shape[1]:
        x = _pil_pass(x, 1, new_w)
    if new_h != x.shape[0]:
        x = _pil_pass(x, 0, new_h)
    return x[:, :, 0].to(torch.uint8).numpy()


class SyntheticHWDBGenerator:
    """An endless stream of synthetic Chinese lines with character boxes.
    The label space is ``charset`` (the HWDB charset's, when the config
    names its pickle) or the bank's characters; lines use the bank's
    characters that the label space has."""

    def __init__(self, root: str = "./data", gnt_dir: Optional[str] = None,
                 charset: Optional[Sequence[str]] = None, seed: int = 0,
                 glyphs_per_line: Tuple[int, int] = (5, 80), bank: Optional[GlyphBank] = None):
        self.bank = bank or GlyphBank(gnt_dir or os.path.join(root, "HWDB_gnt"))
        self.charset = list(charset) if charset is not None else self.bank.chars
        self.index = {c: i for i, c in enumerate(self.charset)}
        self.rng = np.random.default_rng(seed)
        self.glyphs_per_line = glyphs_per_line

    def sample(self) -> dict:
        rng = self.rng
        n = int(rng.integers(*self.glyphs_per_line))
        glyphs, chars = [], []
        usable = [c for c in self.bank.chars if c in self.index]
        for _ in range(n):
            c = usable[rng.integers(0, len(usable))]
            _, bmp = self.bank.sample(rng, c)
            glyphs.append(bmp)
            chars.append(c)

        h_max = max(g.shape[0] for g in glyphs) + 20
        total_w = sum(g.shape[1] for g in glyphs) + 10 * n + 20
        canvas = np.full((h_max, total_w), 255, np.uint8)
        boxes = []
        x = 10
        for g in glyphs:
            gh, gw = g.shape
            dy = int(rng.integers(0, max(1, h_max - gh)))
            dx = int(rng.integers(0, 8))
            x0 = min(x + dx, total_w - gw)
            canvas[dy:dy + gh, x0:x0 + gw] = np.minimum(canvas[dy:dy + gh, x0:x0 + gw], g)
            boxes.append([x0, dy, x0 + gw, dy + gh])
            x = x0 + gw + int(rng.integers(2, 12))

        # the random anisotropic upscale (reference :177-189)
        fx, fy = rng.uniform(1.5, 2.0), rng.uniform(1.5, 2.0)
        img = pil_upscale(canvas, int(h_max * fy), int(total_w * fx))
        boxes = np.asarray(boxes, np.float32) * np.asarray([fx, fy, fx, fy], np.float32)
        arr = img.astype(np.float32) / 255.0
        return {"image": np.stack([arr] * 3, axis=-1),
                "labels": np.asarray([self.index[c] for c in chars], np.int32),
                "boxes": boxes, "text": "".join(chars)}

    def __iter__(self):
        while True:
            yield self.sample()


def hwdb_charset(pickle_path: Optional[str]) -> Optional[List[str]]:
    """The label space of a charset pickle (code points or characters),
    as the JAX package's entry points read ``hwdb_charset_pickle``; None
    without one."""
    if not pickle_path:
        return None
    import pickle

    with open(pickle_path, "rb") as fh:
        cps = pickle.load(fh)
    return [chr(c) if isinstance(c, int) else c for c in cps]


def hwdb_stream(root: str, seed: int, charset_pickle: Optional[str] = None,
                glyphs_per_line: Optional[Sequence[int]] = None) -> SyntheticHWDBGenerator:
    """The entry points' HWDB_synth stream: the bank under
    ``root``/HWDB_gnt, the pickle's label space if one is named, and
    ``glyphs_per_line`` where given (dtlr_tpu/train/pretrain.py:171-192)."""
    kw = {}
    charset = hwdb_charset(charset_pickle)
    if charset is not None:
        kw["charset"] = charset
    if glyphs_per_line:
        kw["glyphs_per_line"] = tuple(glyphs_per_line)
    return SyntheticHWDBGenerator(root=root, seed=seed, **kw)
