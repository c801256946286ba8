"""The evaluation snapshot: predicted and ground-truth character boxes
with their labels drawn on a line, written as PNG (counterpart of
dtlr_tpu/utils/visualizer.py, which draws with PIL; here the pixels are
PIL's without it).

- ``draw_boxes``: each box's one-pixel outline as ``ImageDraw.rectangle``
  draws it (corners truncated toward zero, libImaging/Draw.c's
  horizontal spans and vertical runs, clipped to the image), then its
  label as ``ImageDraw.text`` draws it with PIL's default font (Aileron
  Regular at size 10): the glyph's anti-aliased mask at its sub-pixel
  start, blended into the pixels with PIL's 8-bit arithmetic
  (libImaging/Paste.c ``fill_mask_L``).
- The masks come from ``assets/aileron10_glyphs.npz``, which
  tests/test_torch_visualizer.py renders with PIL: for every glyph of
  the font (and the missing glyph, which any other character draws),
  the mask and its offset for each start. FreeType takes the start's
  fractional part in 1/64 pixel (rounded half away from zero), and PIL
  widens the mask by one pixel when the part is positive, so the 130
  horizontal and 66 vertical states index each glyph's table.
- ``write_png``: RGB, 8 bits, no filter, deflated with ``zlib``.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
GLYPHS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "aileron10_glyphs.npz")
#: the label's rise above the box, in pixels (dtlr_tpu/utils/visualizer.py:53)
LABEL_RISE = 10


def denormalize(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized -> uint8."""
    img = image * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def start_state(frac: float, vertical: bool) -> int:
    """The glyph table's index of a start's fractional part: its 1/64
    quantum (FreeType's 26.6, from C float) and whether it is positive."""
    f = np.float32(frac)
    q = int(math.copysign(math.floor(abs(float(f) * 64) + 0.5), float(f)))
    if vertical:
        return 0 if f <= 0 else 1 + q
    return q + 64 if f <= 0 else 65 + q


class GlyphBank:
    """PIL's default font's masks by character and start state."""

    def __init__(self, path: str = GLYPHS):
        with np.load(path) as z:
            self.index = {int(c): i for i, c in enumerate(z["codepoints"])}
            self.table = z["table"]          # (glyphs, 130, 66) mask ids
            self.masks = z["masks"]          # (masks, 4): h, w, offset x, offset y
            self.starts = z["starts"]        # (masks,) into ``data``
            self.data = z["data"]

    def mask(self, ch: str, x: float, y: float):
        """The mask (h, w) uint8 and its offset from (int(x), int(y)) of
        one character drawn at (x, y); a character the font lacks draws
        the missing glyph (code point -1 in the bank)."""
        g = self.index.get(ord(ch), self.index[-1])
        m = int(self.table[g, start_state(math.modf(x)[0], False),
                           start_state(math.modf(y)[0], True)])
        h, w, ox, oy = (int(v) for v in self.masks[m])
        s = int(self.starts[m])
        return self.data[s:s + h * w].reshape(h, w), (ox, oy)


@lru_cache(maxsize=1)
def glyph_bank() -> GlyphBank:
    return GlyphBank()


def _blend(img: np.ndarray, mask: np.ndarray, x0: int, y0: int, color) -> None:
    """PIL's fill with an L mask (``ImagingFill2``): the mask clipped to
    the image, each channel DIV255(in * (255 - m) + ink * m)."""
    H, W = img.shape[:2]
    h, w = mask.shape
    sx, sy = max(0, -x0), max(0, -y0)
    dx, dy = max(0, x0), max(0, y0)
    w, h = min(w - sx, W - dx), min(h - sy, H - dy)
    if w <= 0 or h <= 0:
        return
    m = mask[sy:sy + h, sx:sx + w].astype(np.int64)[..., None]
    region = img[dy:dy + h, dx:dx + w].astype(np.int64)
    t = region * (255 - m) + np.asarray(color, np.int64) * m + 128
    img[dy:dy + h, dx:dx + w] = (((t >> 8) + t) >> 8).astype(np.uint8)


def _hline(img, x0: int, y: int, x1: int, color) -> None:
    H, W = img.shape[:2]
    if not 0 <= y < H:
        return
    if x0 > x1:
        x0, x1 = x1, x0
    if x0 >= W or x1 < 0:
        return
    img[y, max(x0, 0):min(x1, W - 1) + 1] = color


def _vline(img, x: int, y0: int, y1: int, color) -> None:
    """Draw.c's line for dx == 0: |y1 - y0| points from y0 towards y1."""
    H, W = img.shape[:2]
    step = 1 if y1 >= y0 else -1
    for i in range(abs(y1 - y0)):
        y = y0 + i * step
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color


def rectangle(img: np.ndarray, xy, color) -> None:
    """``ImageDraw.rectangle(xy, outline=color, width=1)`` in place."""
    x0, y0, x1, y1 = (float(v) for v in xy)
    if x1 < x0 or y1 < y0:
        raise ValueError("x1 must be greater than or equal to x0, and y1 than y0")
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    _hline(img, x0, y0, x1, color)
    _hline(img, x0, y1, x1, color)
    _vline(img, x1, y0 + 1, y1, color)
    _vline(img, x0, y0 + 1, y1, color)


def text(img: np.ndarray, xy, label: str, color) -> None:
    """``ImageDraw.text(xy, label, fill=color)`` with the default font, for
    a label of one character (a charset's class); a longer label (a
    cipher's symbol name) would need FreeType's layout and raises."""
    if len(label) > 1:
        raise ValueError(f"label {label!r}: only one-character labels are drawn")
    if label:
        x, y = xy
        mask, (ox, oy) = glyph_bank().mask(label, x, y)
        _blend(img, mask, int(x) + ox, int(y) + oy, color)


def draw_boxes(image: np.ndarray, boxes_cxcywh: np.ndarray,
               labels: Optional[Sequence[int]] = None,
               charset: Optional[Sequence[str]] = None, valid_hw=None,
               color=(255, 40, 40)) -> np.ndarray:
    """A uint8 copy of ``image`` ((H, W, 3) normalized or uint8) with the
    boxes (cxcywh normalized to the valid area) and their labels drawn,
    the arithmetic of dtlr_tpu/utils/visualizer.py:30-54 (float32 corners,
    promoted by the valid size's type)."""
    if image.dtype != np.uint8:
        image = denormalize(image)
    img = np.array(image, np.uint8)
    h, w = img.shape[:2]
    vh, vw = (valid_hw if valid_hw is not None else (h, w))
    for i, (cx, cy, bw, bh) in enumerate(np.asarray(boxes_cxcywh, np.float32)):
        x0 = (cx - bw / 2) * vw
        x1 = (cx + bw / 2) * vw
        y0 = (cy - bh / 2) * vh
        y1 = (cy + bh / 2) * vh
        rectangle(img, (x0, y0, x1, y1), color)
        if labels is not None and charset is not None:
            lab = int(labels[i])
            if 0 <= lab < len(charset):
                text(img, (x0, max(0, y0 - LABEL_RISE)), charset[lab], color)
    return img


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8."""
    h, w = rgb.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)], axis=1)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def save_snapshot(out_dir: str, epoch: int, image: np.ndarray, pred_boxes: np.ndarray,
                  pred_labels: Sequence[int], charset: Sequence[str], valid_hw=None,
                  gt_boxes: Optional[np.ndarray] = None) -> str:
    """The first evaluation batch's first line with its predicted boxes
    and labels, and the ground-truth boxes over them in blue, as
    ``<out_dir>/snapshot_epochNNNN.png`` (dtlr_tpu/utils/visualizer.py:57-73)."""
    os.makedirs(out_dir, exist_ok=True)
    img = draw_boxes(image, pred_boxes, pred_labels, charset, valid_hw)
    if gt_boxes is not None and len(gt_boxes):
        img = draw_boxes(img, gt_boxes, valid_hw=valid_hw, color=(40, 120, 255))
    path = os.path.join(out_dir, f"snapshot_epoch{epoch:04d}.png")
    write_png(path, img)
    return path
