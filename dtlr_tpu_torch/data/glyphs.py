"""Text layout and glyph drawing over the font bank: the counterpart of
PIL's ``ImageFont.truetype(path, size)`` with the raqm layout and of
``ImageDraw.text`` on an RGBA layer, as dtlr_tpu/data/synthetic.py uses
them (``getbbox``, ``getmask``, ``getmask2``, ``draw.text``).

- Shaping (HarfBuzz through raqm): the string's characters map to the
  face's glyphs (a character the face lacks to its .notdef); the script
  is ``latn`` when the string holds a letter, else ``DFLT`` (raqm gives
  Common characters their neighbours' script); that script's ligature
  lookups substitute in lookup order, each left to right, the first rule
  of a glyph that matches winning; then each glyph's advance (26.6, the
  unhinted advance rounded from 16.16) gains the pair kerning of each of
  the script's kern lookups with the next glyph, the font units scaled
  by HarfBuzz's multiplier (``(v * x_mult + 32768) >> 16``).
- ``getbbox`` is Pillow's ``bounding_box_and_anchors``: the pen's 26.6
  position through the string, each glyph at ``PIXEL(pen)`` (rounded
  half up), its hinted box, the pen line from 0 to the end, and the
  ascender's anchor.
- ``getmask2`` is Pillow's ``font_render``: an image of the box's size
  (plus the start's ceiling), the origin at the glyphs' bitmaps' least
  left and greatest top, each FreeType bitmap at its rounded pen position
  (so a fractional start shifts glyphs by whole pixels and widens the
  mask by one), overlapping bitmaps combined as ``t + s - DIV255(t*s)``.
- ``draw_text`` is ``ImageDraw.text`` with an RGBA fill on an RGBA image
  (libImaging/Paste.c ``fill_mask_L``).
"""

from __future__ import annotations

import math
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .fonts import FontBank, load_face


def PIXEL(v: int) -> int:
    """FreeType's 26.6 to whole pixels, rounded half up."""
    return ((v + 32) & -64) >> 6


def div255(v):
    """libImaging's DIV255 of a non-negative int (array)."""
    t = v + 128
    return ((t >> 8) + t) >> 8


def script_of(text: str) -> str:
    return "latn" if any(unicodedata.category(c)[0] == "L" for c in text) else "DFLT"


class Shaper:
    """One face's ligature rules and kern tables per script."""

    def __init__(self, face: FontBank):
        self.face = face
        self.rules: Dict[str, List[Dict[int, List[Tuple[Tuple[int, ...], int]]]]] = {}
        self.kern: Dict[str, List[np.ndarray]] = {}
        by_lookup: Dict[int, Dict[int, list]] = {}
        for row in face.ligatures:
            lookup, first, out = int(row[0]), int(row[1]), int(row[2])
            comps = tuple(int(v) for v in row[3:] if v >= 0)
            by_lookup.setdefault(lookup, {}).setdefault(first, []).append((comps, out))
        for script, lookups in face.meta["scripts"].items():
            self.rules[script] = [by_lookup[i] for i in lookups["gsub"] if i in by_lookup]
            self.kern[script] = [face.kern[face.kern_lookups.index(i)] for i in lookups["gpos"]]

    def glyphs(self, text: str) -> Tuple[str, List[int]]:
        """The script and the glyph string after ligature substitution."""
        try:
            glyphs = [self.face.char_glyph[c] for c in text]
        except KeyError as e:
            raise KeyError(f"{self.face.name}: character {e.args[0]!r} is not in the banked charset") from None
        script = script_of(text)
        for rules in self.rules[script]:
            out, i, n = [], 0, len(glyphs)
            while i < n:
                for comps, lig in rules.get(glyphs[i], ()):
                    k = len(comps)
                    if tuple(glyphs[i + 1:i + 1 + k]) == comps:
                        out.append(lig)
                        i += 1 + k
                        break
                else:
                    out.append(glyphs[i])
                    i += 1
            glyphs = out
        return script, glyphs

    def shape(self, text: str, si: int) -> Tuple[List[int], List[int]]:
        """(glyphs, x advances in 26.6) at size index ``si``."""
        script, glyphs = self.glyphs(text)
        adv = [int(v) for v in self.face.advance[si, glyphs]]
        mult = int(self.face.x_mult[si])
        for table in self.kern[script]:
            for i in range(len(glyphs) - 1):
                v = int(table[glyphs[i], glyphs[i + 1]])
                if v:
                    adv[i] += (v * mult + 32768) >> 16
        return glyphs, adv


@lru_cache(maxsize=None)
def _shaper(face_path: str) -> Shaper:
    return Shaper(load_face(face_path))


class BankedFont:
    """``ImageFont.truetype(font_path, size)`` for a banked face."""

    def __init__(self, font_path: str, size: int):
        self.shaper = _shaper(font_path)
        self.face = self.shaper.face
        self.size = int(size)
        self.si = self.face.size_index(self.size)
        self._shapes: Dict[str, Tuple[List[int], List[int]]] = {}

    def shape(self, text: str):
        got = self._shapes.get(text)
        if got is None:
            got = self._shapes[text] = self.shaper.shape(text, self.si)
        return got

    def getlength(self, text: str) -> float:
        return sum(self.shape(text)[1]) / 64

    def _bbox(self, text: str):
        """Pillow's bounding_box_and_anchors with anchor ``la``: (width,
        height, x_offset, y_offset)."""
        glyphs, adv = self.shape(text)
        cbox = self.face.cbox[self.si]
        position = x_min = x_max = y_min = y_max = 0
        for g, a in zip(glyphs, adv):
            px = PIXEL(position)
            position += a
            advanced = PIXEL(position)
            x0, y0, x1, y1 = (int(v) for v in cbox[g])
            x_max = max(x_max, advanced, x1 + px)
            x_min = min(x_min, x0 + px)
            y_max = max(y_max, y1)
            y_min = min(y_min, y0)
        y_anchor = PIXEL(int(self.face.ascender[self.si]))
        return x_max - x_min, y_max - y_min, x_min, -(-y_anchor + y_max)

    def getbbox(self, text: str) -> Tuple[int, int, int, int]:
        w, h, xo, yo = self._bbox(text)
        return xo, yo, xo + w, yo + h

    def mask_size(self, text: str) -> Tuple[int, int]:
        """``getmask(text).size``: (width, height)."""
        w, h, _, _ = self._bbox(text)
        return w, h

    def prefix_rights(self, text: str) -> List[int]:
        """``getbbox(text[:i + 1])[2]`` for every i: each prefix shaped on
        its own, as raqm shapes it (a ligature or a kern at its end forms
        or breaks, a prefix without letters takes the DFLT script)."""
        return [self.getbbox(text[:i + 1])[2] for i in range(len(text))]

    def getmask2(self, text: str, start=(0.0, 0.0)):
        """(mask (h, w) uint8, (x offset, y offset)) as Pillow's
        ``getmask2(text, "L", start=start)``."""
        xs, ys = start
        w, h, xo, yo = self._bbox(text)
        w += math.ceil(xs)
        h += math.ceil(ys)
        img = np.zeros((max(h, 0), max(w, 0)), np.uint8)
        glyphs, adv = self.shape(text)
        if not glyphs or w <= 0 or h <= 0:
            return img, (xo, yo)
        lt = self.face.bitmap_lt[self.si]
        x = x_min = y_max = 0
        for g, a in zip(glyphs, adv):
            left, top = (int(v) for v in lt[g])
            y_max = max(y_max, top)
            x_min = min(x_min, left + PIXEL(x))
            x += a
        x = _c_int(np.float32(np.float32(-x_min) + np.float32(xs)) * np.float32(64))
        y = _c_int(np.float32(np.float32(-y_max) - np.float32(ys)) * np.float32(64))
        out = img.astype(np.int32)
        for g, a in zip(glyphs, adv):
            left, top = (int(v) for v in lt[g])
            bm = self.face.bitmap(self.si, g)
            xx = PIXEL(x) + left
            yy = -(PIXEL(y) + top)
            _screen(out, bm, xx, yy)
            x += a
        return out.astype(np.uint8), (xo, yo)

    def getmask(self, text: str) -> np.ndarray:
        return self.getmask2(text)[0]


def _c_int(v: np.float32) -> int:
    """The C float's 26.6 as Pillow stores it in an int: its 1/64 quanta
    rounded half away from zero."""
    f = float(v)
    return int(math.copysign(math.floor(abs(f) + 0.5), f))


def _screen(out: np.ndarray, bm: np.ndarray, xx: int, yy: int) -> None:
    """Blend a glyph bitmap into the mask, clipped (font_render's
    ``target + source - DIV255(target * source)``)."""
    H, W = out.shape
    h, w = bm.shape
    sx, sy = max(0, -xx), max(0, -yy)
    dx, dy = max(0, xx), max(0, yy)
    w, h = min(w - sx, W - dx), min(h - sy, H - dy)
    if w <= 0 or h <= 0:
        return
    t = out[dy:dy + h, dx:dx + w]
    s = bm[sy:sy + h, sx:sx + w].astype(np.int32)
    out[dy:dy + h, dx:dx + w] = t + s - div255(t * s)


def fill_mask_rgba(img: np.ndarray, mask: np.ndarray, x0: int, y0: int, ink: Sequence[int]) -> None:
    """``ImageDraw.draw_bitmap`` of an L mask with an RGBA ink on an RGBA
    (H, W, 4) uint8 image in place (libImaging/Paste.c ``fill_mask_L``):
    each channel ``DIV255(out * (255 - m) + ink * m)``, where a colour
    channel of a fully transparent pixel takes the ink whole (its mask
    255 wherever ``m`` is not 0; measured against Pillow 12.1)."""
    H, W = img.shape[:2]
    h, w = mask.shape
    sx, sy = max(0, -x0), max(0, -y0)
    dx, dy = max(0, x0), max(0, y0)
    w, h = min(w - sx, W - dx), min(h - sy, H - dy)
    if w <= 0 or h <= 0:
        return
    m = mask[sy:sy + h, sx:sx + w].astype(np.int64)
    region = img[dy:dy + h, dx:dx + w].astype(np.int64)
    alpha = region[..., 3]
    cm = np.where((m != 0) & (alpha == 0), 255, m)
    masks = np.stack([cm, cm, cm, m], -1)
    ink = np.asarray(ink, np.int64)
    img[dy:dy + h, dx:dx + w] = div255(region * (255 - masks) + ink * masks).astype(np.uint8)


def draw_text(img: np.ndarray, xy, text: str, font: BankedFont, fill: Sequence[int]) -> None:
    """``ImageDraw.Draw(rgba).text(xy, text, font=font, fill=fill)`` for a
    one-line text on an RGBA (H, W, 4) uint8 image, in place."""
    coord = [int(xy[0]), int(xy[1])]
    start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
    mask, (ox, oy) = font.getmask2(text, start=start)
    if mask.size:
        fill_mask_rgba(img, mask, coord[0] + ox, coord[1] + oy, fill)
