"""Synthetic Latin line generator with per-character boxes (counterpart
of dtlr_tpu/data/synthetic.py, without PIL).

Random text (1-30 words of charset characters, or lines from an
optional text corpus), rendered with a random banked face at size 30-50
with random paddings, per-char bounding boxes from font metrics,
composited onto a document-like canvas (canvas.py), with light
blur/opacity. The glyphs, metrics and layout come from the font bank
(fonts.py, glyphs.py); the lines are JAX's bit for bit for the same
seed, settings and faces (tests/test_torch_synthetic.py), and every rng
call is JAX's, in its order.

The JAX package's ``sample`` retries on any exception. Two can come from
its text and face: numpy's ``uniform`` refusing an empty stain or hole
radius range on a small line (``canvas.CanvasTooSmall`` here), and a face
that drew no ink (its ``_font_ok`` cache's blank-layer check). The port
retries on those alone; a missing face, a character outside the banked
charset or an undecodable background raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import glyphs as G
from .canvas import CanvasTooSmall, compose_canvas
from .charset import DEFAULT_CHARSET_NO_ACCENT, load_charset, load_default_charset
from .fonts import ABILITY_NUMBERS, ABILITY_SYMBOLS, discover_fonts
from .pil_draw import alpha_composite
from .transforms import pil_gaussian_blur

__all__ = ["SyntheticSample", "SyntheticLineGenerator", "render_text_line", "discover_fonts"]


@dataclass
class SyntheticSample:
    image: np.ndarray          # (H, W, 3) float32 [0,1]
    text: str
    labels: np.ndarray         # (n,) charset indices (includes spaces)
    boxes: np.ndarray          # (n, 4) pixel xyxy


def _font_supports(font: G.BankedFont, chars: str) -> bool:
    """True only if the face draws ink for every probed char (a mask of
    zero width or height, or all zero, fails), as the JAX package's probe
    (dtlr_tpu/data/synthetic.py:52-75)."""
    for c in chars:
        if c == " ":
            continue
        w, h = font.mask_size(c)
        if w == 0 or h == 0 or not font.getmask(c).any():
            return False
    return True


def render_text_line(
    rng: np.random.Generator,
    text: str,
    font_path: str,
    font_size: Optional[int] = None,
) -> Tuple[np.ndarray, List[List[float]]]:
    """Render text on a transparent layer; return (RGBA (H, W, 4) uint8
    layer, char xyxy boxes).

    Per-char geometry mirrors the reference (getbbox cumulative x-advance,
    per-char mask height; synthetic_lines_general.py:409-513); spaces get
    a full-line-height advance box.
    """
    font_size = font_size or int(rng.integers(30, 51))
    font = G.BankedFont(font_path, font_size)

    l, t, r, b = font.getbbox(text)
    text_w, text_h = r, b  # getbbox origin includes bearing; draw at (pad, pad)
    pad_top = int(rng.integers(2, 16))
    pad_bottom = int(rng.integers(2, 16))
    pad_left = int(rng.integers(2, 30))
    pad_right = int(rng.integers(2, 30))
    img_w = pad_left + pad_right + text_w
    img_h = pad_top + pad_bottom + text_h
    xy = (pad_left, pad_top)

    line_t, line_b = t, b
    boxes = []
    ends = font.prefix_rights(text)
    for i, ch in enumerate(text):
        x_adv_end = ends[i] + pad_left
        if ch != " ":
            mask_w, mask_h = font.mask_size(ch)
            cb = font.getbbox(ch)
            y_max = cb[3] + pad_top
            y_min = y_max - mask_h
            x_min = x_adv_end - mask_w
        else:
            mask_w = max(1, font.getbbox(" _")[2] - font.getbbox("_")[2])
            y_min, y_max = line_t + pad_top, line_b + pad_top
            x_min = x_adv_end - mask_w
        boxes.append([
            float(np.clip(x_min, 0, img_w - 1e-3)),
            float(np.clip(y_min, 0, img_h - 1e-3)),
            float(np.clip(x_adv_end, 0, img_w)),
            float(np.clip(y_max, 0, img_h)),
        ])

    layer = np.empty((img_h, img_w, 4), np.uint8)
    layer[:] = (255, 255, 255, 0)
    shade = int(rng.integers(0, 76))
    color = (
        tuple(int(rng.integers(0, 76)) for _ in range(3))
        if rng.random() < 0.2
        else (shade, shade, shade)
    )
    opacity = int(rng.integers(180, 256))
    G.draw_text(layer, xy, text, font, color + (opacity,))
    if rng.random() < 0.5:
        layer = pil_gaussian_blur(layer, rng.uniform(0.1, 0.8))
    return layer, boxes


class SyntheticLineGenerator:
    """Infinite sampler of synthetic labelled line images."""

    def __init__(
        self,
        charset: Optional[Sequence[str]] = None,
        corpus_lines: Optional[Sequence[str]] = None,
        seed: int = 0,
        max_words: int = 30,
        fonts: Optional[Sequence[str]] = None,
        plain_background: bool = False,
        font_sampler=None,
        corpus_sampler=None,
        reference_text_mode: bool = False,
        corpus_prob: float = 0.7,
    ):
        self.plain_background = plain_background
        self.charset = list(charset) if charset is not None else load_default_charset()
        self.index = {c: i for i, c in enumerate(self.charset)}
        self.corpus = list(corpus_lines) if corpus_lines else None
        self.corpus_prob = float(corpus_prob)
        self.rng = np.random.default_rng(seed)
        self.max_words = max_words
        self.fonts = list(fonts) if fonts else discover_fonts()
        if not self.fonts:
            raise RuntimeError("no banked fonts found for synthetic generation")
        self._font_ok: dict = {}
        # category/ability font sampling + wikitext corpus (reference
        # synthetic_lines_general.py:160-249,305-310); see fonts.py/corpus.py
        self.font_sampler = font_sampler
        self.corpus_sampler = corpus_sampler
        self.reference_text_mode = reference_text_mode
        if reference_text_mode or font_sampler is not None:
            na = [c for c in load_charset(DEFAULT_CHARSET_NO_ACCENT) if c in self.index]
            self.charset_no_accent = na or self.charset

    # -- text sampling (reference synthetic_lines_general.py:163-249)
    def _sample_text_reference(self):
        """The reference's random_text two-mode draw
        (synthetic_lines_general.py:160-183): 50% full charset, <=5 words
        w/ symbol-able fonts; 50% no-accent charset, <=30 words w/
        letters+numbers fonts. Word length 1-15, total capped at 100."""
        rng = self.rng
        if self.corpus_sampler is not None and rng.integers(0, 2) == 0:
            text = self.corpus_sampler.sample()
            ability = ABILITY_SYMBOLS
        else:
            if rng.integers(1, 3) == 1:
                cs, ability, max_w = self.charset, ABILITY_SYMBOLS, 5
            else:
                cs, ability, max_w = self.charset_no_accent, ABILITY_NUMBERS, 30
            letters = [c for c in cs if c != " "]
            words = []
            for i in range(int(rng.integers(1, max_w + 1))):
                words.append("".join(rng.choice(letters, int(rng.integers(1, 16)))))
            text = " ".join(words)[:100]
        text = "".join(c for c in text if c in self.index)
        font = (
            self.font_sampler.sample(ability)
            if self.font_sampler is not None
            else self.fonts[rng.integers(0, len(self.fonts))]
        )
        return (text.strip() or "a"), font

    def sample_text(self) -> str:
        rng = self.rng
        if self.corpus is not None and rng.random() < self.corpus_prob:
            line = self.corpus[rng.integers(0, len(self.corpus))]
            words = line.split(" ")
            n = int(rng.integers(1, self.max_words + 1))
            start = int(rng.integers(0, max(1, len(words) - n + 1)))
            text = " ".join(words[start : start + n])
        else:
            letters = [c for c in self.charset if c != " "]
            n_words = int(rng.integers(1, self.max_words + 1))
            words = []
            for _ in range(n_words):
                ln = int(rng.integers(1, 11))
                words.append("".join(rng.choice(letters, ln)))
            text = " ".join(words)
        text = "".join(c for c in text if c in self.index)
        return text.strip() or "a"

    def sample(self) -> SyntheticSample:
        rng = self.rng
        for _ in range(20):
            if self.reference_text_mode or self.font_sampler is not None:
                text, font_path = self._sample_text_reference()
            else:
                text = self.sample_text()
                font_path = self.fonts[rng.integers(0, len(self.fonts))]
            key = font_path
            if key not in self._font_ok:
                self._font_ok[key] = _font_supports(G.BankedFont(font_path, 36), "abcXYZ09")
            if not self._font_ok[key]:
                continue
            layer, boxes = render_text_line(rng, text, font_path)
            # belt-and-suspenders: a label must come with visible
            # ink; retry if the layer rendered blank anyway (fonts
            # can pass the probe chars yet fail others)
            if layer[:, :, 3].max() == 0:
                self._font_ok[key] = False
                continue
            if self.plain_background:
                bg = np.empty_like(layer)
                bg[:] = (245, 243, 235, 255)
                canvas = alpha_composite(bg, layer)[..., :3]
            else:
                try:
                    canvas = compose_canvas(rng, layer)
                except CanvasTooSmall:
                    continue
            img = np.asarray(canvas, np.float32) / 255.0
            labels = np.asarray([self.index[c] for c in text], np.int32)
            # chars the font cannot render produce degenerate boxes; keep
            # them (reference keeps zero-height space boxes too)
            return SyntheticSample(
                image=img,
                text=text,
                labels=labels,
                boxes=np.asarray(boxes, np.float32),
            )
        raise RuntimeError("synthetic generation failed 20 times in a row")

    def sample_dict(self) -> dict:
        s = self.sample()
        return {"image": s.image, "labels": s.labels, "boxes": s.boxes, "text": s.text}

    def __iter__(self):
        while True:
            yield self.sample_dict()
