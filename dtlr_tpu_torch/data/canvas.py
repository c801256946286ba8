"""Procedural document-like canvas backgrounds (counterpart of
dtlr_tpu/data/canvas.py, without PIL: images are uint8 numpy arrays and
every PIL operation is ``pil_draw``'s or ``transforms``' bit-for-bit
counterpart; the rng calls are JAX's, in its order).

The reference composites text onto crops of real background images plus
noise patterns from a resources/ folder (reference
datasets/generate_canva.py:94-246). Those assets are not shipped; this
module generates equivalent document-looking backgrounds procedurally:
paper-tone base with low-frequency shading, optional stains/holes noise
patches, global blur and occasional grayscale conversion.

The pool of master backgrounds is module state, shared by every
generator of the process and built by the rng of whichever samples first,
as in the JAX package. A background file that cannot be decoded raises
(the JAX package drops a file PIL cannot open). A line too small for a
stain's or a hole's radius range raises ``CanvasTooSmall``, as numpy's
``uniform`` raises in the JAX package.
"""

from __future__ import annotations

import colorsys
import glob
import os

import numpy as np

from . import pil_draw
from .images import decode_image
from .transforms import pil_gaussian_blur, pil_resize

# pool of pre-rendered base backgrounds, mirroring the reference's fixed
# background-image folder (generate_canva.py samples crops from a static
# resources/ pool); regenerating low-frequency shading per line image is
# the single-core host's hottest path otherwise
_BG_POOL: list = []
_BG_POOL_SIZE = 48
_BG_SIZE = (768, 448)  # (w, h) master backgrounds, cropped per request


_BG_DIR: list = [None]


def set_background_dir(path) -> None:
    """Point the canvas at a real background-image pool (the reference's
    resources/ folder semantics, generate_canva.py:94-136). None reverts
    to procedural backgrounds. Clears the pool."""
    _BG_DIR[0] = path
    _BG_POOL.clear()


def _decode(path: str) -> np.ndarray:
    """``Image.open(path).convert("RGB")`` as uint8 (H, W, 3)."""
    with open(path, "rb") as fh:
        return decode_image(fh.read())


def _load_background_image(rng: np.random.Generator, path: str) -> np.ndarray:
    """Reference background prep (generate_canva.py:94-136): load, resize
    to the master size, random HSV hue shift (color blend), flip, blur."""
    img = pil_resize(_decode(path), _BG_SIZE[1], _BG_SIZE[0], "bilinear")
    if rng.random() < 0.5:  # BACKGROUND_COLOR_BLEND_FREQ
        arr = np.asarray(img, np.float32) / 255.0
        # cheap hue rotation without cv2: rotate RGB channels toward a
        # random hue by matrix blend
        hue = rng.uniform(0, 1)
        r, g, b = colorsys.hsv_to_rgb(hue, 0.5, 1.0)
        tint = np.asarray([r, g, b], np.float32)
        arr = np.clip(arr * 0.6 + arr.mean(-1, keepdims=True) * tint * 0.4, 0, 1)
        img = (arr * 255).astype(np.uint8)
    if rng.random() < 0.5:
        img = np.ascontiguousarray(img[:, ::-1])
    return pil_gaussian_blur(img, rng.uniform(0.2, 1.5))


def _build_pool(rng: np.random.Generator):
    if _BG_DIR[0]:
        paths = sorted(
            p
            for ext in ("*.jpg", "*.jpeg", "*.png")
            for p in glob.glob(os.path.join(_BG_DIR[0], "**", ext), recursive=True)
        )
        while paths and len(_BG_POOL) < _BG_POOL_SIZE:
            p = paths[rng.integers(0, len(paths))]
            _BG_POOL.append(_load_background_image(rng, p))
    while len(_BG_POOL) < _BG_POOL_SIZE:
        _BG_POOL.append(generate_background(rng, *_BG_SIZE))


def pooled_background(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """Random crop (+flip/brightness jitter) of a pooled background."""
    _build_pool(rng)
    base = _BG_POOL[rng.integers(0, len(_BG_POOL))]
    bh, bw = base.shape[:2]
    if w <= bw and h <= bh:
        x = int(rng.integers(0, bw - w + 1))
        y = int(rng.integers(0, bh - h + 1))
        out = base[y:y + h, x:x + w]
    else:
        out = pil_resize(base, h, w, "bilinear")
    if rng.random() < 0.5:
        out = out[:, ::-1]
    if rng.random() < 0.3:
        arr = np.asarray(out, np.float32) + rng.uniform(-15, 15)
        out = np.clip(arr, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(out)


def generate_background(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    base = np.asarray(
        [rng.integers(185, 250), rng.integers(175, 245), rng.integers(160, 235)],
        np.float32,
    )
    img = np.ones((h, w, 3), np.float32) * base[None, None, :]

    # low-frequency shading: a few random smooth gradients
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(rng.integers(1, 4)):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        sx = rng.uniform(w * 0.3, w * 1.5)
        sy = rng.uniform(h * 0.3, h * 1.5)
        amp = rng.uniform(-25, 25)
        img += amp * np.exp(
            -(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2)
        )[:, :, None]

    # fine grain noise
    img += rng.normal(0, rng.uniform(1, 6), (h, w, 1)).astype(np.float32)
    out = np.clip(img, 0, 255).astype(np.uint8)
    if rng.random() < 0.3:
        out = pil_gaussian_blur(out, rng.uniform(0.3, 1.2))
    return out


class CanvasTooSmall(ValueError):
    """A stain's or a hole's radius range is empty: the line is under 62.5
    pixels wide (stain) or 40 on its short side (hole), and numpy refuses
    ``uniform(low, high < low)`` before drawing. The JAX package's
    ``SyntheticLineGenerator.sample`` retries on it (its ``except
    Exception``); the port's retries on this error only."""


def _radius(rng: np.random.Generator, low: float, high: float) -> float:
    try:
        return rng.uniform(low, high)
    except ValueError as e:
        raise CanvasTooSmall(f"uniform({low}, {high}): {e}") from None


def _opaque(rgb: np.ndarray) -> np.ndarray:
    """``convert("RGBA")`` of an RGB image."""
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def add_noise_patterns(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """0-5 stains / holes / phantom marks with rotation+opacity
    (reference generate_canva.py:142-219)."""
    h, w = img.shape[:2]
    overlay = np.zeros((h, w, 4), np.uint8)
    for _ in range(rng.integers(0, 6)):
        kind = rng.choice(["stain", "hole", "streak"])
        opacity = int(rng.integers(20, 90))
        shade = int(rng.integers(0, 120))
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        if kind == "stain":
            rx, ry = _radius(rng, 5, w * 0.08), _radius(rng, 5, h * 0.4)
            pil_draw.ellipse(overlay, [cx - rx, cy - ry, cx + rx, cy + ry],
                             (shade, shade, shade, opacity))
        elif kind == "hole":
            r = _radius(rng, 2, min(w, h) * 0.05)
            bright = int(rng.integers(200, 255))
            pil_draw.ellipse(overlay, [cx - r, cy - r, cx + r, cy + r],
                             (bright, bright, bright, opacity + 60))
        else:  # streak
            x2, y2 = cx + rng.uniform(-w * 0.3, w * 0.3), cy + rng.uniform(-10, 10)
            pil_draw.line(overlay, [cx, cy, x2, y2], (shade, shade, shade, opacity),
                          width=int(rng.integers(1, 4)))
    overlay = pil_gaussian_blur(overlay, rng.uniform(0.3, 2.0))
    return pil_draw.alpha_composite(_opaque(img), overlay)[..., :3]


def compose_canvas(rng: np.random.Generator, text_layer: np.ndarray) -> np.ndarray:
    """Paste an RGBA text layer ((H, W, 4) uint8) onto a generated
    background; global blur and 50% grayscale (reference
    generate_canva.py:229-246). Returns (H, W, 3) uint8."""
    h, w = text_layer.shape[:2]
    bg = pooled_background(rng, w, h)
    if rng.random() < 0.5:
        bg = add_noise_patterns(rng, bg)
    canvas = pil_draw.alpha_composite(_opaque(bg), text_layer)[..., :3]
    if rng.random() < 0.5:
        canvas = pil_gaussian_blur(canvas, rng.uniform(0.2, 1.0))
    if rng.random() < 0.5:
        canvas = np.repeat(pil_draw.rgb_to_l(canvas)[..., None], 3, -1)
    return np.ascontiguousarray(canvas)
