"""Image and box transforms on the host (counterpart of
dtlr_tpu/data/transforms.py).

Images are (H, W, 3) float32 in [0, 1] and boxes (N, 4) pixel xyxy until
``normalize_boxes`` makes them normalized cxcywh. The random transforms
draw from ``rng`` (a ``np.random.Generator``) in the JAX package's order,
so a seed gives the same images there and here.

``_interp_resize`` is the one place the JAX package leaves numpy: it
upscales with its C++ helper (dtlr_tpu/runtime/native.cpp,
``resize_bilinear_f32``) and downscales with PIL's bilinear filter. Here
the upscale is the port's own native runtime (``runtime/native.py``),
and the downscale torch ops on CPU tensors, computing the same bytes:
- the upscale: native.cpp's half-pixel bilinear, whose build (``-O3
  -march=native``) contracts each ``a + (b - a) * w`` into one fused
  multiply-add; the port's C++ writes those as ``std::fmaf``.
  ``_upscale`` is its plain version in torch: ``_fma32`` rounds as that
  instruction does.
- ``_pil_bilinear``: PIL's two-pass resampler for 8-bit images
  (libImaging/Resample.c): triangle-filter coefficients scaled by the
  larger of 1 and the reduction factor, as 22-bit fixed point, a
  horizontal then a vertical pass, each rounded and clipped to uint8.
  ``pil_resize`` takes the bicubic filter (a = -0.5) too.

``rotate_with_boxes`` and ``gaussian_blur`` call PIL in the JAX package;
here they are PIL's arithmetic on uint8 tensors:
- ``pil_rotate``: ``Image.rotate(angle, expand=True)`` (nearest): PIL's
  matrix rounded to 15 digits, its expanded size, and its affine
  nearest-neighbour sampling (libImaging/Geometry.c), in 16.16 fixed
  point when the corners fit, else in float64 accumulated as PIL does.
- ``pil_gaussian_blur``: ``ImageFilter.GaussianBlur(radius)``: three
  passes of an extended box blur (libImaging/BoxBlur.c) along x, then
  three along y, with PIL's float32 radius arithmetic and its 24-bit
  fixed-point weights, each pass rounded to uint8.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
# PIL's fixed-point coefficients: 32 bits less 8 for the pixel, 2 spare
_PIL_PRECISION = 22


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once. The product of two
    float32 is exact in float64; the float64 sum may round, which changes
    the float32 result only when it lands exactly between two float32
    values: then the sum's rounding error (two-sum) says which way."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    r = s.float()
    back = r.double()
    inf = torch.tensor(math.inf, dtype=torch.float32)
    other = torch.nextafter(r, torch.where(s >= back, inf, -inf))
    tie = (s - back).abs() == (other.double() - s).abs()
    return torch.where(tie & (err != 0) & ((err > 0) == (other > r)), other, r)


def _upscale_axis(src: int, dst: int):
    """native.cpp's source rows (or columns) and weights along one axis:
    position max(0, (i + 0.5) * (src / dst) - 0.5), the multiply-add
    rounded once (exact rational arithmetic, then one rounding)."""
    f = Fraction(src / dst)
    pos = np.asarray([float(Fraction(2 * i + 1, 2) * f - Fraction(1, 2)) for i in range(dst)],
                     np.float64)
    pos = np.maximum(pos, 0.0)
    i0 = pos.astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy((pos - i0).astype(np.float32)))


def _upscale(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    y0, y1, wy = _upscale_axis(x.shape[0], out_h)
    x0, x1, wx = _upscale_axis(x.shape[1], out_w)
    r0, r1 = x[y0], x[y1]
    p00, p01, p10, p11 = r0[:, x0], r0[:, x1], r1[:, x0], r1[:, x1]
    wx = wx.view(1, -1, 1).expand_as(p00)
    wy = wy.view(-1, 1, 1).expand_as(p00)
    top = _fma32(p01 - p00, wx, p00)
    bot = _fma32(p11 - p10, wx, p10)
    return _fma32(bot - top, wy, top).numpy()


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


#: PIL's filters: (function, support)
_PIL_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_bicubic, 2.0)}


def _pil_coefficients(in_size: int, out_size: int, kind: str = "bilinear"):
    """PIL's taps for one axis (Resample.c precompute_coeffs and
    normalize_coeffs_8bpc): source index and fixed-point weight per
    output pixel and tap, unused taps weighted 0."""
    fn, filter_support = _PIL_FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ss = 1.0 / filterscale
    taps = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, taps), np.int64)
    weight = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            weight[xx, x] = int((-0.5 if v < 0 else 0.5) + v * (1 << _PIL_PRECISION))
            index[xx, x] = xmin + x
    return torch.from_numpy(index), torch.from_numpy(weight)


def _pil_pass(x: torch.Tensor, axis: int, out_size: int, kind: str = "bilinear") -> torch.Tensor:
    """One pass of PIL's 8-bit resampler over int64 pixels (H, W, C)."""
    index, weight = _pil_coefficients(x.shape[axis], out_size, kind)
    if axis == 1:
        acc = (x[:, index] * weight[None, :, :, None]).sum(2)
    else:
        acc = (x[index] * weight[:, :, None, None]).sum(1)
    return ((acc + (1 << (_PIL_PRECISION - 1))) >> _PIL_PRECISION).clamp(0, 255)


def pil_resize(img: np.ndarray, out_h: int, out_w: int, kind: str = "bicubic") -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((out_w, out_h), filter)`` of a
    uint8 (H, W, C) array: the horizontal pass, then the vertical, each
    skipped where the size stays."""
    x = torch.from_numpy(np.array(img, np.int64))
    if out_w != x.shape[1]:
        x = _pil_pass(x, 1, out_w, kind)
    if out_h != x.shape[0]:
        x = _pil_pass(x, 0, out_h, kind)
    return x.to(torch.uint8).numpy()


def _pil_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's ``Image.fromarray(uint8).resize((out_w, out_h), BILINEAR)``
    of the image truncated to uint8, back to float32 in [0, 1]."""
    x = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return pil_resize(x, out_h, out_w, "bilinear").astype(np.float32) / 255.0


def _interp_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize: native.cpp's when neither side shrinks, PIL's
    (antialiased, through uint8) otherwise, as the JAX package does."""
    h, w = img.shape[:2]
    if out_h >= h and out_w >= w:
        from ..runtime import native

        return native.resize_bilinear(img, out_h, out_w)
    return _pil_bilinear(img, out_h, out_w)


def normalize_boxes(boxes, h: int, w: int):
    """Pixel xyxy -> normalized cxcywh."""
    if boxes is None or len(boxes) == 0:
        return boxes
    b = boxes.astype(np.float32)
    cx = (b[:, 0] + b[:, 2]) / 2 / w
    cy = (b[:, 1] + b[:, 3]) / 2 / h
    bw = (b[:, 2] - b[:, 0]) / w
    bh = (b[:, 3] - b[:, 1]) / h
    return np.stack([cx, cy, bw, bh], -1)


def resize_min_side(img, boxes, size: int, max_size: int | None = 1333):
    """Scale so the short side is ``size``, capped so the long side is at
    most ``max_size`` (reference transforms.py:78-107)."""
    h, w = img.shape[:2]
    min_orig, max_orig = min(h, w), max(h, w)
    if max_size is not None and size / min_orig * max_orig > max_size:
        size = int(round(max_size * min_orig / max_orig))
    if min_orig == h:
        out_h, out_w = size, int(round(size * w / h))
    else:
        out_w, out_h = size, int(round(size * h / w))
    out = _interp_resize(img, out_h, out_w)
    scale = np.asarray([out_w / w, out_h / h, out_w / w, out_h / h], np.float32)
    return out, (boxes * scale if boxes is not None and len(boxes) else boxes)


def random_erasing(rng: np.random.Generator, img, p=0.5, scale=(0.02, 0.33),
                   ratio=(0.3, 3.3), value="random"):
    """torchvision-style RandomErasing: up to 10 tries at a box inside the
    image (reference transforms.py:304-311)."""
    if rng.random() > p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(target * r)))
        ew = int(round(np.sqrt(target / r)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            y = rng.integers(0, h - eh)
            x = rng.integers(0, w - ew)
            img = img.copy()
            if value == "random":
                img[y : y + eh, x : x + ew] = rng.random((eh, ew, 3), dtype=np.float32)
            else:
                img[y : y + eh, x : x + ew] = value
            return img
    return img


def random_erasing_full_vertical(rng, img, p=0.9, n_range=(1, 12), width_frac=(0.005, 0.04)):
    """Full-height column erases (reference RandomErasingFullVertical,
    transforms.py:252-301)."""
    if rng.random() > p:
        return img
    h, w = img.shape[:2]
    img = img.copy()
    for _ in range(rng.integers(n_range[0], n_range[1] + 1)):
        ew = max(1, int(rng.uniform(*width_frac) * w))
        x = rng.integers(0, max(1, w - ew))
        img[:, x : x + ew] = rng.random((h, ew, 3), dtype=np.float32)
    return img


def instance_aware_erasing(rng, img, char_boxes, labels, space_label: int, p=0.5,
                           word_p=0.35):
    """Erase whole words found from the character boxes, split at spaces
    (reference InstanceAwareRandomErasing, transforms.py:324-531)."""
    if rng.random() > p or char_boxes is None or len(char_boxes) == 0:
        return img
    img = img.copy()
    h, w = img.shape[:2]
    words, cur = [], []
    for box, lab in zip(char_boxes, labels):
        if lab == space_label:
            if cur:
                words.append(cur)
            cur = []
        else:
            cur.append(box)
    if cur:
        words.append(cur)
    for word in words:
        if rng.random() > word_p or not word:
            continue
        bs = np.asarray(word)
        x0, y0 = bs[:, 0].min(), bs[:, 1].min()
        x1, y1 = bs[:, 2].max(), bs[:, 3].max()
        x0, y0 = max(0, int(x0)), max(0, int(y0))
        x1, y1 = min(w, int(np.ceil(x1))), min(h, int(np.ceil(y1)))
        if x1 > x0 and y1 > y0:
            img[y0:y1, x0:x1] = rng.random((y1 - y0, x1 - x0, 3), dtype=np.float32)
    return img


def crop_with_boxes(img, boxes, labels, region):
    """Crop ``region`` (i, j, h, w); clamp the boxes to it and drop those
    left without area (reference transforms.py:16-56)."""
    i, j, ch, cw = region
    out = img[i : i + ch, j : j + cw]
    if boxes is None or len(boxes) == 0:
        return out, boxes, labels
    b = np.asarray(boxes, np.float32) - np.asarray([j, i, j, i], np.float32)
    b = b.reshape(-1, 2, 2)
    b = np.minimum(b, np.asarray([cw, ch], np.float32))
    b = np.clip(b, 0, None)
    keep = np.all(b[:, 1] > b[:, 0], axis=1)
    b = b.reshape(-1, 4)
    return out, b[keep], (labels[keep] if labels is not None else None)


def random_size_crop(rng, img, boxes, labels, min_size: int, max_size: int):
    """A region of random width and height in [min_size, min(side,
    max_size)] at a uniform place (reference transforms.py:175-185)."""
    h, w = img.shape[:2]
    cw = int(rng.integers(min_size, min(w, max_size) + 1)) if min(w, max_size) >= min_size else w
    ch = int(rng.integers(min_size, min(h, max_size) + 1)) if min(h, max_size) >= min_size else h
    cw, ch = min(cw, w), min(ch, h)
    i = int(rng.integers(0, h - ch + 1))
    j = int(rng.integers(0, w - cw + 1))
    return crop_with_boxes(img, boxes, labels, (i, j, ch, cw))


def scales2_chain(rng, img, boxes, labels, scales2_resize, scales2_crop, scales, max_size):
    """The alternate augmentation branch: resize, random crop, resize
    (reference datasets/transforms.py RandomResize -> RandomSizeCrop ->
    RandomResize). Returns (img, boxes, labels)."""
    size = int(scales2_resize[rng.integers(0, len(scales2_resize))])
    img, boxes = resize_min_side(img, boxes, size, max_size=None)
    img, boxes, labels = random_size_crop(rng, img, boxes, labels, scales2_crop[0],
                                          scales2_crop[1])
    size = int(scales[rng.integers(0, len(scales))])
    img, boxes = resize_min_side(img, boxes, size, max_size=max_size)
    return img, boxes, labels


def adjust_brightness_contrast(rng, img, brightness=(0.8, 1.2), contrast=(0.8, 1.2)):
    img = img * rng.uniform(*brightness)
    mean = img.mean()
    img = (img - mean) * rng.uniform(*contrast) + mean
    return np.clip(img, 0, 1).astype(np.float32)


def lighting_noise(rng, img):
    """Random channel permutation (reference sltransform.py:38-57)."""
    return img[:, :, rng.permutation(3)]


def _pil_rotation(w: int, h: int, angle: float):
    """PIL's ``rotate(angle, expand=True)`` geometry (Image.rotate): the
    inverse affine matrix (output pixel -> input), rounded to 15 digits
    and shifted for the expanded canvas, and the canvas's (nw, nh)."""
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y):
        a, b, c, d, e, f = m
        return a * x + b * y + c, d * x + e * y + f

    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    xx, yy = zip(*(transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def _affine_sources(m, nw: int, nh: int):
    """The input column and row that PIL's nearest-neighbour affine
    (Geometry.c ImagingTransformAffine) reads for every output pixel,
    (nh, nw) int64 each: 16.16 fixed point (affine_fixed) when the four
    corners map inside +-32768, else float64 coordinates accumulated by
    repeated addition, as its loop does, and truncated (-1 below 0)."""
    def fits(x, y):
        return (abs(x * m[0] + y * m[1] + m[2]) < 32768.0
                and abs(x * m[3] + y * m[4] + m[5]) < 32768.0)

    if all(fits(x, y) for x, y in ((0, 0), (nw, nh), (0, nh), (nw, 0))):
        fix = lambda v: math.floor(v * 65536.0 + 0.5)
        a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
        a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
        a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
        ys = torch.arange(nh, dtype=torch.int64)[:, None]
        xs = torch.arange(nw, dtype=torch.int64)[None, :]
        return (a2 + ys * a1 + xs * a0) >> 16, (a5 + ys * a4 + xs * a3) >> 16

    def accumulate(start, row_step, col_step):
        rows = np.cumsum(np.concatenate([[start], np.full(nh - 1, row_step)]))
        grid = np.concatenate([rows[:, None], np.full((nh, nw - 1), col_step)], axis=1)
        v = np.cumsum(grid, axis=1)
        return torch.from_numpy(np.where(v < 0.0, -1, np.trunc(v)).astype(np.int64))

    xo = m[2] + m[1] * 0.5 + m[0] * 0.5
    yo = m[5] + m[4] * 0.5 + m[3] * 0.5
    return accumulate(xo, m[1], m[0]), accumulate(yo, m[4], m[3])


def pil_rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's ``Image.fromarray(img).rotate(angle, expand=True)`` of a uint8
    (H, W[, C]) array: nearest sampling, black where no input pixel
    lands; multiples of 90 degrees as PIL's transposes."""
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270):
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    m, nw, nh = _pil_rotation(w, h, angle)
    if m[1] == 0 and m[3] == 0:
        raise NotImplementedError(f"rotate by {angle}: PIL's scaling path")
    xin, yin = _affine_sources(m, nw, nh)
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    src = torch.from_numpy(np.array(img))
    out = src[yin.clamp(0, h - 1), xin.clamp(0, w - 1)]
    mask = inside.view(nh, nw, *([1] * (src.dim() - 2)))
    return torch.where(mask, out, torch.zeros((), dtype=src.dtype)).numpy()


def rotate_with_boxes(img, boxes, angle: float):
    """Rotate the image by ``angle`` degrees (expand, then PIL's bicubic
    resize back to the original size) and each pixel-xyxy box to the
    axis-aligned hull of its rotated corners (reference
    sltransform.py:60-169), as dtlr_tpu/data/transforms.py:160-204 does:
    the image through uint8 (truncated), the boxes in float64, returned as
    float32."""
    h, w = img.shape[:2]
    rot = pil_rotate((np.clip(img, 0, 1) * 255).astype(np.uint8), angle)
    nh, nw = rot.shape[:2]
    rad = np.radians(angle)
    a, b = np.cos(rad), np.sin(rad)
    cx, cy = w / 2.0, h / 2.0
    m = np.asarray(
        [[a, b, (1 - a) * cx - b * cy + (nw / 2.0 - cx)],
         [-b, a, b * cx + (1 - a) * cy + (nh / 2.0 - cy)]],
        np.float64,
    )
    out_img = np.asarray(pil_resize(rot, h, w, "bicubic"), np.float32) / 255.0
    if boxes is None or len(boxes) == 0:
        return out_img, boxes
    bx = np.asarray(boxes, np.float64)
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    corners = np.stack([np.stack([x1, y1], -1), np.stack([x2, y1], -1),
                        np.stack([x1, y2], -1), np.stack([x2, y2], -1)], axis=1)
    ones = np.ones((*corners.shape[:2], 1))
    rc = np.concatenate([corners, ones], -1) @ m.T  # (N, 4, 2)
    new = np.concatenate([rc.min(axis=1), rc.max(axis=1)], -1)
    new /= np.asarray([nw / w, nh / h, nw / w, nh / h])
    new[:, [0, 2]] = np.clip(new[:, [0, 2]], 0, w)
    new[:, [1, 3]] = np.clip(new[:, [1, 3]], 0, h)
    return out_img, new.astype(np.float32)


def _box_blur_radius(radius: float, passes: int) -> np.float32:
    """BoxBlur.c _gaussian_blur_radius: the extended box's radius whose
    ``passes`` passes have the Gaussian's variance, in C float."""
    f = np.float32
    r = f(radius)
    sigma2 = f(r * r / f(passes))
    L = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(math.floor((float(L) - 1.0) / 2.0))
    a = f(f(f(2) * l + f(1)) * f(l * f(l + f(1)) - f(3) * sigma2))
    a = f(a / f(f(6) * f(sigma2 - f(l + f(1)) * f(l + f(1)))))
    return f(l + a)


def _box_blur_pass(x: torch.Tensor, radius: np.float32, axis: int) -> torch.Tensor:
    """One extended box-blur pass along ``axis`` of int64 pixels
    (BoxBlur.c ImagingLineBoxBlur*): the 2r + 1 pixels around each at
    weight ww and the two beyond at fw, edges repeated, 24-bit fixed
    point rounded to uint8."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    n = x.shape[axis]
    idx = torch.arange(n)
    near = (idx[:, None] + torch.arange(-r, r + 1)[None, :]).clamp(0, n - 1)  # (n, 2r+1)
    left, right = (idx - r - 1).clamp(0, n - 1), (idx + r + 1).clamp(0, n - 1)
    xm = x.movedim(axis, 0)
    acc = xm[near].sum(1)
    bulk = acc * ww + (xm[left] + xm[right]) * fw
    return ((bulk + (1 << 23)) >> 24).movedim(0, axis)


def pil_gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """PIL's ``Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))``
    of a uint8 (H, W[, C]) array."""
    if radius == 0:
        return img.copy()
    box = _box_blur_radius(radius, passes)
    x = torch.from_numpy(np.array(img, np.int64))
    if box != 0:
        for axis in (1, 0):
            for _ in range(passes):
                x = _box_blur_pass(x, box, axis)
    return x.to(torch.uint8).numpy()


def gaussian_blur(rng, img, sigma=(0.1, 2.0)):
    """A Gaussian blur of radius drawn from ``sigma`` on the image through
    uint8 (dtlr_tpu/data/transforms.py:264-270)."""
    s = rng.uniform(*sigma)
    out = pil_gaussian_blur((np.clip(img, 0, 1) * 255).astype(np.uint8), s)
    return out.astype(np.float32) / 255.0
