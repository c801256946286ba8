"""PIL's drawing and compositing operations that the synthetic canvas uses
(dtlr_tpu/data/canvas.py and synthetic.py), on uint8 numpy images,
pixel for pixel as Pillow's libImaging computes them:

- ``ellipse``: ``ImageDraw.ellipse(xy, fill=ink)`` (Draw.c ``ellipseNew``:
  the bounds truncated to int, the quarter-ellipse walk on the doubled
  grid, one horizontal span per row);
- ``line``: ``ImageDraw.line(xy, fill=ink, width=w)`` (Bresenham and the
  end point for ``w <= 1``; ``ImagingDrawWideLine``'s four-edge polygon,
  filled by ``polygon_generic``, otherwise);
- both write the ink without blending, as ``ImageDraw.Draw`` of an RGBA
  image in its own mode does;
- ``alpha_composite``: ``Image.alpha_composite`` (AlphaComposite.c, 7
  extra bits of precision);
- ``rgb_to_l``: ``convert("L")`` (ITU-R 601-2 luma in 16-bit fixed point).

The Gaussian blur and the resizes are ``transforms.pil_gaussian_blur``
and ``transforms.pil_resize``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _hline(img: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    """Draw.c ``hline32``: x0..x1 inclusive, clipped."""
    H, W = img.shape[:2]
    if not 0 <= y < H:
        return
    if x0 < 0:
        x0 = 0
    elif x0 >= W:
        return
    if x1 < 0:
        return
    elif x1 >= W:
        x1 = W - 1
    if x0 <= x1:
        img[y, x0:x1 + 1] = ink


def _point(img: np.ndarray, x: int, y: int, ink) -> None:
    H, W = img.shape[:2]
    if 0 <= x < W and 0 <= y < H:
        img[y, x] = ink


# ------------------------------------------------------------ ellipse

class _Quarter:
    """Draw.c ``quarter_state``: the top-right quarter of an ellipse with
    semi-axes a, b on the grid {(2x + a % 2, 2y + b % 2)}."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.cx, self.cy = a, b % 2
            self.ex, self.ey = a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def delta(self, x: int, y: int) -> int:
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        ret = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self.delta(nx, ny)
            if nx > 1:
                d = self.delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self.delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return ret


def _ellipse_spans(a: int, b: int, w: int):
    """Draw.c ``ellipse_init``/``ellipse_next``: the (x0, y, x1) spans of
    an ellipse of width ``w`` on the doubled grid."""
    leftmost = a % 2
    outer = _Quarter(a, b)
    first = outer.next()
    if w < 1 or first is None:
        return
    pr, py = first
    inner = _Quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        while True:
            nxt = outer.next()
            if nxt is None or nxt[1] > y:
                break
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        while True:
            nxt = inner.next()
            if nxt is None or nxt[1] > y:
                break
            l = nxt[0]
        pl = leftmost if nxt is None else nxt[0]
        buf = []
        if (l > 0 or l < r) and y > 0:
            buf.append((2 if l == 0 else l, y, r))
        if y > 0:
            buf.append((-r, y, -l))
        if l > 0 or l < r:
            buf.append((2 if l == 0 else l, -y, r))
        buf.append((-r, -y, -l))
        yield from reversed(buf)


def _cdiv2(v: int) -> int:
    """C's ``v / 2`` (toward zero)."""
    return -((-v) // 2) if v < 0 else v // 2


def ellipse(img: np.ndarray, xy: Sequence[float], ink) -> None:
    """``ImageDraw.Draw(img).ellipse(xy, fill=ink)`` in place."""
    x0, y0, x1, y1 = (float(v) for v in xy)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    for X0, Y, X1 in _ellipse_spans(a, b, a + b):
        _hline(img, x0 + _cdiv2(X0 + a), y0 + _cdiv2(Y + b), x0 + _cdiv2(X1 + a), ink)


# -------------------------------------------------------- lines, polygon

def _line1(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink) -> None:
    """Draw.c ``line32`` (the end point not drawn)."""
    dx, dy = x1 - x0, y1 - y0
    xs = -1 if dx < 0 else 1
    ys = -1 if dy < 0 else 1
    dx, dy = abs(dx), abs(dy)
    if dx == 0:
        for _ in range(dy):
            _point(img, x0, y0, ink)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            _point(img, x0, y0, ink)
            x0 += xs
    elif dx > dy:
        n = dx
        dy += dy
        e = dy - dx
        dx += dx
        for _ in range(n):
            _point(img, x0, y0, ink)
            if e >= 0:
                y0 += ys
                e -= dx
            e += dy
            x0 += xs
    else:
        n = dy
        dx += dx
        e = dx - dy
        dy += dy
        for _ in range(n):
            _point(img, x0, y0, ink)
            if e >= 0:
                x0 += xs
                e -= dy
            e += dx
            y0 += ys


def _round_up(f: float) -> int:
    return int(math.floor(f + 0.5) if f >= 0.0 else -math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(math.ceil(f - 0.5) if f >= 0.0 else -math.ceil(abs(f) - 0.5))


class _Edge:
    """Draw.c ``Edge`` (``add_edge``), its slope in C float."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = np.float32(0.0) if y0 == y1 else np.float32(np.float32(x1 - x0) / np.float32(y1 - y0))
        self.x0, self.y0 = x0, y0

    def x_at(self, y: int) -> np.float32:
        return np.float32(np.float32(np.float32(y - self.y0) * self.dx) + np.float32(self.x0))


def _polygon(img: np.ndarray, edges: Sequence[_Edge], ink) -> None:
    """Draw.c ``polygon_generic`` (non-zero fill, no alpha pass)."""
    H = img.shape[0]
    ymin, ymax = H - 1, 0
    table = []
    for e in edges:
        ymin = min(ymin, e.ymin)
        ymax = max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(img, e.xmin, e.ymin, e.xmax, ink)
            continue
        table.append(e)
    ymin = max(ymin, 0)
    ymax = min(ymax, H)
    f32 = np.float32
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and len(xx) % 2 == 1 and f32(np.round(xx[-1])) == xx[-1]:
                for other in table[:i]:
                    if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
                        continue
                    if np.round(xx[-1]) != np.round(other.x_at(y)):
                        continue
                    offset = -1 if y == cur.ymax else 1
                    adj = cur.x_at(y + offset)
                    if other.ymin <= y + offset <= other.ymax:
                        adj_other = other.x_at(y + offset)
                        if xx[-1] > adj + 1 and xx[-1] > adj_other + 1:
                            xx[-1] = f32(np.round(max(adj, adj_other)) + 1)
                        elif xx[-1] < adj - 1 and xx[-1] < adj_other - 1:
                            xx[-1] = f32(np.round(min(adj, adj_other)) - 1)
                        break
        xx.sort()
        for k in range(1, len(xx), 2):
            x_start = _round_up(float(xx[k - 1]))
            x_end = _round_down(float(xx[k]))
            if x_end < x_start:
                continue
            _hline(img, x_start, y, x_end, ink)


def _wide_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink, width: int) -> None:
    """Draw.c ``ImagingDrawWideLine``."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        _point(img, x0, y0, ink)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max = _round_up(small) / big
    ratio_min = _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
         (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
    _polygon(img, [_Edge(*v[k], *v[(k + 1) % 4]) for k in range(4)], ink)


def line(img: np.ndarray, xy: Sequence[float], ink, width: int = 0) -> None:
    """``ImageDraw.Draw(img).line(xy, fill=ink, width=width)`` in place,
    for a flat [x0, y0, x1, y1, ...] list."""
    pts = [(int(float(xy[k])), int(float(xy[k + 1]))) for k in range(0, len(xy), 2)]
    if width <= 1:
        for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
            _line1(img, ax, ay, bx, by, ink)
        if len(pts) > 1:
            _point(img, *pts[-1], ink)
    else:
        for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
            _wide_line(img, ax, ay, bx, by, ink, width)


# ---------------------------------------------------------- compositing

def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst, src)`` of two RGBA (H, W, 4) uint8
    images, in the native runtime (``alpha_composite_plain`` is the plain
    version it is held to)."""
    from ..runtime import native

    return native.alpha_composite(dst, src)


def alpha_composite_plain(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst, src)`` of two RGBA (H, W, 4) uint8
    images (AlphaComposite.c) in numpy."""
    d = dst.astype(np.int64)
    s = src.astype(np.int64)
    sa, da = s[..., 3:4], d[..., 3:4]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    safe = np.where(outa255 == 0, 1, outa255)
    coef1 = sa * 255 * 255 * (1 << 7) // safe
    coef2 = 255 * (1 << 7) - coef1
    tmp = s[..., :3] * coef1 + d[..., :3] * coef2 + (0x80 << 7)
    rgb = (((tmp >> 8) + tmp) >> 8) >> 7
    a = outa255 + 0x80
    a = ((a >> 8) + a) >> 8
    out = np.concatenate([rgb, a], -1)
    out = np.where(sa == 0, d, out)
    return out.astype(np.uint8)


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """``convert("L")`` of an RGB (H, W, 3) uint8 image (Convert.c rgb2l)."""
    x = rgb.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
