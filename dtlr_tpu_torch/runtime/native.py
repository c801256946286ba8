"""ctypes bindings of the native host runtime, ``csrc/native.cpp``
(counterpart of dtlr_tpu/runtime/native.py).

The library is built with the host's C++ compiler on first use
(``ops/_build.py``'s ``load_host``). A failed build raises with the
compiler's output: there is no fallback. The plain versions that the
tests hold these against stay beside their callers:
``eval/metrics.py`` (``levenshtein_plain``, ``edit_operations_plain``),
``data/transforms.py`` (``_upscale``, ``pil_resize``'s and
``pil_gaussian_blur``'s passes with ``native=False``), ``data/pil_draw.py``
(``alpha_composite_plain``), ``data/batching.py``
(``normalize_plain``) and ``data/images.py`` (``png_unfilter_plain``,
``jpeg_decode_plain``, ``lzw_decode_plain``, ``packbits_decode_plain``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "native.cpp")

_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_i64, _p = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "levenshtein_u32": (_i64, [_p, _i64, _p, _i64]),
    "edit_ops_u32": (None, [_p, _i64, _p, _i64, _p]),
    "resize_bilinear_f32": (None, [_p, _i64, _i64, _i64, _p, _i64, _i64]),
    "normalize_into_f32": (None, [_p, _i64, _i64, _p, _i64, _i64, _p, _p]),
    "png_unfilter_u8": (_i64, [_p, _i64, _i64, _i64, _p]),
    "tiff_packbits_u8": (_i64, [_p, _i64, _p, _i64]),
    "tiff_lzw_u8": (_i64, [_p, _i64, _p, _i64]),
    "resample_pass_u8": (None, [_p, _i64, _i64, _i64, _i64, _p, _p, _i64, _i64, _p]),
    "box_blur_pass_u8": (None, [_p, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _p]),
    "alpha_composite_u8": (None, [_p, _p, _i64, _p]),
    "jpeg_decode_huffman": (ctypes.c_int, [_p, _i64, _i64, _i64, _i64, _p, _p, _i64, _p, _p,
                                           _i64, _i64, _p, ctypes.c_char_p, _i64]),
}
_lib = None
_lock = threading.Lock()  # the batcher's thread and the caller's may ask at once


def library() -> ctypes.CDLL:
    """The built library with its functions' signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops._build import load_host

            lib = load_host(SOURCE)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _codes(a: Sequence, b: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Both sequences as uint32 codes, equal where their items are equal:
    code points where every item is one character, else ids in order of
    first appearance."""
    try:
        sa, sb = "".join(a), "".join(b)
        if len(sa) == len(a) and len(sb) == len(b):
            return (np.frombuffer(sa.encode("utf-32-le"), np.uint32),
                    np.frombuffer(sb.encode("utf-32-le"), np.uint32))
    except (TypeError, ValueError):
        pass
    ids: dict = {}
    enc = lambda seq: np.asarray([ids.setdefault(t, len(ids)) for t in seq], np.uint32)
    return enc(a), enc(b)


def levenshtein(a: Sequence, b: Sequence) -> int:
    ca, cb = _codes(a, b)
    return int(library().levenshtein_u32(_ptr(ca), len(ca), _ptr(cb), len(cb)))


def edit_ops(pred: Sequence, gt: Sequence) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) turning ``pred`` into ``gt``."""
    ca, cb = _codes(pred, gt)
    out = np.zeros(3, np.int64)
    library().edit_ops_u32(_ptr(ca), len(ca), _ptr(cb), len(cb), _ptr(out))
    return int(out[0]), int(out[1]), int(out[2])


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """float32 (H, W, C) to (out_h, out_w, C), half-pixel bilinear."""
    src = np.ascontiguousarray(img, np.float32)
    h, w, c = src.shape
    if min(h, w, out_h, out_w) < 1:
        raise ValueError(f"resize of {src.shape} to ({out_h}, {out_w})")
    dst = np.empty((out_h, out_w, c), np.float32)
    library().resize_bilinear_f32(_ptr(src), h, w, c, _ptr(dst), out_h, out_w)
    return dst


def normalize_into(src: np.ndarray, dst: np.ndarray) -> None:
    """ImageNet-normalize float32 ``src`` (h, w, 3) into the top-left
    corner of the C-contiguous float32 ``dst`` (H, W, 3)."""
    if dst.dtype != np.float32 or not dst.flags.c_contiguous:
        raise ValueError("dst must be C-contiguous float32")
    s = np.ascontiguousarray(src, np.float32)
    if s.ndim != 3 or dst.ndim != 3 or s.shape[2] != 3 or dst.shape[2] != 3:
        raise ValueError(f"normalize_into takes (h, w, 3) into (H, W, 3), not {s.shape} "
                         f"into {dst.shape}")
    (h, w, _), (H, W, _) = s.shape, dst.shape
    if h > H or w > W:
        raise ValueError(f"{s.shape} does not fit in {dst.shape}")
    library().normalize_into_f32(_ptr(s), h, w, _ptr(dst), H, W, _ptr(_MEAN), _ptr(_STD))


def _hwc_u8(img: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(img, np.uint8)
    return a if a.ndim == 3 else a[..., None]


def resample_pass(img: np.ndarray, axis: int, index: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """One pass of PIL's 8-bit resampler over uint8 (H, W[, C]) along
    ``axis`` with ``transforms._pil_coefficients``' taps (out_size, taps)."""
    src = _hwc_u8(img)
    h, w, c = src.shape
    index = np.ascontiguousarray(index, np.int64)
    weight = np.ascontiguousarray(weight, np.int64)
    out_size, taps = index.shape
    dst = np.empty((out_size, w, c) if axis == 0 else (h, out_size, c), np.uint8)
    library().resample_pass_u8(_ptr(src), h, w, c, axis, _ptr(index), _ptr(weight), out_size,
                               taps, _ptr(dst))
    return dst.reshape(dst.shape[:2] + img.shape[2:])


def box_blur_pass(img: np.ndarray, axis: int, r: int, ww: int, fw: int) -> np.ndarray:
    """One extended box-blur pass over uint8 (H, W[, C]) along ``axis``."""
    src = _hwc_u8(img)
    h, w, c = src.shape
    dst = np.empty_like(src)
    library().box_blur_pass_u8(_ptr(src), h, w, c, axis, r, ww, fw, _ptr(dst))
    return dst.reshape(img.shape)


def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite`` of two RGBA (H, W, 4) uint8 images."""
    d = np.ascontiguousarray(dst, np.uint8)
    s = np.ascontiguousarray(src, np.uint8)
    if d.shape != s.shape or d.shape[-1] != 4:
        raise ValueError(f"alpha_composite of {s.shape} over {d.shape}")
    out = np.empty_like(d)
    library().alpha_composite_u8(_ptr(d), _ptr(s), d.size // 4, _ptr(out))
    return out


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG rows (each a filter byte and ``stride`` bytes) unfiltered:
    uint8 (height, stride)."""
    src = np.frombuffer(raw, np.uint8, count=height * (stride + 1))
    out = np.empty((height, stride), np.uint8)
    bad = library().png_unfilter_u8(_ptr(src), height, stride, bpp, _ptr(out))
    if bad >= 0:
        from ..data.images import UnsupportedImage

        raise UnsupportedImage(f"PNG: filter type {src[bad * (stride + 1)]} in row {bad}")
    return out


def tiff_packbits(data: bytes, size: int) -> bytes:
    """A PackBits strip expanded to at most ``size`` bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    n = library().tiff_packbits_u8(_ptr(src), len(src), _ptr(out), size)
    return out[:n].tobytes()


def tiff_lzw(data: bytes, size: int) -> bytes:
    """An LZW strip expanded to at most ``size`` bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    n = library().tiff_lzw_u8(_ptr(src), len(src), _ptr(out), size)
    if n < 0:
        from ..data.images import UnsupportedImage

        raise UnsupportedImage("TIFF: an LZW code beyond the table")
    return out[:n].tobytes()


def jpeg_decode(data: bytes, info) -> np.ndarray:
    """uint8 (H, W, 3) of a sequential or progressive JPEG whose headers
    ``data/images.py``'s ``parse_jpeg`` read into ``info``."""
    buf = np.frombuffer(data, np.uint8)
    ncomp = len(info.sampling)
    sampling = np.ascontiguousarray(info.sampling, np.int64)
    quant = np.ascontiguousarray(info.quant, np.uint16)
    scans = np.zeros((len(info.scans), 20), np.int64)
    tables = np.ascontiguousarray(np.stack([s.tables for s in info.scans]), np.uint8)
    for i, s in enumerate(info.scans):
        scans[i, :4] = s.start, s.end, s.restart_interval, len(s.components)
        for k, (c, d, a) in enumerate(zip(s.components, s.dc, s.ac)):
            scans[i, 4 + 3 * k:7 + 3 * k] = c, d, a
        scans[i, 16:] = s.ss, s.se, s.ah, s.al
    out = np.empty((info.height, info.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = library().jpeg_decode_huffman(
        _ptr(buf), len(buf), info.width, info.height, ncomp, _ptr(sampling), _ptr(quant),
        len(info.scans), _ptr(scans), _ptr(tables), int(info.progressive), info.transform,
        _ptr(out), err, len(err))
    if rc:
        from ..data.images import UnsupportedImage

        raise UnsupportedImage(f"JPEG: {err.value.decode()}")
    return out
