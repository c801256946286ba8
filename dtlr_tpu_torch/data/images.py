"""Line images from disk without PIL: PNG, JPEG and TIFF, decoded to
exactly the bytes of PIL's ``Image.open(path).convert("RGB")``
(counterpart of dtlr_tpu/data/loaders.py ``_load_image``).

``load_image`` picks the format by the file's signature, as PIL does.
The headers and tables are parsed here; the per-byte loops run in the
native host runtime (``runtime/native.py``): ``png_unfilter_u8`` undoes
the PNG row filters, ``jpeg_decode_huffman`` takes a JPEG's
entropy-coded scans through the colour conversion, ``tiff_lzw_u8`` and
``tiff_packbits_u8`` expand a TIFF strip. A readable numpy version of
each stays here (``decode_image(data, native=False)``) as the oracle
that the tests hold the native one against.

PNG: every bit depth and colour type of the specification (gray,
gray with alpha, palette with ``tRNS`` ignored, RGB, RGBA), plain or
Adam7-interlaced, alpha dropped, as ``convert("RGB")`` does: 16-bit
samples give their high byte, except 16-bit gray, which PIL opens as
``I;16`` and converts clipped to 255. A bad CRC raises.

JPEG: baseline, extended sequential and progressive Huffman (SOF0,
SOF1, SOF2) with 8-bit samples, 1 or 3 components, any scans, restart
intervals, and the sampling factors libjpeg-turbo (PIL's decoder) has a
method for. A progressive file's scans (spectral selection, successive
approximation: DC first and refinement, AC first and refinement with
end-of-band runs, ``jdphuff.c``) fill the coefficients that a
sequential file's do; libjpeg-turbo reads every scan before output, and
its block smoothing has nothing to do when every coefficient's last
bit has come, which the decoder requires (an incomplete file raises).
Its defaults are reproduced: the integer IDCT (``jidctint.c``, ISLOW)
with its range limit, fancy upsampling (``jdsample.c``: h2v1 and h2v2
when the downsampled width exceeds 2, h1v2, replication otherwise) and
the fixed-point YCbCr to RGB of ``jdcolor.c``. Arithmetic, lossless and
hierarchical files, 12-bit samples and 4 components (CMYK, YCCK)
raise.

TIFF: the first image of the file, in strips, either byte order;
uncompressed, PackBits, LZW (with or without the horizontal predictor)
or Deflate; bilevel, 8-bit gray (either polarity), gray with alpha,
RGB, RGBA (unassociated alpha) and 8-bit palette. CCITT, JPEG and
other compressions, tiles, planar layouts and other sample formats
raise with their names.
"""

from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")


class UnsupportedImage(ValueError):
    """An image the port does not decode, with the reason."""


def load_image(path: str) -> np.ndarray:
    """float32 (H, W, 3) in [0, 1]: ``np.asarray(Image.open(path).convert("RGB"),
    np.float32) / 255.0`` without PIL."""
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        rgb = decode_image(data)
    except UnsupportedImage as e:
        raise UnsupportedImage(f"{path}: {e}") from None
    return rgb.astype(np.float32) / 255.0


def decode_image(data: bytes, native: bool = True) -> np.ndarray:
    """uint8 (H, W, 3) of a PNG, JPEG or TIFF file's bytes;
    ``native=False`` decodes with the numpy versions."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, native)
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data, native)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data, native)
    raise UnsupportedImage(f"not a PNG, JPEG or TIFF file (starts {data[:8]!r})")


# --------------------------------------------------------------------- PNG

@dataclass
class PngInfo:
    width: int
    height: int
    depth: int
    color_type: int
    channels: int
    palette: Optional[np.ndarray]
    raw: bytes  # the inflated IDAT stream: per row a filter byte and the row
    interlace: int = 0


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def parse_png(data: bytes) -> PngInfo:
    """The header, palette and inflated image data; every chunk's CRC is
    checked."""
    pos, ihdr, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length or pos + 12 + length > len(data):
            raise UnsupportedImage(f"PNG: chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise UnsupportedImage(f"PNG: CRC of chunk {kind!r} does not match")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise UnsupportedImage("PNG: no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = ihdr
    if color_type not in _PNG_CHANNELS:
        raise UnsupportedImage(f"PNG: colour type {color_type} is not defined")
    if depth not in (1, 2, 4, 8, 16) or (color_type in (2, 4, 6) and depth < 8) or (
            color_type == 3 and depth == 16):
        raise UnsupportedImage(f"PNG: bit depth {depth} with colour type {color_type}")
    if interlace not in (0, 1):
        raise UnsupportedImage(f"PNG: interlace method {interlace} is not defined")
    if color_type == 3 and palette is None:
        raise UnsupportedImage("PNG: palette image without PLTE")
    return PngInfo(width, height, depth, color_type, _PNG_CHANNELS[color_type], palette,
                   zlib.decompress(b"".join(idat)), interlace)


def png_geometry(info: PngInfo, width: Optional[int] = None) -> Tuple[int, int]:
    """Bytes per complete pixel (at least 1) and per row of ``width``
    pixels (the image's by default), filter byte excluded."""
    bits = info.channels * info.depth
    return max(1, bits // 8), ((info.width if width is None else width) * bits + 7) // 8


#: Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def png_unfilter_plain(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five row filters (PNG spec 9.2): uint8 (height, stride)."""
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        cur = np.zeros(stride, np.int64)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prior) & 255
        elif kind in (1, 3, 4):
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prior[x])
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prior[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (int(line[x]) + pred) & 255
        else:
            raise UnsupportedImage(f"PNG: filter type {kind} in row {y}")
        out[y] = cur
        prior = cur
    return out


def png_to_rgb(info: PngInfo, rows: np.ndarray, width: Optional[int] = None) -> np.ndarray:
    """Unfiltered rows of ``width`` pixels (the image's by default) to
    uint8 RGB as ``convert("RGB")`` gives them."""
    w, d = info.width if width is None else width, info.depth
    h = rows.shape[0]
    if d < 8:
        samples = _unpack_low_depth(rows, d, w)
    elif d == 16:
        wide = rows.view(">u2").reshape(h, w, info.channels)
        # 16-bit gray opens as I;16, whose conversion clips; the other
        # types open as 8-bit modes of the high byte
        samples = (np.minimum(wide, 255) if info.color_type == 0 else wide >> 8).astype(np.uint8)
    else:
        samples = rows.reshape(h, w, info.channels)
    if info.color_type == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(info.palette)] = info.palette
        return palette[samples.reshape(h, w)]
    if info.color_type in (0, 4):
        gray = samples.reshape(h, w, -1)[..., 0]
        if d < 8:
            gray = (gray.astype(np.int64) * (255 // ((1 << d) - 1))).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _unpack_low_depth(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(h, stride) packed 1-, 2- or 4-bit samples, most significant first,
    to (h, width) uint8."""
    bits = np.unpackbits(rows, axis=1)  # (h, stride * 8)
    per = bits[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (per * weights).sum(-1).astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, native: bool) -> np.ndarray:
    if native:
        from ..runtime import native as nat

        return nat.png_unfilter(raw, height, stride, bpp)
    return png_unfilter_plain(raw, height, stride, bpp)


def decode_png(data: bytes, native: bool = True) -> np.ndarray:
    info = parse_png(data)
    if info.interlace:
        return _decode_adam7(info, native)
    bpp, stride = png_geometry(info)
    if len(info.raw) < info.height * (stride + 1):
        raise UnsupportedImage("PNG: image data is truncated")
    return png_to_rgb(info, _unfilter(info.raw, info.height, stride, bpp, native))


def _decode_adam7(info: PngInfo, native: bool) -> np.ndarray:
    """The seven passes, each a small image filtered on its own (an empty
    pass has no rows), put in place."""
    out = np.zeros((info.height, info.width, 3), np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(info.width - x0) // dx), -(-(info.height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        bpp, stride = png_geometry(info, pw)
        size = ph * (stride + 1)
        if pos + size > len(info.raw):
            raise UnsupportedImage("PNG: image data is truncated")
        rows = _unfilter(info.raw[pos:pos + size], ph, stride, bpp, native)
        out[y0::dy, x0::dx] = png_to_rgb(info, rows, pw)
        pos += size
    return out


# -------------------------------------------------------------------- JPEG

#: zigzag position -> natural (row-major) index, with libjpeg's 16 extra
#: entries that keep a corrupt run inside the block (jutils.c)
NATURAL_ORDER = np.asarray([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16, np.int64)

#: the markers that end an entropy-coded segment (not FF00 stuffing, not RSTn)
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")

_SOF_REFUSED = {
    0xC3: "lossless JPEG (SOF3)",
    **{m: f"hierarchical JPEG (SOF{m - 0xC0})" for m in (0xC5, 0xC6, 0xC7)},
    **{m: f"arithmetic-coded JPEG (SOF{m - 0xC0})" for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)},
}

#: colour transforms of the decoder: gray, YCbCr to RGB, RGB kept
GRAY, YCC, RGB = 0, 1, 2


@dataclass
class JpegScan:
    start: int                      # offset of the entropy-coded segment
    end: int                        # offset of the marker that ends it
    restart_interval: int
    components: List[int]           # indices into the frame's components
    dc: List[int]                   # per scan component: DC table slot
    ac: List[int]                   # per scan component: AC table slot
    tables: np.ndarray              # (8, 272) uint8: DC 0-3, AC 0-3 (16 counts, 256 values)
    # spectral selection and successive approximation (progressive)
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0


@dataclass
class JpegInfo:
    width: int
    height: int
    sampling: np.ndarray            # (ncomp, 2) int: h, v
    quant: np.ndarray               # (ncomp, 64) uint16, natural order
    transform: int
    scans: List[JpegScan] = field(default_factory=list)
    progressive: bool = False

    @property
    def hmax(self) -> int:
        return int(self.sampling[:, 0].max())

    @property
    def vmax(self) -> int:
        return int(self.sampling[:, 1].max())

    def mcus(self) -> Tuple[int, int]:
        """MCU columns and rows of an interleaved scan."""
        return (-(-self.width // (8 * self.hmax)), -(-self.height // (8 * self.vmax)))

    def downsampled(self, c: int) -> Tuple[int, int]:
        """A component's width and height in samples (jdinput.c)."""
        h, v = (int(x) for x in self.sampling[c])
        return -(-self.width * h // self.hmax), -(-self.height * v // self.vmax)

    def blocks(self, c: int) -> Tuple[int, int]:
        """A component's coefficient array in blocks, padded to whole MCUs."""
        mx, my = self.mcus()
        return int(self.sampling[c, 0]) * mx, int(self.sampling[c, 1]) * my


def parse_jpeg(data: bytes) -> JpegInfo:
    """The frame, the tables each scan sees and where each scan's
    entropy-coded segment lies. Raises for what the decoder does not
    take."""
    pos, frame, restart = 2, None, 0
    qtables: Dict[int, np.ndarray] = {}
    huff = np.zeros((8, 272), np.uint8)
    defined = np.zeros(8, bool)
    latched: Dict[int, np.ndarray] = {}
    jfif = adobe = False
    adobe_transform = None
    scans: List[JpegScan] = []
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise UnsupportedImage(f"JPEG: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise UnsupportedImage("JPEG: truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):
            progressive = marker == 0xC2
            precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise UnsupportedImage(f"JPEG: {precision}-bit samples are not decoded")
            if height == 0:
                raise UnsupportedImage("JPEG: the height is given by a DNL marker, which is "
                                       "not decoded")
            comps = [body[6 + 3 * i:9 + 3 * i] for i in range(ncomp)]
            frame = {"width": width, "height": height, "ids": [c[0] for c in comps],
                     "sampling": np.asarray([(c[1] >> 4, c[1] & 15) for c in comps], np.int64),
                     "tq": [c[2] for c in comps], "progressive": progressive}
            coef_bits = np.full((ncomp, 64), -1, np.int64)
        elif marker in _SOF_REFUSED:
            raise UnsupportedImage(f"JPEG: {_SOF_REFUSED[marker]} is not decoded")
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = np.frombuffer(body[p + 1:p + 17], np.uint8)
                total = int(counts.sum(dtype=np.int64))
                slot = th + 4 * tc
                if total > 256 or tc > 1 or th > 3:
                    raise UnsupportedImage("JPEG: a bad Huffman table")
                huff[slot] = 0
                huff[slot, :16] = counts
                huff[slot, 16:16 + total] = np.frombuffer(body[p + 17:p + 17 + total], np.uint8)
                if tc == 0 and (huff[slot, 16:16 + total] > 15).any():
                    raise UnsupportedImage("JPEG: a DC Huffman table with a symbol above 15")
                defined[slot] = True
                p += 17 + total
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(body[p + 1:p + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[NATURAL_ORDER[:64]] = vals
                qtables[tq] = table
                p += 1 + size
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise UnsupportedImage("JPEG: scan before the frame header")
            ns = body[0]
            sel = [body[1 + 2 * i:3 + 2 * i] for i in range(ns)]
            if not 1 <= ns <= 4 or any(s[0] not in frame["ids"] for s in sel):
                raise UnsupportedImage("JPEG: a scan names components the frame lacks")
            comps = [frame["ids"].index(s[0]) for s in sel]
            dc, ac = [s[1] >> 4 for s in sel], [s[1] & 15 for s in sel]
            ss_, ah_ = body[1 + 2 * ns], body[3 + 2 * ns] >> 4
            for c, d, a in zip(comps, dc, ac):
                # a progressive scan uses the DC tables of a first DC scan, or
                # the AC tables of an AC scan, alone (jdphuff.c start_pass)
                need_dc = not frame["progressive"] or (ss_ == 0 and ah_ == 0)
                need_ac = not frame["progressive"] or ss_ > 0
                if d > 3 or a > 3 or (need_dc and not defined[d]) or (
                        need_ac and not defined[4 + a]):
                    raise UnsupportedImage("JPEG: a scan uses an undefined Huffman table")
                if c not in latched:  # libjpeg latches a component's table at its first scan
                    if frame["tq"][c] not in qtables:
                        raise UnsupportedImage("JPEG: a component uses an undefined quantization "
                                               "table")
                    latched[c] = qtables[frame["tq"][c]].copy()
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            if frame["progressive"]:
                _check_progressive_scan(ss, se, ah, al, comps, coef_bits)
            m = _SEGMENT_END.search(data, pos)
            end = m.start() if m else n
            scans.append(JpegScan(pos, end, restart, comps, dc, ac, huff.copy(), ss, se, ah, al)
                         if frame["progressive"] else
                         JpegScan(pos, end, restart, comps, dc, ac, huff.copy()))
            pos = end
    if frame is None:
        raise UnsupportedImage("JPEG: no baseline, extended sequential or progressive frame "
                               "header (SOF0, SOF1, SOF2)")
    if frame["progressive"] and (coef_bits != 0).any():
        c, k = np.argwhere(coef_bits != 0)[0]
        raise UnsupportedImage(f"JPEG: a progressive file whose scans leave coefficient {k} of "
                               f"component {c} incomplete (libjpeg would smooth its blocks)")
    ncomp = len(frame["ids"])
    if ncomp == 4:
        raise UnsupportedImage("JPEG: 4-component (CMYK or YCCK) images are not decoded")
    if ncomp not in (1, 3):
        raise UnsupportedImage(f"JPEG: {ncomp} components")
    if not scans or len(latched) != ncomp:
        raise UnsupportedImage("JPEG: a component has no scan")
    samp = frame["sampling"]
    if (samp < 1).any() or (samp > 4).any():
        raise UnsupportedImage(f"JPEG: sampling factors {samp.tolist()}")
    hmax, vmax = samp[:, 0].max(), samp[:, 1].max()
    if ncomp > 1 and ((hmax % samp[:, 0]).any() or (vmax % samp[:, 1]).any()):
        raise UnsupportedImage(f"JPEG: fractional sampling factors {samp.tolist()} (libjpeg "
                               "has no method for them either)")
    if ncomp == 1:
        transform = GRAY
        samp = np.ones_like(samp)  # a lone component is never subsampled
    elif jfif:
        transform = YCC
    elif adobe:
        transform = RGB if adobe_transform == 0 else YCC
    else:
        transform = RGB if frame["ids"] == [82, 71, 66] else YCC
    for s in scans:
        if len(s.components) > 1:
            blocks = sum(int(samp[c, 0] * samp[c, 1]) for c in s.components)
            if blocks > 10:
                raise UnsupportedImage(f"JPEG: {blocks} blocks per MCU (at most 10)")
    quant = np.stack([latched[c] for c in range(ncomp)])
    return JpegInfo(frame["width"], frame["height"], samp, quant, transform, scans,
                    frame["progressive"])


def _check_progressive_scan(ss: int, se: int, ah: int, al: int, comps: List[int],
                            coef_bits: np.ndarray) -> None:
    """jdphuff.c start_pass_phuff_decoder's checks, and each coefficient's
    successive-approximation bit after the scan (``coef_bits``, -1 before
    its first scan)."""
    bad = (ss > se or se > 63 or al > 13 or (ah and ah != al + 1)
           or (ss == 0 and se != 0) or (ss > 0 and len(comps) != 1))
    if bad:
        raise UnsupportedImage(f"JPEG: a progressive scan with Ss={ss} Se={se} Ah={ah} Al={al} "
                               f"over {len(comps)} components")
    for c in comps:
        band = coef_bits[c, ss:se + 1]
        expected = -1 if ah == 0 else ah
        if (band != expected).any():
            raise UnsupportedImage(f"JPEG: a progressive scan of coefficients {ss}-{se} out of "
                                   "order")
        coef_bits[c, ss:se + 1] = al


def decode_jpeg(data: bytes, native: bool = True) -> np.ndarray:
    info = parse_jpeg(data)
    if native:
        from ..runtime import native as nat

        return nat.jpeg_decode(data, info)
    return jpeg_decode_plain(data, info)


# ---- the plain JPEG decoder: Huffman in Python, the rest in numpy

def _huffman_lut(table: np.ndarray) -> Tuple[List[int], List[int]]:
    """Per 16-bit prefix, the code's length (0 where no code starts) and
    its symbol."""
    counts, values = table[:16].astype(np.int64), table[16:]
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(int(counts[bits - 1])):
            lo, hi = code << (16 - bits), (code + 1) << (16 - bits)
            length[lo:hi], symbol[lo:hi] = bits, int(values[k])
            code, k = code + 1, k + 1
        code <<= 1
    return length.tolist(), symbol.tolist()


class _BitReader:
    """MSB-first bits of an entropy-coded segment, FF00 unstuffed. A marker
    ends the data: zeros follow, and once a decode consumes them the rest
    of the restart interval is left zero (jdhuff.c's insufficient_data)."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end, self.limit = data, start, end, end
        self.acc = self.nbits = self.padded = 0
        self.insufficient = False

    def _fill(self):
        data = self.data
        while self.nbits <= 24:
            byte = 0
            if self.pos < self.end:
                byte = data[self.pos]
                self.pos += 1
                if byte == 0xFF:
                    if self.pos < self.end and data[self.pos] == 0:
                        self.pos += 1
                    else:  # a marker
                        self.pos -= 1
                        self.end = self.pos
                        byte = 0
                        self.padded += 8
            else:
                self.padded += 8
            self.acc = ((self.acc << 8) | byte) & 0xFFFFFFFFFF
            self.nbits += 8

    def _consumed(self):
        if self.nbits < self.padded:
            self.insufficient = True
            self.padded = self.nbits

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int):
        self.nbits -= n
        self._consumed()

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        self._consumed()
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def restart(self):
        """Drop the buffered bits and step over the next RSTn marker."""
        self.acc = self.nbits = self.padded = 0
        self.insufficient = False
        self.end = self.limit
        m = _RESTART.search(self.data, self.pos, self.limit)
        if m is not None:
            self.pos = m.end()


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def jpeg_coefficients_plain(data: bytes, info: JpegInfo) -> List[np.ndarray]:
    """Every component's quantized coefficients, (blocks_y, blocks_x, 64)
    int64 in natural order, from its scans."""
    coefs = [np.zeros((*info.blocks(c)[::-1], 64), np.int64) for c in range(len(info.sampling))]
    natural = NATURAL_ORDER.tolist()
    for scan in info.scans:
        luts = [_huffman_lut(t) for t in scan.tables]
        reader = _BitReader(data, scan.start, scan.end)
        comps = scan.components
        if len(comps) == 1:
            c = comps[0]
            w, h = info.downsampled(c)
            units = [[(c, by, bx)] for by in range(-(-h // 8)) for bx in range(-(-w // 8))]
        else:
            mx, my = info.mcus()
            units = [[(c, my_ * int(info.sampling[c, 1]) + v, mx_ * int(info.sampling[c, 0]) + u)
                      for c in comps
                      for v in range(int(info.sampling[c, 1]))
                      for u in range(int(info.sampling[c, 0]))]
                     for my_ in range(my) for mx_ in range(mx)]
        slot = {c: i for i, c in enumerate(comps)}
        last_dc = [0] * len(info.sampling)
        eobrun = [0]
        for i, unit in enumerate(units):
            if scan.restart_interval and i and i % scan.restart_interval == 0:
                reader.restart()
                last_dc = [0] * len(info.sampling)
                eobrun[0] = 0
            if reader.insufficient:
                continue
            if info.progressive:
                for c, by, bx in unit:
                    _progressive_block(reader, scan, luts, slot[c], c, coefs[c][by, bx],
                                       last_dc, eobrun, natural)
                continue
            for c, by, bx in unit:
                dlen, dsym = luts[scan.dc[slot[c]]]
                alen, asym = luts[4 + scan.ac[slot[c]]]
                block = coefs[c][by, bx]
                peek = reader.peek16()
                s = dsym[peek]
                reader.skip(dlen[peek] or 16)
                diff = _extend(reader.bits(s), s) if s else 0
                last_dc[c] += diff
                block[0] = last_dc[c]
                k = 1
                while k < 64:
                    peek = reader.peek16()
                    rs = asym[peek]
                    reader.skip(alen[peek] or 16)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        block[natural[k]] = _extend(reader.bits(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
    return coefs


def _decode(reader: _BitReader, lut) -> int:
    length, symbol = lut
    peek = reader.peek16()
    reader.skip(length[peek] or 16)
    return symbol[peek]


def _progressive_block(reader: _BitReader, scan: JpegScan, luts, k_slot: int, c: int,
                       block: np.ndarray, last_dc: List[int], eobrun: List[int],
                       natural: List[int]) -> None:
    """One block of a progressive scan (jdphuff.c): DC first (the
    difference shifted by Al) or refinement (one bit), AC first (a band
    with end-of-band runs) or refinement (correction bits of the nonzero
    coefficients, new ones of magnitude 1 << Al)."""
    al = scan.al
    if scan.ss == 0:
        if scan.ah == 0:
            s = _decode(reader, luts[scan.dc[k_slot]])
            last_dc[c] += _extend(reader.bits(s), s) if s else 0
            block[0] = last_dc[c] << al
        elif reader.bits(1):
            block[0] |= 1 << al
        return
    lut = luts[4 + scan.ac[k_slot]]
    if scan.ah == 0:
        if eobrun[0] > 0:
            eobrun[0] -= 1
            return
        k = scan.ss
        while k <= scan.se:
            rs = _decode(reader, lut)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                block[natural[k]] = _extend(reader.bits(s), s) << al
            elif r == 15:
                k += 15
            else:
                eobrun[0] = (1 << r) + reader.bits(r) - 1
                break
            k += 1
        return
    p1, m1 = 1 << al, -1 << al

    def correct(pos):
        if reader.bits(1) and (block[pos] & p1) == 0:
            block[pos] += p1 if block[pos] >= 0 else m1

    k = scan.ss
    if eobrun[0] == 0:
        while k <= scan.se:
            rs = _decode(reader, lut)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if reader.bits(1) else m1
            elif r != 15:
                eobrun[0] = (1 << r) + reader.bits(r)
                break
            while k <= scan.se:
                pos = natural[k]
                if block[pos] != 0:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                block[natural[k]] = s
            k += 1
    if eobrun[0] > 0:
        while k <= scan.se:
            if block[natural[k]] != 0:
                correct(natural[k])
            k += 1
        eobrun[0] -= 1


# jidctint.c's constants: CONST_BITS 13, PASS1_BITS 2
_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
        "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
        "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x: np.ndarray, shift: int) -> np.ndarray:
    """jpeg_idct_islow's butterfly along the last axis (8 values), each
    output descaled by ``shift`` with rounding."""
    f = _FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 + z3 * -f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + half) >> shift for o in outs], -1)


def idct_islow_plain(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Blocks (..., 64) of quantized coefficients to uint8 samples (..., 8,
    8) as jidctint.c computes them: columns then rows, the range limit
    taken on the result masked to 10 bits (jdmaster.c's table)."""
    x = (coefs * quant.astype(np.int64)).reshape(*coefs.shape[:-1], 8, 8)
    cols = _idct_1d(np.swapaxes(x, -1, -2), 13 - 2)          # pass 1, per column
    rows = _idct_1d(np.swapaxes(cols, -1, -2), 13 + 2 + 3)   # pass 2, per row
    idx = rows & 1023
    table = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384, np.int64),
                            np.arange(0, 128)])
    return table[idx].astype(np.uint8)


def _component_plane(coefs: np.ndarray, quant: np.ndarray, w: int, h: int) -> np.ndarray:
    blocks = idct_islow_plain(coefs, quant)                    # (by, bx, 8, 8)
    by, bx = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:h, :w].astype(np.int64)


def upsample_plain(plane: np.ndarray, rh: int, rv: int, width: int, height: int) -> np.ndarray:
    """jdsample.c's method for an upsampling ratio (rh, rv) of a
    component's samples (its downsampled height and width) to at least
    (height, width)."""
    dh, dw = plane.shape
    if rh == 1 and rv == 1:
        out = plane
    elif rh == 2 and rv == 1 and dw > 2:
        out = _fancy_h2(plane, 1, 2)
    elif rh == 1 and rv == 2:
        above = np.concatenate([plane[:1], plane[:-1]])
        below = np.concatenate([plane[1:], plane[-1:]])
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (plane * 3 + above + 1) >> 2
        out[1::2] = (plane * 3 + below + 2) >> 2
    elif rh == 2 and rv == 2 and dw > 2:
        above = np.concatenate([plane[:1], plane[:-1]])
        below = np.concatenate([plane[1:], plane[-1:]])
        out = np.empty((2 * dh, 2 * dw), np.int64)
        out[0::2] = _fancy_h2(plane * 3 + above, 8, 7, shift=4)
        out[1::2] = _fancy_h2(plane * 3 + below, 8, 7, shift=4)
    else:  # h2v1 and h2v2 at widths <= 2, and every other integral ratio
        out = np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)
    return out[:height, :width]


def _fancy_h2(colsum: np.ndarray, even_bias: int, odd_bias: int, shift: int = 2) -> np.ndarray:
    """The horizontal triangle filter: output 2j from 3 x[j] + x[j - 1],
    2j + 1 from 3 x[j] + x[j + 1], edges replicated, with jdsample.c's
    alternating biases (h2v1: 1 and 2, shift 2; h2v2 on column sums: 8
    and 7, shift 4)."""
    left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
    right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
    out = np.empty((colsum.shape[0], 2 * colsum.shape[1]), np.int64)
    out[:, 0::2] = (colsum * 3 + left + even_bias) >> shift
    out[:, 1::2] = (colsum * 3 + right + odd_bias) >> shift
    return out


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def ycc_to_rgb_plain(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: its tables in 16-bit fixed point,
    results clamped to 0-255."""
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def jpeg_decode_plain(data: bytes, info: JpegInfo) -> np.ndarray:
    coefs = jpeg_coefficients_plain(data, info)
    planes = []
    for c, co in enumerate(coefs):
        w, h = info.downsampled(c)
        plane = _component_plane(co, info.quant[c], w, h)
        rh = info.hmax // int(info.sampling[c, 0])
        rv = info.vmax // int(info.sampling[c, 1])
        planes.append(upsample_plain(plane, rh, rv, info.width, info.height))
    if info.transform == GRAY:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if info.transform == RGB:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb_plain(*planes)


# -------------------------------------------------------------------- TIFF

#: compressions by tag value: those decoded, then those refused by name
TIFF_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_TIFF_REFUSED = {2: "CCITT modified Huffman RLE", 3: "CCITT Group 3 fax",
                 4: "CCITT Group 4 fax", 6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
                 32809: "ThunderScan", 34925: "LZMA", 50000: "Zstd", 50001: "WebP"}
#: IFD field types: struct code and size
_TIFF_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1),
               8: ("h", 2), 9: ("i", 4), 16: ("Q", 8)}


@dataclass
class TiffInfo:
    width: int
    height: int
    bits: int
    samples: int
    photometric: int
    compression: int
    predictor: int
    rows_per_strip: int
    strips: List[Tuple[int, int]]  # (offset, byte count)
    extra: Tuple[int, ...] = ()
    colormap: Optional[np.ndarray] = None  # (3, 2**bits) uint16


def parse_tiff(data: bytes) -> TiffInfo:
    """The first image file directory's fields that the decoder reads."""
    order = {b"II": "<", b"MM": ">"}[data[:2]]
    magic, ifd = struct.unpack(order + "HI", data[2:8])
    if magic != 42:
        raise UnsupportedImage(f"TIFF: version {magic} (BigTIFF is 43) is not decoded")
    if ifd + 2 > len(data):
        raise UnsupportedImage("TIFF: the image file directory lies past the end")
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags: Dict[int, list] = {}
    for i in range(n):
        entry = data[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            raise UnsupportedImage("TIFF: the image file directory is truncated")
        tag, kind, count = struct.unpack(order + "HHI", entry[:8])
        if kind not in _TIFF_TYPES:
            continue  # rationals and the like: nothing the decoder reads
        code, size = _TIFF_TYPES[kind]
        if size * count <= 4:
            raw = entry[8:8 + size * count]
        else:
            (off,) = struct.unpack(order + "I", entry[8:12])
            raw = data[off:off + size * count]
            if len(raw) < size * count:
                raise UnsupportedImage(f"TIFF: the values of tag {tag} lie past the end")
        tags[tag] = list(struct.unpack(f"{order}{count}{code}", raw))

    def one(tag, default=None):
        if tag not in tags:
            if default is None:
                raise UnsupportedImage(f"TIFF: no tag {tag}")
            return default
        return int(tags[tag][0])

    if 322 in tags or 324 in tags:
        raise UnsupportedImage("TIFF: tiled images are not decoded")
    compression = one(259, 1)
    if compression in _TIFF_REFUSED:
        raise UnsupportedImage(f"TIFF: {_TIFF_REFUSED[compression]} compression is not decoded")
    if compression not in TIFF_COMPRESSIONS:
        raise UnsupportedImage(f"TIFF: compression {compression} is not decoded")
    if one(284, 1) != 1:
        raise UnsupportedImage("TIFF: planar configuration 2 (separate planes) is not decoded")
    if one(266, 1) != 1:
        raise UnsupportedImage("TIFF: fill order 2 (least significant bit first) is not "
                               "decoded")
    if any(int(f) != 1 for f in tags.get(339, [1])):
        raise UnsupportedImage(f"TIFF: sample format {tags[339]} is not decoded")
    samples = one(277, 1)
    bits = sorted(set(int(b) for b in tags.get(258, [1])))
    if len(bits) != 1:
        raise UnsupportedImage(f"TIFF: mixed bits per sample {tags[258]}")
    width, height = one(256), one(257)
    rows_per_strip = min(one(278, 2 ** 32 - 1), height)
    offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise UnsupportedImage("TIFF: no strips (StripOffsets and StripByteCounts)")
    colormap = None
    if 320 in tags:
        colormap = np.asarray(tags[320], np.uint16).reshape(3, -1)
    info = TiffInfo(width, height, bits[0], samples, one(262), compression, one(317, 1),
                    rows_per_strip, list(zip(offsets, counts)),
                    tuple(int(e) for e in tags.get(338, ())), colormap)
    _tiff_mode(info)
    return info


def _tiff_mode(info: TiffInfo) -> str:
    """PIL's mode of the image: 1, L, LA, RGB, RGBA or P; raises on
    another layout."""
    p, spp, bits, extra = info.photometric, info.samples, info.bits, info.extra
    if extra and any(e == 1 for e in extra):
        raise UnsupportedImage("TIFF: associated (premultiplied) alpha is not decoded")
    if p in (0, 1) and spp == 1 and bits in (1, 8):
        mode = "1" if bits == 1 else "L"
    elif p == 1 and spp == 2 and bits == 8:
        mode = "LA"
    elif p == 2 and spp in (3, 4) and bits == 8:
        mode = "RGB" if spp == 3 else "RGBA"
    elif p == 3 and spp == 1 and bits == 8:
        if info.colormap is None or info.colormap.shape[1] != 256:
            raise UnsupportedImage("TIFF: palette image without a 256-entry colour map")
        mode = "P"
    else:
        raise UnsupportedImage(f"TIFF: photometric {p} with {spp} samples of {bits} bits is "
                               f"not decoded")
    if info.predictor not in (1, 2) or (info.predictor == 2 and bits != 8):
        raise UnsupportedImage(f"TIFF: predictor {info.predictor} with {bits}-bit samples")
    return mode


def packbits_decode_plain(data: bytes, size: int) -> bytes:
    """PackBits (TIFF 6.0 section 9): a header byte n, then n + 1 literal
    bytes (0 <= n <= 127) or one byte repeated 1 - n times (-127 <= n <=
    -1); -128 is skipped. Stops at ``size`` bytes."""
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if n >= 0:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n != -128:
            out += data[pos:pos + 1] * (1 - n)
            pos += 1
    return bytes(out[:size])


def lzw_decode_plain(data: bytes, size: int) -> bytes:
    """TIFF's LZW (TIFF 6.0 section 13): codes of 9 to 12 bits, most
    significant bit first; 256 clears the table, 257 ends; the width grows
    one code early (at 511, 1023 and 2047 entries). Stops at ``size``
    bytes."""
    out = bytearray()
    bitbuf = nbits_in = pos = 0
    width, table, prev = 9, [bytes([i]) for i in range(256)] + [b"", b""], None
    while len(out) < size:
        while nbits_in < width and pos < len(data):
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits_in += 8
        if nbits_in < width:
            break
        nbits_in -= width
        code = (bitbuf >> nbits_in) & ((1 << width) - 1)
        if code == 257:
            break
        if code == 256:
            width, table, prev = 9, table[:258], None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(table[prev] + entry[:1])
        elif prev is not None and code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise UnsupportedImage(f"TIFF: LZW code {code} beyond the table")
        out += entry
        prev = code
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:size])


def _tiff_stride(info: TiffInfo) -> int:
    return (info.width * info.samples * info.bits + 7) // 8


def _tiff_strip(data: bytes, info: TiffInfo, offset: int, count: int, size: int,
                native: bool) -> bytes:
    body = data[offset:offset + count]
    if info.compression == 1:
        return body
    if info.compression in (8, 32946):
        return zlib.decompress(body)
    if native:
        from ..runtime import native as nat

        return (nat.tiff_lzw(body, size) if info.compression == 5
                else nat.tiff_packbits(body, size))
    return (lzw_decode_plain(body, size) if info.compression == 5
            else packbits_decode_plain(body, size))


def decode_tiff(data: bytes, native: bool = True) -> np.ndarray:
    info = parse_tiff(data)
    mode = _tiff_mode(info)
    stride = _tiff_stride(info)
    rows = []
    for i, (offset, count) in enumerate(info.strips):
        n = min(info.rows_per_strip, info.height - i * info.rows_per_strip)
        if n <= 0:
            break
        strip = _tiff_strip(data, info, offset, count, n * stride, native)
        if len(strip) < n * stride:
            raise UnsupportedImage(f"TIFF: strip {i} holds {len(strip)} bytes, not "
                                   f"{n * stride}")
        strip = np.frombuffer(strip, np.uint8, count=n * stride).reshape(n, stride)
        if info.predictor == 2:
            # horizontal differencing: each sample adds the one a pixel left
            wide = strip.reshape(n, info.width, info.samples).astype(np.int64)
            strip = (np.cumsum(wide, axis=1) & 255).astype(np.uint8).reshape(n, stride)
        rows.append(strip)
    if sum(len(r) for r in rows) < info.height:
        raise UnsupportedImage("TIFF: fewer strips than rows")
    rows = np.concatenate(rows)
    h, w = info.height, info.width
    if mode == "1":
        bits = np.unpackbits(rows, axis=1)[:, :w]
        gray = (bits * 255).astype(np.uint8)
        gray = 255 - gray if info.photometric == 0 else gray
        return np.repeat(gray[..., None], 3, axis=2)
    pixels = rows.reshape(h, w, info.samples)
    if mode == "P":
        palette = (info.colormap // 256).astype(np.uint8).T  # (256, 3)
        return palette[pixels[..., 0]]
    if mode in ("L", "LA"):
        gray = pixels[..., 0]
        gray = 255 - gray if info.photometric == 0 else gray
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])
