"""The image forms the port decodes beyond 8-bit PNG and baseline JPEG
(dtlr_tpu_torch/data/images.py) against PIL's ``convert("RGB")``, which
the JAX package's loaders use, bit for bit through the native runtime
and through the numpy versions:

- progressive JPEG as PIL's libjpeg-turbo writes it (its scan script:
  spectral selection, DC and AC successive approximation with
  refinement scans, end-of-band runs): gray and RGB, 4:4:4, 4:2:2 and
  4:2:0, qualities 10-100, sizes from 1x1 to 72x741, optimized tables,
  restart markers; so libjpeg-turbo's block smoothing has nothing to do
  on a complete file; lossless and hierarchical frames still raise;
- PNG with 16-bit samples (gray, gray with alpha, RGB, RGBA) and
  Adam7-interlaced PNG at every depth and colour type, on files written
  here with zlib and struct (PIL writes neither), mixed row filters,
  sizes whose small passes are empty;
- TIFF as PIL writes it: bilevel, gray, gray with alpha, RGB, RGBA and
  palette images, uncompressed, PackBits, LZW (with and without the
  horizontal predictor) and Deflate, in one strip or many; the same
  files with the big-endian byte order (``MM``) and with white as zero;
  CCITT and JPEG-in-TIFF refused by name;
- the native LZW and PackBits expanders against their numpy versions on
  strips of random data;
- ``load_image`` on a ``.tif`` is the JAX package's ``_load_image``.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dtlr_tpu_torch.data import images as I
from dtlr_tpu_torch.runtime import native
from test_torch_images import assert_decodes, chunk, filtered, picture, saved


def png_bytes(samples: np.ndarray, depth: int, color_type: int, channels: int,
              interlace: int, seed: int) -> bytes:
    """A PNG of ``samples`` (h, w, channels) at ``depth``, each row under a
    seeded filter type, plain or Adam7 (each pass a small image)."""
    h, w = samples.shape[:2]
    rng = np.random.default_rng(seed)

    def pack(img):
        if depth == 16:
            rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        elif depth == 8:
            rows = img.astype(np.uint8).reshape(img.shape[0], -1)
        else:
            bits = np.unpackbits(img.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
            rows = np.packbits(bits.reshape(img.shape[0], -1), axis=1)
        bpp = max(1, channels * depth // 8)
        return filtered(rows, bpp, rng.integers(0, 5, rows.shape[0]))

    if interlace:
        raw = b"".join(pack(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in I.ADAM7
                       if x0 < w and y0 < h)
    else:
        raw = pack(samples)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    plte = (chunk(b"PLTE", rng.integers(0, 256, 3 * 256, dtype=np.uint8).tobytes())
            if color_type == 3 else b"")
    return (I.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + plte + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


PNG_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: (depth, colour type, interlace): every pair Adam7, and 16 bits plain
#: (8 bits and fewer plain: test_torch_images.py)
PNG_CASES = [(d, t, 1) for d, t in [(16, 0), (16, 2), (16, 4), (16, 6), (8, 0), (8, 2),
                                     (8, 3), (8, 4), (8, 6)] + [
    (d, t) for d in (1, 2, 4) for t in (0, 3)]] + [(16, t, 0) for t in (0, 2, 4, 6)]


@pytest.mark.parametrize("depth,color_type,interlace", PNG_CASES)
def test_png_depths_and_interlacing(depth, color_type, interlace):
    rng = np.random.default_rng(depth * 10 + color_type)
    for w, h in ((1, 1), (3, 2), (5, 9), (8, 8), (19, 11)):
        top = (1 << depth) - 1
        samples = rng.integers(0, top + 1, (h, w, PNG_TYPES[color_type]))
        if depth == 16 and color_type == 0:
            samples[0, 0, 0], samples[-1, -1, 0] = 200, 300  # either side of the clip
        assert_decodes(png_bytes(samples, depth, color_type, PNG_TYPES[color_type],
                                 interlace, seed=w * h))


JPEG_CASES = [(1, 1, "RGB", 2, 75, {}), (8, 8, "RGB", 0, 95, {}), (37, 11, "L", 0, 10, {}),
              (64, 33, "RGB", 1, 90, {}), (741, 72, "RGB", 2, 85, {}),
              (233, 71, "RGB", 2, 30, {"optimize": True}),
              (233, 71, "RGB", 0, 80, {"restart_marker_blocks": 3}),
              (57, 40, "L", 0, 100, {"restart_marker_rows": 1})]


@pytest.mark.parametrize("case", range(len(JPEG_CASES)))
def test_progressive_jpeg(case):
    w, h, mode, subsampling, quality, kw = JPEG_CASES[case]
    data = saved(Image.fromarray(picture(w, h, seed=case)).convert(mode), "JPEG",
                 quality=quality, subsampling=subsampling, progressive=True, **kw)
    info = I.parse_jpeg(data)
    assert info.progressive
    assert any(s.ah for s in info.scans if s.ss == 0) and any(s.ah for s in info.scans
                                                               if s.ss > 0)
    assert_decodes(data)


@pytest.mark.parametrize("marker,name", [(0xC3, "lossless"), (0xC5, "hierarchical"),
                                         (0xCA, "arithmetic")])
def test_other_jpeg_processes_raise(marker, name):
    data = bytearray(saved(Image.fromarray(picture(16, 8)), "JPEG", progressive=True))
    data[data.index(b"\xff\xc2") + 1] = marker
    with pytest.raises(I.UnsupportedImage, match=name):
        I.decode_image(bytes(data))


TIFF_MODES = ("1", "L", "LA", "RGB", "RGBA", "P")
TIFF_COMPRESSIONS = (None, "packbits", "tiff_lzw", "tiff_adobe_deflate")


def tiff_image(mode: str, w: int, h: int, seed: int) -> Image.Image:
    im = Image.fromarray(picture(w, h, seed))
    return im.quantize(180) if mode == "P" else im.convert(mode)


def tiff_bytes(mode, compression, rows_per_strip=None, predictor=False, seed=0):
    kw = {} if compression is None else {"compression": compression}
    tags = {}
    if rows_per_strip:
        tags[278] = rows_per_strip
    if predictor:
        tags[317] = 2
    return saved(tiff_image(mode, 37, 13, seed), "TIFF", tiffinfo=tags, **kw)


def with_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with one SHORT tag's value replaced."""
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            out[at + 8:at + 10] = struct.pack("<H", value)
            return bytes(out)
    raise KeyError(tag)


def big_endian(data: bytes) -> bytes:
    """The same little-endian TIFF rewritten in the Motorola byte order:
    the header and every field of the first directory swapped, the strips'
    bytes kept (samples of 8 bits or fewer read the same either way)."""
    out = bytearray(data)
    out[:8] = b"MM" + struct.pack(">HI", 42, struct.unpack("<I", data[4:8])[0])
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    out[ifd:ifd + 2] = struct.pack(">H", n)
    sizes = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 7: ("B", 1)}
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, kind, count = struct.unpack("<HHI", data[at:at + 8])
        out[at:at + 8] = struct.pack(">HHI", tag, kind, count)
        code, size = sizes[kind]
        count *= 2 if kind == 5 else 1
        if size * count <= 4:
            vals = struct.unpack(f"<{count}{code}", data[at + 8:at + 8 + size * count])
            out[at + 8:at + 8 + size * count] = struct.pack(f">{count}{code}", *vals)
        else:
            (off,) = struct.unpack("<I", data[at + 8:at + 12])
            out[at + 8:at + 12] = struct.pack(">I", off)
            vals = struct.unpack(f"<{count}{code}", data[off:off + size * count])
            out[off:off + size * count] = struct.pack(f">{count}{code}", *vals)
    (nxt,) = struct.unpack("<I", data[ifd + 2 + 12 * n:ifd + 6 + 12 * n])
    out[ifd + 2 + 12 * n:ifd + 6 + 12 * n] = struct.pack(">I", nxt)
    return bytes(out)


@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS, ids=lambda c: c or "raw")
@pytest.mark.parametrize("mode", TIFF_MODES)
def test_tiff_modes_and_compressions(mode, compression):
    for i, rps in enumerate((None, 4)):
        data = tiff_bytes(mode, compression, rps, seed=i)
        info = I.parse_tiff(data)
        assert len(info.strips) == (4 if rps else 1)
        assert_decodes(data)
        assert_decodes(big_endian(data))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
def test_tiff_horizontal_predictor(mode, compression):
    data = tiff_bytes(mode, compression, 5, predictor=True, seed=3)
    assert I.parse_tiff(data).predictor == 2
    assert_decodes(data)


@pytest.mark.parametrize("mode", ["1", "L"])
def test_tiff_white_is_zero(mode):
    data = with_tag(tiff_bytes(mode, "packbits", seed=4), 262, 0)
    assert I.parse_tiff(data).photometric == 0
    assert_decodes(data)


def test_tiff_refusals():
    im = Image.fromarray(picture(30, 20))
    for compression, name in (("group4", "CCITT Group 4 fax"), ("group3", "CCITT Group 3 fax"),
                              ("jpeg", "JPEG")):
        with pytest.raises(I.UnsupportedImage, match=f"{name} compression"):
            I.decode_image(saved(im.convert("1" if "group" in compression else "RGB"), "TIFF",
                                 compression=compression))
    planar = with_tag(saved(im, "TIFF"), 284, 2)
    with pytest.raises(I.UnsupportedImage, match="planar configuration 2"):
        I.decode_image(planar)


@pytest.mark.parametrize("kind", ["lzw", "packbits"])
def test_native_strip_expanders_equal_numpy(kind):
    rng = np.random.default_rng(8)
    for n in (1, 7, 700, 20000):
        raw = rng.integers(0, 4, n, dtype=np.uint8)  # runs and repeats for both coders
        raw[: n // 3] = rng.integers(0, 256, n // 3, dtype=np.uint8)
        im = Image.fromarray(raw.reshape(1, n))
        data = saved(im, "TIFF", compression="tiff_lzw" if kind == "lzw" else "packbits")
        info = I.parse_tiff(data)
        (off, count), = info.strips
        body = data[off:off + count]
        plain = (I.lzw_decode_plain if kind == "lzw" else I.packbits_decode_plain)(body, n)
        fast = (native.tiff_lzw if kind == "lzw" else native.tiff_packbits)(body, n)
        assert plain == fast == raw.tobytes()


def test_load_image_of_a_tif_is_jax_load_image(tmp_path):
    from dtlr_tpu.data.loaders import _load_image

    for name, mode, comp in (("a.tif", "L", "tiff_lzw"), ("b.tif", "RGB", "packbits"),
                             ("c.tif", "1", None)):
        kw = {} if comp is None else {"compression": comp}
        tiff_image(mode, 41, 12, 1).save(tmp_path / name, **kw)
        got, want = I.load_image(str(tmp_path / name)), _load_image(str(tmp_path / name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

