"""The port's image decoding (dtlr_tpu_torch/data/images.py) against PIL's
``Image.open(...).convert("RGB")``, which the JAX package's loaders use:
bit for bit, through the native runtime and through the numpy versions.

- PNG: every mode and bit depth PIL writes (1-bit, L, LA, P at 1, 2, 4
  and 8 bits, RGB, RGBA), 2- and 4-bit gray and each of the five row
  filters on files written here with zlib and struct; an undefined
  interlace method, a 16-bit palette and a bad CRC raise (16-bit and
  Adam7 files: test_torch_image_forms.py).
- Baseline JPEG written by PIL's libjpeg-turbo: gray and RGB, qualities
  10-100, subsampling 4:4:4, 4:2:2 and 4:2:0, sizes from 1x1 to 72x741,
  optimized Huffman tables, restart markers, RGB without the colour
  transform, and h1v2 and 4x1 sampling (a 4:2:2 or 4:2:0 file's frame
  header rewritten, the MCU count unchanged); an incomplete progressive
  file, CMYK and arithmetic-coded files raise, and so does a
  CCITT-compressed TIFF (progressive JPEG and TIFF:
  test_torch_image_forms.py).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dtlr_tpu_torch.data import images as I

DECODERS = {"native": True, "numpy": False}


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def picture(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Smooth strokes over noise: what a text line's JPEG has to carry."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    x = np.stack([128 + 100 * np.sin(xx / 5.0 + yy / 7.0), 128 + 80 * np.cos(xx / 3.0),
                  rng.integers(0, 256, (h, w))], -1)
    return np.clip(x, 0, 255).astype(np.uint8)


def saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def assert_decodes(data: bytes):
    want = pil_rgb(data)
    for name, use_native in DECODERS.items():
        got = I.decode_image(data, native=use_native)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------------- PNG

def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def filtered(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Each row (uint8) under its filter type, with the filter byte."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows.astype(np.int64), kinds):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (a + prior) >> 1
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def png_file(rows: np.ndarray, w: int, depth: int, color_type: int, bpp: int, kinds,
             interlace: int = 0, extra: bytes = b"") -> bytes:
    ihdr = struct.pack(">IIBBBBB", w, rows.shape[0], depth, color_type, 0, 0, interlace)
    return (I.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(filtered(rows, bpp, kinds))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "P1", "P2", "P4", "RGB", "RGBA"])
def test_png_modes_written_by_pil(mode):
    im = Image.fromarray(picture(37, 11))
    if mode.startswith("P"):
        bits = int(mode[1:] or 8)
        data = saved(im.convert("P", palette=Image.Palette.ADAPTIVE, colors=2 ** bits), "PNG",
                     bits=bits)
    else:
        data = saved(im.convert(mode), "PNG")
    assert_decodes(data)


@pytest.mark.parametrize("kind", range(5))
def test_png_each_filter_type(kind):
    rgb = picture(23, 9, seed=kind)
    rows = rgb.reshape(9, -1)
    assert_decodes(png_file(rows, 23, 8, 2, 3, [kind] * 9))
    rgba = np.concatenate([rgb, rgb[..., :1]], -1).reshape(9, -1)  # 4 bytes a pixel
    assert_decodes(png_file(rgba, 23, 8, 6, 4, [kind] * 9))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_low_depth_gray_mixed_filters(depth):
    w, h = 29, 7
    rng = np.random.default_rng(depth)
    samples = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
    packed = np.packbits(np.unpackbits(samples[..., None], axis=-1)[..., 8 - depth:]
                         .reshape(h, -1), axis=1)
    assert_decodes(png_file(packed, w, depth, 0, 1, [0, 1, 2, 3, 4, 4, 3]))


def test_png_refusals():
    rows = picture(5, 4).reshape(4, -1)
    with pytest.raises(I.UnsupportedImage, match="interlace method 2"):
        I.decode_image(png_file(rows, 5, 8, 2, 3, [0] * 4, interlace=2))
    palette16 = png_file(rows, 5, 16, 3, 2, [0] * 4, extra=chunk(b"PLTE", bytes(range(48))))
    with pytest.raises(I.UnsupportedImage, match="bit depth 16 with colour type 3"):
        I.decode_image(palette16)
    good = png_file(rows, 5, 8, 2, 3, [0] * 4)
    bad = bytearray(good)
    bad[len(I.PNG_SIGNATURE) + 8 + 13] ^= 1  # a byte of IHDR's CRC
    with pytest.raises(I.UnsupportedImage, match="CRC"):
        I.decode_image(bytes(bad))
    with pytest.raises(I.UnsupportedImage, match="filter type 9"):
        I.decode_image(png_raw_filter(rows, 9))


def png_raw_filter(rows: np.ndarray, kind: int) -> bytes:
    raw = b"".join(bytes([kind]) + r.tobytes() for r in rows)
    ihdr = struct.pack(">IIBBBBB", rows.shape[1] // 3, rows.shape[0], 8, 2, 0, 0, 0)
    return (I.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------------ JPEG

SIZES = [(1, 1), (7, 13), (17, 33), (72, 741)]


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_jpeg_qualities_subsampling_sizes(mode, quality):
    for subsampling in (0, 1, 2):
        for w, h in SIZES:
            im = Image.fromarray(picture(w, h, seed=w)).convert(mode)
            assert_decodes(saved(im, "JPEG", quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_optimized_tables_and_restart_markers(mode):
    for w, h in [(7, 13), (72, 741)]:
        im = Image.fromarray(picture(w, h, seed=3)).convert(mode)
        for kw in ({"optimize": True}, {"restart_marker_blocks": 3},
                   {"restart_marker_rows": 1}, {"optimize": True, "restart_marker_blocks": 1}):
            for subsampling in (0, 2):
                data = saved(im, "JPEG", quality=80, subsampling=subsampling, **kw)
                assert (b"\xff\xdd" in data) == any(k.startswith("restart") for k in kw)
                assert_decodes(data)


def test_jpeg_rgb_without_colour_transform():
    data = saved(Image.fromarray(picture(40, 24)), "JPEG", quality=90, keep_rgb=True)
    assert I.parse_jpeg(data).transform == I.RGB
    assert_decodes(data)


def rewrite_luma_sampling(data: bytes, factors: int) -> bytes:
    """The frame header's first component's sampling byte replaced."""
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[sof + 2 + 2 + 6 + 1] = factors  # length, precision/size, count, id
    return bytes(out)


@pytest.mark.parametrize("subsampling,factors,size", [(1, 0x12, (32, 32)), (2, 0x41, (32, 16))])
def test_jpeg_other_sampling_factors(subsampling, factors, size):
    """h1v2 (fancy, vertical) and 4x1 (replication) on the chroma."""
    data = saved(Image.fromarray(picture(*size, seed=5)), "JPEG", quality=85,
                 subsampling=subsampling)
    data = rewrite_luma_sampling(data, factors)
    info = I.parse_jpeg(data)
    assert info.sampling[0].tolist() == [factors >> 4, factors & 15]
    assert_decodes(data)


def test_jpeg_and_tiff_refusals():
    im = Image.fromarray(picture(30, 20))
    progressive = saved(im, "JPEG", progressive=True)
    cut = I.parse_jpeg(progressive).scans[5].start  # the first five scans, then EOI
    incomplete = progressive[:progressive.rindex(b"\xff\xda", 0, cut)] + b"\xff\xd9"
    with pytest.raises(I.UnsupportedImage, match="incomplete"):
        I.decode_image(incomplete)
    with pytest.raises(I.UnsupportedImage, match="CMYK"):
        I.decode_image(saved(im.convert("CMYK"), "JPEG"))
    arithmetic = bytearray(saved(im, "JPEG"))
    arithmetic[arithmetic.index(b"\xff\xc0") + 1] = 0xC9
    with pytest.raises(I.UnsupportedImage, match="arithmetic"):
        I.decode_image(bytes(arithmetic))
    twelve = bytearray(saved(im, "JPEG"))
    twelve[twelve.index(b"\xff\xc0") + 4] = 12
    with pytest.raises(I.UnsupportedImage, match="12-bit"):
        I.decode_image(bytes(twelve))
    with pytest.raises(I.UnsupportedImage, match="CCITT Group 4 fax compression"):
        I.decode_image(saved(im.convert("1"), "TIFF", compression="group4"))
    with pytest.raises(I.UnsupportedImage, match="not a PNG, JPEG or TIFF"):
        I.decode_image(b"GIF89a....")


def test_load_image_is_jax_load_image(tmp_path):
    """``load_image`` is the JAX package's ``_load_image``: float32 / 255."""
    from dtlr_tpu.data.loaders import _load_image

    for name, im in (("a.png", Image.fromarray(picture(31, 9)).convert("LA")),
                     ("b.jpg", Image.fromarray(picture(31, 9)))):
        im.save(tmp_path / name)
        got, want = I.load_image(str(tmp_path / name)), _load_image(str(tmp_path / name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    (tmp_path / "c.jpg").write_bytes(saved(Image.fromarray(picture(8, 8)), "JPEG",
                                           progressive=True))
    got, want = I.load_image(str(tmp_path / "c.jpg")), _load_image(str(tmp_path / "c.jpg"))
    np.testing.assert_array_equal(got, want)
    (tmp_path / "d.jpg").write_bytes(saved(Image.fromarray(picture(8, 8)).convert("CMYK"),
                                           "JPEG"))
    with pytest.raises(I.UnsupportedImage, match="d.jpg: JPEG: 4-component"):
        I.load_image(str(tmp_path / "d.jpg"))
