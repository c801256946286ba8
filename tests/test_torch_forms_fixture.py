"""The image-form fixture of chip_smoke.py's ``datasets`` phase
(dtlr_tpu_torch/assets/smoke_forms/), written by ``make_forms_fixture``
with PIL and the JAX package from the lines of assets/smoke_words.npz
(cropped to their valid sizes):

- a Borg layout: ``old_cipher/labels_Borg.pkl`` with the flagship's
  65-character charset and lines 0-7 as its ``test`` split, their images
  ``old_cipher/Borgimages/bNN.tif`` in eight TIFF forms (gray LZW, gray
  LZW with the horizontal predictor, RGB Deflate, RGB PackBits, RGBA
  uncompressed in strips of 16 rows, palette LZW, gray Deflate with the
  predictor, RGB LZW);
- ``forms/``: lines 8-15 as a progressive RGB 4:2:0 JPEG, a progressive
  gray JPEG, an Adam7 RGB PNG, an Adam7 palette PNG, a 16-bit RGB PNG,
  a 16-bit gray PNG, a big-endian LZW RGB TIFF and a bilevel PackBits
  TIFF;
- ``smoke_forms_ref.json``: per file the sha256 of PIL's
  ``convert("RGB")`` pixels, and the JAX package's evaluate strings on the
  Borg layout's ``test`` split (its ``build_dataset``, its batcher as its
  evaluate builds it, its forward with ``artifacts/r4ft_params.npz`` and
  the flagship's config) in float32 and bfloat16.

Rebuild from the repository root (needs JAX and PIL; about two minutes
on the CPU):

    PYTHONPATH=.:tests python tests/test_torch_forms_fixture.py

The fast tests hold the port's decoders (native and numpy) and its Borg
loader to the recorded hashes; the slow one rebuilds and compares.
"""

import io
import json
import os
import pickle
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase's paths)
from test_torch_datasets_fixture import jax_eval_strings, sha256  # noqa: E402

ROOT = chip_smoke.FORMS_ROOT
REF = chip_smoke.FORMS_REF
N_BORG = 8
#: the Borg lines' TIFF forms: (PIL mode, save options)
BORG_FORMS = [("L", {"compression": "tiff_lzw"}),
              ("L", {"compression": "tiff_lzw", "tiffinfo": {317: 2}}),
              ("RGB", {"compression": "tiff_adobe_deflate"}),
              ("RGB", {"compression": "packbits"}),
              ("RGBA", {"tiffinfo": {278: 16}}),
              ("P", {"compression": "tiff_lzw"}),
              ("L", {"compression": "tiff_adobe_deflate", "tiffinfo": {317: 2}}),
              ("RGB", {"compression": "tiff_lzw"})]
#: forms/: (file name, how it is written)
FORMS = ["progressive_rgb_420.jpg", "progressive_gray.jpg", "adam7_rgb.png",
         "adam7_palette.png", "rgb16.png", "gray16.png", "big_endian_lzw.tif",
         "bilevel_packbits.tif"]


def borg_id(i: int) -> str:
    return f"b{i:02d}"


def files():
    """Every written image, relative to the root."""
    return ([os.path.join("old_cipher", "Borgimages", borg_id(i) + ".tif")
             for i in range(N_BORG)] + [os.path.join("forms", f) for f in FORMS])


def _saved(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def form_bytes(name: str, line: np.ndarray) -> bytes:
    from PIL import Image

    from test_torch_image_forms import big_endian, png_bytes

    im = Image.fromarray(line)
    if name == "progressive_rgb_420.jpg":
        return _saved(im, "JPEG", quality=85, subsampling=2, progressive=True)
    if name == "progressive_gray.jpg":
        return _saved(im.convert("L"), "JPEG", quality=90, progressive=True)
    if name == "adam7_rgb.png":
        return png_bytes(line.astype(np.int64), 8, 2, 3, 1, seed=1)
    if name == "adam7_palette.png":
        pal = im.quantize(64)
        data = png_bytes(np.asarray(pal)[..., None].astype(np.int64), 8, 3, 1, 1, seed=2)
        # the palette written by png_bytes is seeded; put the quantized one in
        return _with_palette(data, pal.getpalette()[:3 * 256])
    if name == "rgb16.png":
        return png_bytes(line.astype(np.int64) * 257 + 3, 16, 2, 3, 0, seed=3)
    if name == "gray16.png":
        return png_bytes(np.asarray(im.convert("L"))[..., None].astype(np.int64), 16, 0, 1, 1,
                         seed=4)
    if name == "big_endian_lzw.tif":
        return big_endian(_saved(im, "TIFF", compression="tiff_lzw", tiffinfo={278: 8}))
    if name == "bilevel_packbits.tif":
        return _saved(im.convert("1"), "TIFF", compression="packbits")
    raise KeyError(name)


def _with_palette(data: bytes, palette) -> bytes:
    from test_torch_images import chunk

    start = data.index(b"PLTE") - 4
    (length,) = np.frombuffer(data[start:start + 4], ">u4")
    body = bytes(np.asarray(palette + [0] * (768 - len(palette)), np.uint8))
    return data[:start] + chunk(b"PLTE", body) + data[start + 12 + int(length):]


def write_layout(root: str):
    """The Borg layout and the forms; returns the Borg texts."""
    from PIL import Image

    with np.load(chip_smoke.WORDS) as z:
        lines = [z["images"][i, :h, :w] for i, (h, w) in enumerate(z["valid_hw"])]
        texts = [str(t) for t in z["texts"]]
        charset = [str(c) for c in z["charset"]]
    labels = {"charset": charset, "ground_truth": {
        "test": [{"id": borg_id(i), "text": texts[i]} for i in range(N_BORG)]}}
    os.makedirs(os.path.join(root, "old_cipher", "Borgimages"), exist_ok=True)
    os.makedirs(os.path.join(root, "forms"), exist_ok=True)
    with open(os.path.join(root, "old_cipher", "labels_Borg.pkl"), "wb") as fh:
        pickle.dump(labels, fh, protocol=4)
    for i, (mode, kw) in enumerate(BORG_FORMS):
        im = Image.fromarray(lines[i])
        im = im.quantize(128) if mode == "P" else im.convert(mode)
        im.save(os.path.join(root, "old_cipher", "Borgimages", borg_id(i) + ".tif"), **kw)
    for k, name in enumerate(FORMS):
        with open(os.path.join(root, "forms", name), "wb") as fh:
            fh.write(form_bytes(name, lines[N_BORG + k]))
    return texts[:N_BORG]


def make_forms_fixture(root: str = ROOT, ref_path: str = REF) -> dict:
    import PIL
    import PIL.features
    from PIL import Image

    from dtlr_tpu.eval.metrics import corpus_cer

    texts = write_layout(root)
    pixels = {}
    for rel in files():
        with Image.open(os.path.join(root, rel)) as im:
            pixels[rel.replace(os.sep, "/")] = sha256(np.asarray(im.convert("RGB")))
    ref = {"pillow": PIL.__version__,
           "libjpeg_turbo": PIL.features.version_feature("libjpeg_turbo"),
           "libtiff": PIL.features.version_codec("libtiff"), "numpy": np.__version__,
           "pixels_sha256": pixels, "evaluate": {"borg": {"texts": texts}}}
    for dt in ("float32", "bfloat16"):
        strings, gts = jax_eval_strings(root, "borg", dt)
        assert gts == texts
        ref["evaluate"]["borg"][dt] = {"strings": strings, "cer_vs_texts": corpus_cer(strings,
                                                                                      gts)}
    with open(ref_path, "w") as fh:
        json.dump(ref, fh, indent=1, ensure_ascii=False)
    return ref


def load_ref() -> dict:
    with open(REF) as fh:
        return json.load(fh)


def test_fixture_is_small_and_complete():
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ROOT) for f in fs)
    assert total < 2 << 20, total
    ref = load_ref()
    assert sorted(ref["pixels_sha256"]) == sorted(r.replace(os.sep, "/") for r in files())
    for dt in ("float32", "bfloat16"):
        assert len(ref["evaluate"]["borg"][dt]["strings"]) == N_BORG


@pytest.mark.parametrize("native", [True, False])
def test_decoders_give_pils_pixels(native):
    from dtlr_tpu_torch.data.images import decode_image

    for rel, want in load_ref()["pixels_sha256"].items():
        with open(os.path.join(ROOT, rel), "rb") as fh:
            assert sha256(decode_image(fh.read(), native=native)) == want, rel


def test_borg_layout_loads_like_jax():
    from dtlr_tpu.data.loaders import build_dataset as jax_build
    from dtlr_tpu_torch.data.loaders import build_dataset

    port, jax = build_dataset("borg", "test", root=ROOT), jax_build("borg", "test", root=ROOT)
    assert len(port) == len(jax) == N_BORG and port.charset == jax.charset
    for i in range(N_BORG):
        np.testing.assert_array_equal(port[i]["image"], jax[i]["image"])
        np.testing.assert_array_equal(port[i]["labels"], jax.encode(jax.items[i]["text"]))


@pytest.mark.slow
def test_regenerates(tmp_path):
    root = str(tmp_path / "fixture")
    ref = make_forms_fixture(root, str(tmp_path / "ref.json"))
    assert ref == load_ref()
    for rel in files():
        with open(os.path.join(root, rel), "rb") as a, open(os.path.join(ROOT, rel), "rb") as b:
            assert a.read() == b.read(), rel


if __name__ == "__main__":
    make_forms_fixture()
    print(f"wrote {ROOT}")
