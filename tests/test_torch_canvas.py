"""The canvas (dtlr_tpu_torch/data/canvas.py) against the JAX package's
(dtlr_tpu/data/canvas.py) with the same rng, and PIL's drawing and
compositing operations it uses (dtlr_tpu_torch/data/pil_draw.py, the
blur and resize of data/transforms.py) against PIL, bit for bit:

- ``generate_background`` at several sizes; the shared background pool
  built by whichever generator samples first (procedural, and from a
  directory of PNG and baseline-JPEG files: ``_load_background_image``'s
  resize, hue blend, flip and blur); ``pooled_background``'s crops,
  resizes (one axis growing, the other shrinking), flips and brightness;
- ``add_noise_patterns`` (stains, holes, streaks of widths 1-3, the RGBA
  blur, the composite) and ``compose_canvas``, the rng left where JAX's
  is; a line too small for a radius raises ``CanvasTooSmall`` where JAX's
  numpy raises ``ValueError``;
- ``ImageDraw.ellipse`` with float bounds, ``ImageDraw.line`` of widths
  1-3, ``Image.alpha_composite``, ``convert("L")``, ``GaussianBlur`` on
  RGB and RGBA and the bilinear resize against PIL;
- the native runtime's resampling pass, box-blur pass and composite
  against their plain versions.
"""

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFilter

from dtlr_tpu.data import canvas as JC
from dtlr_tpu_torch.data import canvas as TC
from dtlr_tpu_torch.data import pil_draw as P
from dtlr_tpu_torch.data.transforms import pil_gaussian_blur, pil_resize
from test_torch_synth_fixture import SYNTH

BACKGROUNDS = SYNTH + "/backgrounds"


@pytest.fixture(autouse=True, scope="module")
def empty_pools_after():
    """The pools are module state of each package: leave them empty for
    the next test module in this process."""
    yield
    TC.set_background_dir(None)
    JC.set_background_dir(None)


def rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def assert_same_rng(a, b):
    assert a.random() == b.random()


@pytest.mark.parametrize("w,h", [(768, 448), (130, 40), (57, 91)])
def test_generate_background(w, h):
    a, b = rngs(w)
    for _ in range(3):
        np.testing.assert_array_equal(TC.generate_background(a, w, h),
                                      np.asarray(JC.generate_background(b, w, h)))
    assert_same_rng(a, b)


_POOLS = {}


def install_pools(bg_dir):
    """Both packages' pools of ``bg_dir`` (None: procedural), built once
    per module by ``_build_pool`` from one seed and checked equal, put in
    place; returns them."""
    if bg_dir not in _POOLS:
        TC.set_background_dir(bg_dir)
        JC.set_background_dir(bg_dir)
        a, b = rngs(31)
        TC._build_pool(a)
        JC._build_pool(b)
        assert_same_rng(a, b)
        assert len(TC._BG_POOL) == len(JC._BG_POOL) == 48
        for g, w in zip(TC._BG_POOL, JC._BG_POOL):
            np.testing.assert_array_equal(g, np.asarray(w))
        _POOLS[bg_dir] = (list(TC._BG_POOL), list(JC._BG_POOL))
    TC.set_background_dir(bg_dir)
    JC.set_background_dir(bg_dir)
    TC._BG_POOL[:], JC._BG_POOL[:] = _POOLS[bg_dir]
    return _POOLS[bg_dir]


@pytest.mark.parametrize("bg_dir", [None, BACKGROUNDS])
def test_pool_and_pooled_backgrounds(bg_dir):
    install_pools(bg_dir)
    a, b = rngs(32)
    sizes = [(300, 60), (900, 80), (700, 500), (768, 448), (40, 30), (769, 100)]
    for w, h in sizes * 2:
        got, want = TC.pooled_background(a, w, h), np.asarray(JC.pooled_background(b, w, h))
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")
    assert_same_rng(a, b)


def test_noise_patterns_and_compose():
    install_pools(None)
    a, b = rngs(77)
    for i in range(24):
        w, h = int(a.integers(62, 900)), int(a.integers(40, 120))
        assert (w, h) == (int(b.integers(62, 900)), int(b.integers(40, 120)))
        img = np.asarray(JC.generate_background(np.random.default_rng(i), w, h))
        np.testing.assert_array_equal(TC.add_noise_patterns(a, img),
                                      np.asarray(JC.add_noise_patterns(b, Image.fromarray(img))))
        layer = np.zeros((h, w, 4), np.uint8)
        layer[h // 4:h // 2, w // 5:w // 2] = (20, 30, 40, 200)
        layer[h // 3:, w // 3:, 3] = np.arange(w - w // 3, dtype=np.uint8)[None] * 3
        got = TC.compose_canvas(a, layer)
        want = np.asarray(JC.compose_canvas(b, Image.fromarray(layer, "RGBA")))
        np.testing.assert_array_equal(got, want)
    assert_same_rng(a, b)


def test_small_lines_raise_where_jax_numpy_does():
    """A stain on a line under 62.5 pixels wide, a hole on one under 40
    high: JAX's numpy refuses the radius range before drawing; the port
    raises ``CanvasTooSmall`` there, the rng at the same state."""
    raised = 0
    for seed in range(40):
        a, b = rngs(seed)
        img = np.full((30, 50, 3), 200, np.uint8)
        try:
            JC.add_noise_patterns(b, Image.fromarray(img))
            jax_error = False
        except ValueError:
            jax_error = True
        if jax_error:
            with pytest.raises(TC.CanvasTooSmall):
                TC.add_noise_patterns(a, img)
            raised += 1
        else:
            TC.add_noise_patterns(a, img)
        assert_same_rng(a, b)
    assert raised > 0


def test_ellipses_lines_and_composites_against_pil():
    rng = np.random.default_rng(5)
    for it in range(300):
        w, h = int(rng.integers(20, 700)), int(rng.integers(20, 120))
        im = Image.new("RGBA", (w, h), (0, 0, 0, 0))
        draw = ImageDraw.Draw(im)
        got = np.zeros((h, w, 4), np.uint8)
        ink = tuple(int(v) for v in rng.integers(0, 256, 4))
        cx, cy = rng.uniform(-10, w + 10), rng.uniform(-10, h + 10)
        if it % 2:
            rx, ry = rng.uniform(0, w * 0.1), rng.uniform(0, h * 0.5)
            draw.ellipse([cx - rx, cy - ry, cx + rx, cy + ry], fill=ink)
            P.ellipse(got, [cx - rx, cy - ry, cx + rx, cy + ry], ink)
        else:
            x2, y2 = cx + rng.uniform(-w * 0.3, w * 0.3), cy + rng.uniform(-10, 10)
            if it % 10 == 0:
                y2 = cy + rng.uniform(-80, 80)
            width = int(rng.integers(1, 4))
            draw.line([cx, cy, x2, y2], fill=ink, width=width)
            P.line(got, [cx, cy, x2, y2], ink, width=width)
        np.testing.assert_array_equal(got, np.asarray(im), err_msg=str(it))
    for _ in range(20):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 90))
        dst, src = (rng.integers(0, 256, (h, w, 4)).astype(np.uint8) for _ in range(2))
        src[..., 3][rng.random((h, w)) < 0.3] = 0
        dst[..., 3][rng.random((h, w)) < 0.3] = 0
        want = np.asarray(Image.alpha_composite(Image.fromarray(dst, "RGBA"),
                                                Image.fromarray(src, "RGBA")))
        np.testing.assert_array_equal(P.alpha_composite(dst, src), want)
        np.testing.assert_array_equal(P.alpha_composite_plain(dst, src), want)
        rgb = dst[..., :3].copy()
        np.testing.assert_array_equal(P.rgb_to_l(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


@pytest.mark.parametrize("native", [True, False])
def test_blur_and_resize_against_pil(native):
    rng = np.random.default_rng(12 + native)
    for _ in range(12):
        h, w = int(rng.integers(2, 90)), int(rng.integers(2, 300))
        for c, mode in ((3, "RGB"), (4, "RGBA")):
            img = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
            r = float(rng.uniform(0.1, 2.0))
            want = np.asarray(Image.fromarray(img, mode).filter(ImageFilter.GaussianBlur(r)))
            np.testing.assert_array_equal(pil_gaussian_blur(img, r, native=native), want)
        oh, ow = int(rng.integers(2, 300)), int(rng.integers(2, 800))
        want = np.asarray(Image.fromarray(img[..., :3]).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(pil_resize(img[..., :3], oh, ow, "bilinear", native=native),
                                      want)


def test_native_passes_equal_plain():
    rng = np.random.default_rng(3)
    for _ in range(20):
        h, w, c = int(rng.integers(1, 50)), int(rng.integers(1, 120)), int(rng.choice([1, 3, 4]))
        img = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        r = float(rng.uniform(0.05, 4.0))
        np.testing.assert_array_equal(pil_gaussian_blur(img, r),
                                      pil_gaussian_blur(img, r, native=False))
        oh, ow = int(rng.integers(1, 100)), int(rng.integers(1, 200))
        for kind in ("bilinear", "bicubic"):
            np.testing.assert_array_equal(pil_resize(img, oh, ow, kind),
                                          pil_resize(img, oh, ow, kind, native=False))
