"""The rotation and Gaussian-blur augmentations of the port
(dtlr_tpu_torch/data/transforms.py) against PIL and the JAX package
(dtlr_tpu/data/transforms.py, which calls PIL), bit for bit: the
rotated pixels (``Image.rotate(angle, expand=True)``, its 16.16 fixed
point path and its float64 one), PIL's bicubic resize, the boxes' hulls,
the blur over a sweep of radii and sizes, and the pretraining batcher
with ``rotate_p = 0.5`` against JAX's."""

import numpy as np
import pytest
from PIL import Image, ImageFilter

from dtlr_tpu.data import transforms as JT
from dtlr_tpu_torch.data import transforms as T
from dtlr_tpu_torch.train.config import RECIPE_DETECTION
from test_torch_batching import assert_same_batches, cycle, recipe_kw, seeded_lines
from test_torch_transforms import native_helper  # noqa: F401 (JAX's resize helper, autouse)


def pil_rotated(img, angle):
    return np.asarray(Image.fromarray(img).rotate(angle, expand=True))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_rotate_gives_pil_pixels(mode):
    """Odd and even sizes, angles of +-1 to 30 degrees and the multiples
    of 90 that PIL transposes."""
    rng = np.random.default_rng(0 if mode == "RGB" else 1)
    angles = [90.0, 180.0, 270.0, 360.0, -90.0, 45.0] + [
        float(s * a) for s, a in zip(rng.choice([-1, 1], 24), rng.uniform(1, 30, 24))]
    for i, angle in enumerate(angles):
        h, w = int(rng.integers(3, 60)) | (i % 2), int(rng.integers(3, 200)) | (i % 2)
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = pil_rotated(img, angle)
        got = T.pil_rotate(img, angle)
        assert got.shape == want.shape, (h, w, angle)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} by {angle}")


def test_rotate_float_path_gives_pil_pixels():
    """A line whose rotated corners leave +-32768: PIL's float64 path."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 33001, 3), dtype=np.uint8)
    m, nw, nh = T._pil_rotation(33001, 2, 0.02)
    assert abs(nw * m[0] + m[2]) >= 32768  # the fixed point does not fit
    np.testing.assert_array_equal(T.pil_rotate(img, 0.02), pil_rotated(img, 0.02))


def test_bicubic_resize_gives_pil_pixels():
    rng = np.random.default_rng(3)
    for _ in range(12):
        h, w = int(rng.integers(2, 90)), int(rng.integers(2, 300))
        oh, ow = int(rng.integers(1, 120)), int(rng.integers(1, 300))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh)))  # bicubic by default
        np.testing.assert_array_equal(T.pil_resize(img, oh, ow, "bicubic"), want)


ROTATE_CASES = [
    # tests/test_aug_extras.py's cases
    ((60, 200), [[10, 12, 30, 40], [50, 5, 90, 55], [120, 20, 160, 45]], 7.0),
    ((40, 80), [[5, 5, 20, 30]], 0.0),
    ((64, 256), [[10, 10, 40, 50], [60, 10, 100, 50]], 5.0),
    # odd sizes at +-1 to 30 degrees, boxes over the edges
    ((37, 151), [[0, 0, 151, 37], [140.5, 3.25, 160, 30]], -1.0),
    ((45, 99), [[3, 4, 20, 44.5]], 13.7),
    ((21, 333), [[100, 2, 130, 19], [300, 0, 333, 21]], -22.25),
    ((129, 17), [[1, 1, 16, 128]], 30.0),
    ((63, 255), np.zeros((0, 4)), -30.0),
]


@pytest.mark.parametrize("case", range(len(ROTATE_CASES)))
def test_rotate_with_boxes_matches_jax(case):
    (h, w), boxes, angle = ROTATE_CASES[case]
    rng = np.random.default_rng(10 + case)
    img = rng.random((h, w, 3), dtype=np.float32)
    boxes = np.asarray(boxes, np.float32)
    want_img, want_boxes = JT.rotate_with_boxes(img, boxes, angle)
    got_img, got_boxes = T.rotate_with_boxes(img, boxes, angle)
    assert got_img.dtype == want_img.dtype == np.float32
    np.testing.assert_array_equal(got_img, want_img)
    assert got_boxes.dtype == want_boxes.dtype
    np.testing.assert_array_equal(got_boxes, want_boxes)


def test_gaussian_blur_gives_pil_pixels():
    """Radii from 0 to 40 (the box's integer part from 0 to beyond the
    line) on RGB and gray lines of 1 to 200 pixels a side."""
    rng = np.random.default_rng(4)
    radii = [0.0, 0.05, 0.1, 0.3, 0.5, 1.0, 1.5, 2.0, 3.3, 7.0, 15.0, 40.0] + list(
        rng.uniform(0.05, 6.0, 12))
    for i, r in enumerate(radii):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 200))
        shape = (h, w, 3) if i % 3 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(float(r))))
        np.testing.assert_array_equal(T.pil_gaussian_blur(img, float(r)), want,
                                      err_msg=f"{h}x{w} radius {r}")


def test_gaussian_blur_augmentation_matches_jax():
    img = np.random.default_rng(5).random((48, 160, 3), dtype=np.float32)
    for seed in range(4):
        want = JT.gaussian_blur(np.random.default_rng(seed), img)
        got = T.gaussian_blur(np.random.default_rng(seed), img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pretrain_batcher_with_rotation_matches_jax():
    """The pretraining recipe (reuse pool, character boxes) with half the
    lines rotated by 10 degrees: JAX's batches bit for bit."""
    lines = seeded_lines(6, n=8)
    kw = recipe_kw(RECIPE_DETECTION, train=True, seed=21, reuse=4, space_label=165,
                   rotate_p=0.5, rotate_angle=10.0)
    rotated = []
    calls = JT.rotate_with_boxes

    def counting(*a, **k):
        rotated.append(1)
        return calls(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "rotate_with_boxes", counting)
        assert_same_batches(lambda: cycle(lines), n=4, **kw)
    assert rotated  # JAX's batcher rotated some of the lines
