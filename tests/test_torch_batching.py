"""The port's batches (dtlr_tpu_torch/data/batching.py, loaders.py)
against the JAX package's (dtlr_tpu/data/batching.py), bit for bit, over
several batches each: the finetune recipe (train, seed 42), the
pretraining recipe (reuse pool of 4, character boxes, the column and
word erasings), and evaluation (no augmentation). The sources are the
committed lines read by the port's ``NpzLines`` and seeded lines of
random sizes that take every resize path (upscale, downscale, the
``h_max`` squash of tall narrow lines, the ``w_max`` crop). Every
batcher is stopped before its test ends."""

import os

import numpy as np
import pytest

from dtlr_tpu.data import batching as JB
from dtlr_tpu.data import loaders as JL
from dtlr_tpu.train.finetune import dataset_iter as jax_dataset_iter
from dtlr_tpu_torch.data import batching as TB
from dtlr_tpu_torch.data import loaders as TL
from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION
from test_torch_transforms import native_helper  # noqa: F401 (JAX's resize helper, autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
DETECT = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_detect.npz")
N_BATCHES = 4


def seeded_lines(seed, n=10, with_boxes=True):
    """Lines of random sizes (tall narrow ones included), k/255 pixels,
    labels from a 166-class charset (165 is the space) and pixel boxes."""
    rng = np.random.default_rng(seed)
    shapes = [(40, 300), (300, 60), (150, 1500), (90, 90), (250, 700), (20, 160),
              (128, 521), (400, 120), (64, 2000), (180, 400)]
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        k = int(rng.integers(3, 12))
        x0 = np.sort(rng.uniform(0, w - 8, k))
        bx = np.stack([x0, np.full(k, h * 0.2), x0 + rng.uniform(2, 8, k),
                       np.full(k, h * 0.8)], -1).astype(np.float32)
        labels = rng.integers(0, 166, k).astype(np.int32)
        out.append({"image": rng.integers(0, 256, (h, w, 3)).astype(np.float32) / 255.0,
                    "labels": labels, "boxes": bx if with_boxes else None,
                    "text": "".join(chr(97 + int(l) % 26) for l in labels)})
    return out


def recipe_kw(cfg, **kw):
    return {**dict(batch_size=cfg.batch_size, scales=cfg.data_aug_scales,
                   max_size=cfg.data_aug_max_size, max_targets=cfg.max_targets,
                   w_max=cfg.image_w_max, h_max=cfg.image_h_max, h_quant=cfg.h_quant,
                   transfer_uint8=cfg.transfer_uint8), **kw}


def assert_same_batches(make_source, n=N_BATCHES, **kw):
    jb = JB.BucketBatcher(make_source(), **kw)
    tb = TB.BucketBatcher(make_source(), **kw)
    try:
        got = []
        for want, batch in zip(iter(jb), iter(tb)):
            for f in ("images", "valid_hw", "labels", "boxes", "valid"):
                a, b = getattr(batch, f), getattr(want, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            assert batch.texts == want.texts
            got.append(batch)
            if len(got) == n:
                break
        assert len(got) == n
    finally:
        jb.stop()
        tb.stop()
    return got


def cycle(samples):
    while True:
        yield from samples


def test_finetune_recipe_on_the_committed_lines():
    ds = TL.NpzLines(LINES)
    space = ds.charset.index(" ")
    batches = assert_same_batches(lambda: jax_dataset_iter(TL.NpzLines(LINES)),
                                  **recipe_kw(RECIPE, train=True, seed=42, space_label=space))
    assert all(b.images.dtype == np.uint8 and b.images.shape[1:] == (128, 1024, 3)
               for b in batches)


@pytest.mark.parametrize("scales", [(128,), (96, 128, 160)])
def test_finetune_recipe_on_lines_of_every_size(scales):
    lines = seeded_lines(1, with_boxes=False)
    batches = assert_same_batches(
        lambda: cycle(lines), **recipe_kw(RECIPE, train=True, seed=5, scales=scales))
    assert max(int(b.valid_hw[:, 0].max()) for b in batches) <= RECIPE.image_h_max


def test_pretrain_recipe_with_reuse_and_boxes():
    assert RECIPE_DETECTION.reuse == 4
    ds = TL.NpzLines(DETECT)
    assert_same_batches(lambda: jax_dataset_iter(TL.NpzLines(DETECT)),
                        **recipe_kw(RECIPE_DETECTION, train=True, seed=42, reuse=4,
                                    space_label=ds.charset.index(" ")))


def test_pretrain_erasings_on_lines_of_every_size():
    lines = seeded_lines(2)
    assert_same_batches(lambda: cycle(lines), n=5,
                        **recipe_kw(RECIPE_DETECTION, train=True, seed=9, reuse=4,
                                    truly_random_erasing=True, instance_erasing=True,
                                    space_label=165))


def test_eval_batches():
    lines = seeded_lines(3, n=10)
    got = assert_same_batches(lambda: iter(lines), n=2,
                              **recipe_kw(RECIPE, train=False, seed=7, batch_size=4))
    # the source ends after 10 lines: both batchers stop after the second
    jb = TB.BucketBatcher(iter(lines[:8]), **recipe_kw(RECIPE, train=False, batch_size=4))
    assert len(list(iter(jb))) == 2
    jb.stop()
    assert len(got) == 2


@pytest.mark.parametrize("as_uint8,normalize", [(True, True), (False, True), (False, False)])
def test_collate(as_uint8, normalize):
    rng = np.random.default_rng(11)
    samples = []
    for h, w in ((50, 200), (70, 1500), (64, 64)):
        n = int(rng.integers(1, 9))
        samples.append({"image": rng.random((h, w, 3), dtype=np.float32),
                        "labels": rng.integers(0, 60, n), "boxes": rng.random((n, 4)),
                        "text": "x" * n})
    copy = lambda: [{**s, "image": s["image"].copy()} for s in samples]
    want = JB.collate(copy(), 6, w_max=1024, as_uint8=as_uint8, normalize_pixels=normalize)
    got = TB.collate(copy(), 6, w_max=1024, as_uint8=as_uint8, normalize_pixels=normalize)
    for f in ("images", "valid_hw", "labels", "boxes", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.texts == want.texts
    assert got.images.shape == (3, 128, 1024, 3)


def test_stop_ends_the_worker():
    lines = seeded_lines(4, n=3)
    b = TB.BucketBatcher(cycle(lines), batch_size=2, scales=[64], max_size=256, w_max=256,
                         prefetch=1)
    it = iter(b)
    next(it)
    b.stop()
    assert not b._thread.is_alive()


def test_worker_errors_reach_the_consumer():
    def failing_source():
        yield from seeded_lines(5, n=1)
        raise RuntimeError("the source failed")

    b = TB.BucketBatcher(failing_source(), batch_size=2, scales=[64], max_size=256,
                         w_max=256)
    with pytest.raises(RuntimeError, match="the source failed"):
        next(iter(b))
    b.stop()


def test_npz_lines():
    ds = TL.NpzLines(DETECT)
    assert len(ds) == 8 and not ds.token_based
    with np.load(DETECT) as z:
        h, w = z["valid_hw"][3]
        s = ds[3]
        np.testing.assert_array_equal(s["image"], z["images"][3, :h, :w].astype(np.float32) / 255)
        keep = z["valid"][3]
        np.testing.assert_array_equal(s["labels"], z["labels"][3][keep])
        cx, cy, bw, bh = z["boxes"][3][keep].T
        np.testing.assert_allclose(s["boxes"], np.stack(
            [(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], -1),
            rtol=1e-6)
    lines = TL.NpzLines(LINES)
    assert lines[1]["boxes"] is None
    assert lines.encode(lines.text_of(1)).tolist() == [lines.charset.index(c)
                                                        for c in lines.text_of(1)]


def test_token_charset_and_registry(tmp_path):
    path = tmp_path / "cipher.npz"
    np.savez(path, images=np.zeros((1, 8, 8, 3), np.uint8), valid_hw=np.asarray([[8, 8]]),
             texts=np.asarray(["ab c ab"]), charset=np.asarray(["ab", "c"]))
    ds = TL.build_dataset("lines", path=str(path))
    assert ds.token_based and ds[0]["labels"].tolist() == [0, 1, 0]
    for name in TL.NEEDS_PIL:
        with pytest.raises(NotImplementedError, match="PIL"):
            TL.build_dataset(name, "train")
    with pytest.raises(ValueError):
        TL.build_dataset("nope", "train")
    gt = {"train": [{"id": 1, "text": "a"}], "valid": {3: "b", 4: {"text": "c"}}}
    for mode in ("train", "val", "valid"):
        assert TL._as_items(TL._split(gt, mode)) == JL._as_items(JL._split(gt, mode))
    with pytest.raises(KeyError):
        TL._split(gt, "test")
