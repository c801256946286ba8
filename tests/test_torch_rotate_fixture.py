"""The JAX package's first batches of the pretraining recipe's batcher
with the rotation on (dtlr_tpu_torch/assets/smoke_rotate_data.npz), which
chip_smoke.py's ``data`` phase holds the port's against: the detection
fixture's lines (assets/smoke_detect.npz, character boxes), the recipe's
settings and reuse pool of 4, the entry points' seed 42, and
``rotate_p = 0.5`` at 10 degrees (``chip_smoke.ROTATE_P``,
``ROTATE_ANGLE``): per batch the sha256 of the uint8 images and the
labels, validity, valid sizes and boxes.

Rebuild from the repository root (needs JAX and PIL; seconds):

    PYTHONPATH=.:tests python tests/test_torch_rotate_fixture.py
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase's settings)
from test_torch_smoke_data import FIELDS, image_sha256  # noqa: E402
from test_torch_transforms import native_helper  # noqa: E402,F401 (JAX's resize helper)

REF = chip_smoke.ROTATE_REF
N_BATCHES = chip_smoke.DATA_BATCHES


def batches(batcher_cls, iterate):
    """The first batches of ``batcher_cls`` (either package's
    ``BucketBatcher``) over ``iterate``'s stream of the fixture."""
    from dtlr_tpu_torch.data.loaders import NpzLines

    ds = NpzLines(chip_smoke.DETECT_LINES)
    batcher = batcher_cls(iterate(ds), **chip_smoke.rotate_batcher_kwargs(ds.charset))
    out = []
    try:
        for batch in batcher:
            out.append(batch)
            if len(out) == N_BATCHES:
                break
    finally:
        batcher.stop()
    return out


def make_reference(path: str = REF) -> dict:
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.train.finetune import dataset_iter

    got = batches(BucketBatcher, dataset_iter)
    arrays = {"numpy_version": np.asarray([np.__version__]),
              "images_sha256": np.asarray([image_sha256(b.images) for b in got])}
    for f in FIELDS:
        arrays[f] = np.stack([getattr(b, f) for b in got])
    np.savez_compressed(path, **arrays)
    return arrays


def test_port_batches_are_jaxs():
    from dtlr_tpu_torch.data.batching import BucketBatcher
    from dtlr_tpu_torch.data.loaders import dataset_iter

    got = batches(BucketBatcher, dataset_iter)
    with np.load(REF) as z:
        assert [image_sha256(b.images) for b in got] == list(z["images_sha256"])
        for f in FIELDS:
            np.testing.assert_array_equal(np.stack([getattr(b, f) for b in got]), z[f],
                                          err_msg=f)


@pytest.mark.slow
def test_regenerates(tmp_path):
    got = make_reference(str(tmp_path / "ref.npz"))
    with np.load(REF) as z:
        assert set(got) - {"numpy_version"} <= set(z.files)
        for k, v in got.items():
            if k != "numpy_version":
                np.testing.assert_array_equal(v, z[k], err_msg=k)


if __name__ == "__main__":
    from test_torch_transforms import load_native_helper

    assert load_native_helper()  # JAX's upscale must take its C++ helper
    make_reference()
    print(f"wrote {REF}")
