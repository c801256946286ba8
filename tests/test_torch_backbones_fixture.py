"""The JAX package's reading of the fixture lines by the flagship recipe's
model with a Swin-T and with a ConvNeXt-tiny backbone, at full width
(dtlr_tpu_torch/assets/smoke_backbones_ref.npz), which chip_smoke.py's
``backbones`` phase holds the port's fp32 reading against.

The model is configs/Latin_TPU.py's (hidden 256, 8 heads, 6 + 6 layers,
900 queries, the windowed encoder and the dense cross-attention with the
box prior) with ``backbone=swin_T_224_1k`` or ``convnext_tiny``, weights
drawn by ``chip_smoke.deform_weights`` from its frozen numpy stream, on
the eight committed lines of dtlr_tpu_torch/assets/smoke_lines.npz.
``make_reference()`` runs JAX's model (``build_dino_from_config``) in
float32 on the CPU, two lines at a time, and writes per backbone the
greedy and TH/NMS strings (the fixture's ``nms_point``), per query the
final box, the max logit, the two-stage anchor and that proposal's max
logit, and the weights' sha256.

Rebuild, from the repository root (needs JAX; about 3 minutes on the CPU):

    PYTHONPATH=.:tests python tests/test_torch_backbones_fixture.py
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded weights and the phase's constants)
from test_torch_deform_fixture import READING, jax_reading  # noqa: E402

REFERENCE = chip_smoke.BACKBONES_REF
LINES = chip_smoke.LINES
NQ = 900


def seeded(backbone: str, num_classes: int):
    tree = chip_smoke.deform_weights(chip_smoke.backbone_config(backbone), num_classes)
    return tree, chip_smoke.tree_sha256(tree)


def make_reference(path: str = REFERENCE) -> dict:
    """Write the asset (see the module docstring); returns its arrays."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(LINES)
    num_classes = len(lines["charset"])
    arrays = {"seed": np.asarray(chip_smoke.DEFORM_SEED), "config": np.asarray(["Latin_TPU.py"])}
    for backbone in chip_smoke.BACKBONES_HELD:
        tree, digest = seeded(backbone, num_classes)
        reading = jax_reading(tree, lines, "float32", True,
                              config=os.path.join(REPO, "dtlr_tpu", "configs", "Latin_TPU.py"),
                              options={"backbone": backbone})
        arrays[f"{backbone}_weights_sha256"] = np.asarray(digest)
        for k, v in reading.items():
            arrays[f"{backbone}_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)
    return arrays


def load_reference(path: str = REFERENCE) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def test_asset_keys_and_shapes():
    ref = load_reference()
    assert os.path.getsize(REFERENCE) < 2 ** 20
    n = len(np.load(LINES)["images"])
    for backbone in chip_smoke.BACKBONES_HELD:
        for k in ("greedy", "nms"):
            assert ref[f"{backbone}_{k}"].shape == (n,)
            assert ref[f"{backbone}_{k}"].dtype.kind == "U"
        for k, shape in (("pred_boxes", (n, NQ, 4)), ("anchors", (n, NQ, 4)),
                         ("max_logit", (n, NQ)), ("interm_max_logit", (n, NQ))):
            assert ref[f"{backbone}_{k}"].shape == shape, (backbone, k)
            assert ref[f"{backbone}_{k}"].dtype == np.float32
            assert np.isfinite(ref[f"{backbone}_{k}"]).all()
        assert len(str(ref[f"{backbone}_weights_sha256"])) == 64
    # the seeded weights' hash is checked where they are drawn again: on
    # the card before the reading, and in test_regenerates
    assert int(ref["seed"]) == chip_smoke.DEFORM_SEED
    assert set(READING) == {"greedy", "nms", "pred_boxes", "max_logit", "anchors",
                            "interm_max_logit"}


@pytest.mark.slow
def test_regenerates(tmp_path):
    got = make_reference(str(tmp_path / "ref.npz"))
    want = load_reference()
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype.kind in "US":
            assert np.array_equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


if __name__ == "__main__":
    make_reference()
    print(f"wrote {REFERENCE}")
