"""The JAX package's reading of the fixture lines by the reference's
architecture at full width (dtlr_tpu_torch/assets/smoke_deform_ref.npz),
which chip_smoke.py's ``deform`` phase holds the port's reading against.

The model is configs/Latin.py's (hidden 256, 8 heads, 6 + 6 layers, 900
queries, 4 levels x 4 points, deformable encoder and cross-attention,
FrozenBN ResNet-50), with the weights that ``chip_smoke.deform_weights``
draws from a frozen numpy stream (no leaf zero, FrozenBN statistics not
the identity), on the eight committed lines of
dtlr_tpu_torch/assets/smoke_lines.npz. ``make_reference()`` runs JAX's
model (``build_dino_from_config``) on the CPU, two lines at a time, and
writes for each reading (``fp32``, ``bf16``: the recipe's compute dtype,
``shared_fp32``: ``deform_shared_offsets=True``, with its own weights) the
greedy and TH/NMS strings (the fixture's ``nms_point``), per query the
final box, the max logit, the two-stage anchor and that proposal's max
logit, and the weights' sha256; and JAX's own bf16-to-fp32 spread of the
strings (mean CER of the bf16 strings against the fp32 ones), which sets
the bf16 reading's gate on the card.

Rebuild, from the repository root (needs JAX; about 5 minutes on the CPU,
a few GB):

    PYTHONPATH=.:tests python tests/test_torch_deform_fixture.py

A tier-1 test checks the asset's keys and shapes and that the seeded
weights still hash to the recorded values; ``test_regenerates`` (slow)
rebuilds it and compares.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded weights and the phase's constants)

REFERENCE = chip_smoke.DEFORM_REF
LINES = chip_smoke.LINES
JAX_CONFIG = os.path.join(REPO, "dtlr_tpu", "configs", "Latin.py")
READING = ("greedy", "nms", "pred_boxes", "max_logit", "anchors", "interm_max_logit")
NQ = 900


def nested(flat):
    out = {}
    for key, x in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def seeded(shared: bool, num_classes: int):
    tree = chip_smoke.deform_weights(chip_smoke.deform_config("float32", shared), num_classes)
    return tree, chip_smoke.tree_sha256(tree)


def jax_reading(tree, lines, compute_dtype, shared, batch_size=2, config=JAX_CONFIG,
                options=None):
    """JAX's reading of the lines (``READING``) with a flat tree, by the
    model of ``config`` with ``options`` (key: value) set."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.eval.decode import greedy_decode, greedy_labels, labels_to_text, nms_decode
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.pixels import prep_images

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(config)
    for k, v in (options or {}).items():
        setattr(cfg, k, v)
    cfg.num_classes = tree["params/class_embed/fc/kernel"].shape[-1]
    cfg.dn_labelbook_size = tree["params/label_enc"].shape[0] - 1
    cfg.compute_dtype = compute_dtype
    cfg.deform_shared_offsets = shared
    model = build_dino_from_config(cfg)
    params = nested(tree)
    fwd = jax.jit(lambda p, im, vh: model.apply(p, prep_images(im, vh), vh, None, train=False))
    th, nms = (float(x) for x in lines["nms_point"])
    charset = lines["charset"]
    out = {k: [] for k in READING}
    for i in range(0, len(lines["images"]), batch_size):
        o = fwd(params, lines["images"][i:i + batch_size], lines["valid_hw"][i:i + batch_size])
        logits = np.asarray(o["pred_logits"], np.float32)
        boxes = np.asarray(o["pred_boxes"], np.float32)
        out["greedy"] += [labels_to_text(l, charset)
                          for l in greedy_labels(greedy_decode(logits, boxes))]
        out["nms"] += [labels_to_text(l, charset) for l in nms_decode(logits, boxes, th, nms)]
        out["pred_boxes"].append(boxes)
        out["max_logit"].append(logits.max(-1))
        out["anchors"].append(np.asarray(o["interm_outputs_for_matching_pre"]["pred_boxes"],
                                         np.float32))
        out["interm_max_logit"].append(np.asarray(o["interm_outputs"]["pred_logits"],
                                                  np.float32).max(-1))
    for k in READING[2:]:
        out[k] = np.concatenate(out[k])
    return out


def make_reference(path: str = REFERENCE) -> dict:
    """Write the asset (see the module docstring); returns its arrays."""
    from dtlr_tpu.eval.metrics import mean_cer
    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(LINES)
    num_classes = len(lines["charset"])
    arrays = {"seed": np.asarray(chip_smoke.DEFORM_SEED), "config": np.asarray(["Latin.py"])}
    readings = {}
    for prefix, compute_dtype, shared in chip_smoke.DEFORM_VARIANTS:
        tree, digest = seeded(shared, num_classes)
        readings[prefix] = jax_reading(tree, lines, compute_dtype, shared)
        arrays[f"{prefix}_weights_sha256"] = np.asarray(digest)
        for k, v in readings[prefix].items():
            arrays[f"{prefix}_{k}"] = np.asarray(v)
    for k in ("greedy", "nms"):
        arrays[f"jax_bf16_vs_fp32_cer_{k}"] = np.asarray(
            mean_cer(readings["bf16"][k], readings["fp32"][k]))
    np.savez_compressed(path, **arrays)
    return arrays


def load_reference(path: str = REFERENCE) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def test_asset_keys_shapes_and_weights():
    ref = load_reference()
    assert os.path.getsize(REFERENCE) < 2 * 2 ** 20
    n = len(np.load(LINES)["images"])
    for prefix, _, shared in chip_smoke.DEFORM_VARIANTS:
        for k in ("greedy", "nms"):
            assert ref[f"{prefix}_{k}"].shape == (n,) and ref[f"{prefix}_{k}"].dtype.kind == "U"
        for k, shape in (("pred_boxes", (n, NQ, 4)), ("anchors", (n, NQ, 4)),
                         ("max_logit", (n, NQ)), ("interm_max_logit", (n, NQ))):
            assert ref[f"{prefix}_{k}"].shape == shape, (prefix, k)
            assert ref[f"{prefix}_{k}"].dtype == np.float32
            assert np.isfinite(ref[f"{prefix}_{k}"]).all()
    assert {f"jax_bf16_vs_fp32_cer_{k}" for k in ("greedy", "nms")} <= set(ref)
    assert int(ref["seed"]) == chip_smoke.DEFORM_SEED
    num_classes = len(np.load(LINES)["charset"])
    for shared, prefixes in ((False, ("fp32", "bf16")), (True, ("shared_fp32",))):
        tree, digest = seeded(shared, num_classes)
        assert all(str(ref[f"{p}_weights_sha256"]) == digest for p in prefixes)
        # no leaf is zero, and the FrozenBN statistics are not the identity
        assert all(np.abs(x).min() > 0 for x in tree.values())
        var = [x for k, x in tree.items() if k.endswith("/var")]
        assert len(var) == 53 and all(np.abs(v - 1).max() > 0.1 for v in var)
        offsets = tree["params/transformer/encoder_layer_0/self_attn/sampling_offsets/bias"]
        assert offsets.shape == (8 * 4 * 4 * 2 // (8 if shared else 1),)


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
