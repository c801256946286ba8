"""The JAX package's readings of the fixture lines by the flagship
recipe's model with the four architecture settings changed, at full width
(dtlr_tpu_torch/assets/smoke_arch_ref.npz), which chip_smoke.py's
``arch`` phase holds the port's fp32 readings against.

The model is configs/Latin_TPU.py's (hidden 256, 8 heads, 6 + 6 layers,
900 queries, the windowed encoder and the dense cross-attention with the
box prior) with ``chip_smoke.ARCH_OPTIONS``: five feature levels (the
fifth a stride-2 projection of the fourth; S = 2728 at 128x1024), the
decoder layer's order cross-attention, self-attention, FFN, and the sine
encodings' temperatures 10000 (y) and 20 (x); weights drawn by
``chip_smoke.deform_weights`` from its frozen numpy stream, on the eight
committed lines of dtlr_tpu_torch/assets/smoke_lines.npz.
``make_reference()`` runs JAX's model (``build_dino_from_config``) in
float32 on the CPU, two lines at a time: the eval reading (``eval_*``:
the greedy and TH/NMS strings, per query the final box, the max logit,
the two-stage anchor and that proposal's max logit), and the train-mode
forward at dropout 1.0 without targets (``train_*``, the same arrays:
every dropout site gives zeros, flax's and the port's alike, so the
forward is deterministic), the bfloat16 eval reading's strings
(``bf16_greedy``, ``bf16_nms``), and the weights' sha256.

Rebuild, from the repository root (needs JAX; about 3 minutes on the CPU):

    PYTHONPATH=.:tests python tests/test_torch_arch_fixture.py
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded weights and the phase's constants)
from test_torch_deform_fixture import READING, nested  # noqa: E402

REFERENCE = chip_smoke.ARCH_REF
LINES = chip_smoke.LINES
NQ = 900
JAX_OPTIONS = {"num_feature_levels": 5, "decoder_module_seq": ["ca", "sa", "ffn"],
               "pe_temperatureH": 10000, "pe_temperatureW": 20}


def jax_readings(tree, lines, batch_size=2):
    """JAX's eval reading and train-mode reading at dropout 1.0 (each the
    arrays of ``READING``)."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.eval.decode import greedy_decode, greedy_labels, labels_to_text, nms_decode
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.pixels import prep_images

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(os.path.join(REPO, "dtlr_tpu", "configs", "Latin_TPU.py"))
    for k, v in JAX_OPTIONS.items():
        setattr(cfg, k, v)
    cfg.num_classes = tree["params/class_embed/fc/kernel"].shape[-1]
    cfg.dn_labelbook_size = tree["params/label_enc"].shape[0] - 1
    cfg.compute_dtype = "float32"
    params = nested(tree)
    th, nms = (float(x) for x in lines["nms_point"])
    charset = lines["charset"]
    out = {}
    for mode, dropout, dtype in (("eval", 0.0, "float32"), ("train", 1.0, "float32"),
                                 ("bf16", 0.0, "bfloat16")):
        cfg.dropout, cfg.compute_dtype = dropout, dtype
        model = build_dino_from_config(cfg)
        train = mode == "train"
        fwd = jax.jit(lambda p, im, vh: model.apply(
            p, prep_images(im, vh), vh, None, train=train,
            rngs={"dropout": jax.random.PRNGKey(0)}))
        res = {k: [] for k in READING}
        for i in range(0, len(lines["images"]), batch_size):
            o = fwd(params, lines["images"][i:i + batch_size],
                    lines["valid_hw"][i:i + batch_size])
            logits = np.asarray(o["pred_logits"], np.float32)
            boxes = np.asarray(o["pred_boxes"], np.float32)
            res["greedy"] += [labels_to_text(l, charset)
                              for l in greedy_labels(greedy_decode(logits, boxes))]
            res["nms"] += [labels_to_text(l, charset) for l in nms_decode(logits, boxes, th, nms)]
            res["pred_boxes"].append(boxes)
            res["max_logit"].append(logits.max(-1))
            res["anchors"].append(np.asarray(o["interm_outputs_for_matching_pre"]["pred_boxes"],
                                             np.float32))
            res["interm_max_logit"].append(np.asarray(o["interm_outputs"]["pred_logits"],
                                                      np.float32).max(-1))
        for k in READING[2:]:
            res[k] = np.concatenate(res[k])
        out[mode] = res
    return out


def make_reference(path: str = REFERENCE) -> dict:
    """Write the asset (see the module docstring); returns its arrays."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(LINES)
    tree = chip_smoke.deform_weights(chip_smoke.arch_config(), len(lines["charset"]))
    arrays = {"seed": np.asarray(chip_smoke.DEFORM_SEED), "config": np.asarray(["Latin_TPU.py"]),
              "options": np.asarray(chip_smoke.ARCH_OPTIONS),
              "weights_sha256": np.asarray(chip_smoke.tree_sha256(tree))}
    for mode, reading in jax_readings(tree, lines).items():
        for k, v in reading.items():
            if mode != "bf16" or k in ("greedy", "nms"):
                arrays[f"{mode}_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)
    return arrays


def load_reference(path: str = REFERENCE) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def test_asset_keys_and_shapes():
    ref = load_reference()
    assert os.path.getsize(REFERENCE) < 2 ** 20
    n = len(np.load(LINES)["images"])
    for mode in ("eval", "train", "bf16"):
        for k in ("greedy", "nms"):
            assert ref[f"{mode}_{k}"].shape == (n,) and ref[f"{mode}_{k}"].dtype.kind == "U"
        for k, shape in (("pred_boxes", (n, NQ, 4)), ("anchors", (n, NQ, 4)),
                         ("max_logit", (n, NQ)), ("interm_max_logit", (n, NQ))):
            if mode == "bf16":
                continue
            assert ref[f"{mode}_{k}"].shape == shape, (mode, k)
            assert np.isfinite(ref[f"{mode}_{k}"]).all()
    assert list(ref["options"]) == chip_smoke.ARCH_OPTIONS
    assert int(ref["seed"]) == chip_smoke.DEFORM_SEED
    # at rate 1.0 every residual branch drops: another reading than eval's
    assert not np.array_equal(ref["train_max_logit"], ref["eval_max_logit"])


def test_port_config_has_the_settings():
    cfg = chip_smoke.arch_config("bfloat16", 0.1)
    assert (cfg.num_feature_levels, cfg.decoder_module_seq, cfg.pe_temperature_h,
            cfg.pe_temperature_w, cfg.dropout, cfg.compute_dtype) == (
        5, ("ca", "sa", "ffn"), 10000.0, 20.0, 0.1, "bfloat16")
    assert (cfg.encoder_type, cfg.decoder_ca, cfg.hidden_dim, cfg.num_queries) == (
        "windowed", "dense", 256, 900)


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
