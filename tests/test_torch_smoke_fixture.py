"""The committed line fixture (dtlr_tpu_torch/assets/smoke_lines.npz), the
JAX package's bfloat16 reading of it
(dtlr_tpu_torch/assets/smoke_lines_bf16.npz), and the port reading it
with the flagship checkpoint.

The fixture holds eight pre-rendered uint8 lines, so that a machine
without PIL or fonts (the GPU host) can drive the port end to end, plus
what the JAX package makes of them with ``artifacts/r4ft_params.npz`` in
float32: the greedy and TH 0.1 / NMS 0.4 strings, the final
``pred_boxes`` and each query's max logit. The bf16 asset holds the same
reading, made by the recipe's compute dtype (``compute_dtype =
'bfloat16'`` in the dumped config). ``make_fixture()`` rebuilds the
first (``python tests/test_torch_smoke_fixture.py``), ``make_bf16_reading()``
the second from the first's images (``... test_torch_smoke_fixture.py bf16``).
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
FIXTURE_BF16 = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines_bf16.npz")
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
FLAGSHIP_CFG = os.path.join(REPO, "outputs", "finetune_r4b", "config_cfg.py")
TH, NMS = 0.1, 0.4
READING = ("jax_greedy", "jax_nms", "jax_pred_boxes", "jax_max_logit", "jax_anchors",
           "jax_interm_max_logit")


def jax_reading(images, valid_hw, charset, params_path=PARAMS, cfg_path=FLAGSHIP_CFG,
                compute_dtype="float32", batch_size=8):
    """The JAX package's reading of uint8 lines on the CPU, with a
    checkpoint and its dumped config at ``compute_dtype``: greedy and
    TH/NMS strings, and per query the final box, the max logit, the
    two-stage anchor and that proposal's max logit (``READING``)."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.eval.decode import greedy_decode, greedy_labels, labels_to_text, nms_decode
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(cfg_path)
    tree = load_params_npz(params_path)["params"]
    cfg.num_classes = tree["class_embed"]["fc"]["kernel"].shape[-1]
    cfg.dn_labelbook_size = tree["label_enc"].shape[0] - 1
    cfg.compute_dtype = compute_dtype
    model = build_dino_from_config(cfg)
    fwd = jax.jit(lambda p, im, vh: model.apply(
        p, prep_images(im, vh), vh, None, train=False))
    out = {k: [] for k in READING}
    for i in range(0, len(images), batch_size):
        o = fwd({"params": tree}, images[i:i + batch_size], valid_hw[i:i + batch_size])
        logits = np.asarray(o["pred_logits"], np.float32)
        boxes = np.asarray(o["pred_boxes"], np.float32)
        out["jax_greedy"] += [labels_to_text(l, charset)
                              for l in greedy_labels(greedy_decode(logits, boxes))]
        out["jax_nms"] += [labels_to_text(l, charset)
                           for l in nms_decode(logits, boxes, TH, NMS)]
        out["jax_pred_boxes"].append(boxes)
        out["jax_max_logit"].append(logits.max(-1))
        out["jax_anchors"].append(np.asarray(
            o["interm_outputs_for_matching_pre"]["pred_boxes"], np.float32))
        out["jax_interm_max_logit"].append(np.asarray(
            o["interm_outputs"]["pred_logits"], np.float32).max(-1))
    for k in READING[2:]:
        out[k] = np.concatenate(out[k])
    return out


def make_fixture(path: str = FIXTURE, n: int = 8) -> None:
    """Render ``n`` held-out lines as the flagship eval does and record
    the JAX package's float32 reading of them."""
    from dtlr_tpu.config import load_config
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.charset import resolve_synthetic_charset
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator

    cfg = load_config(FLAGSHIP_CFG)
    charset = resolve_synthetic_charset(cfg.synthetic_charset)
    with open(os.path.join(REPO, "artifacts", "corpus_words_val.txt")) as fh:
        corpus = [l.strip() for l in fh if l.strip()]
    gen = SyntheticLineGenerator(
        charset=charset, seed=123, max_words=cfg.synthetic_max_words,
        corpus_lines=corpus, corpus_prob=cfg.synthetic_corpus_prob)
    samples = [gen.sample_dict() for _ in range(n)]
    batcher = BucketBatcher(
        iter(samples), batch_size=n, scales=cfg.data_aug_scales,
        max_size=cfg.data_aug_max_size, max_targets=cfg.max_targets,
        w_max=cfg.image_w_max, h_max=cfg.image_h_max, train=False,
        transfer_uint8=True)
    batch = next(iter(batcher))
    batcher.stop()
    images = np.asarray(batch.images, np.uint8)
    valid_hw = np.asarray(batch.valid_hw, np.int32)
    reading = jax_reading(images, valid_hw, charset)
    np.savez_compressed(
        path,
        images=images,
        valid_hw=valid_hw,
        texts=np.asarray(batch.texts),
        charset=np.asarray(charset),
        nms_point=np.asarray([TH, NMS], np.float32),
        **{k: np.asarray(v) for k, v in reading.items()},
    )


def make_bf16_reading(path: str = FIXTURE_BF16) -> None:
    """The JAX package's reading of the fixture's lines in the recipe's
    bfloat16 (the images are not re-rendered)."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(FIXTURE)
    reading = jax_reading(lines["images"], lines["valid_hw"], lines["charset"],
                          compute_dtype="bfloat16", batch_size=4)
    np.savez_compressed(path, compute_dtype=np.asarray(["bfloat16"]),
                        **{k: np.asarray(v) for k, v in reading.items()})


def test_fixture_loads():
    from dtlr_tpu_torch.data.charset import resolve_synthetic_charset
    from dtlr_tpu_torch.eval.evaluate import load_lines

    assert os.path.getsize(FIXTURE) < 1 << 20
    lines = load_lines(FIXTURE)
    assert lines["images"].dtype == np.uint8
    assert lines["images"].shape == (8, 128, 1024, 3)
    assert lines["valid_hw"].shape == (8, 2)
    assert (lines["valid_hw"][:, 0] <= 128).all()
    assert (lines["valid_hw"][:, 1] <= 1024).all()
    assert len(lines["texts"]) == 8 and all(lines["texts"])
    assert lines["charset"] == resolve_synthetic_charset("no_accent_space")
    assert len(lines["charset"]) == 65
    assert lines["jax_pred_boxes"].shape == (8, 900, 4)
    assert lines["jax_max_logit"].shape == (8, 900)
    assert lines["jax_anchors"].shape == (8, 900, 4)
    assert lines["jax_interm_max_logit"].shape == (8, 900)
    assert len(lines["jax_greedy"]) == len(lines["jax_nms"]) == 8


@pytest.mark.slow
def test_port_reads_fixture_like_jax():
    """The port on the CPU, fed r4ft_params.npz, reads the eight lines
    exactly as the JAX package did. On every line whose two-stage
    selection equals JAX's, each query's box and max logit agree to 1e-3
    (measured 1e-5: float32 on both sides, summed in other orders); a
    selection that differs must come from a near tie of proposal scores
    (gap under 1e-3; measured 5e-6 on two of the eight lines)."""
    from dtlr_tpu_torch.eval.evaluate import agreement, load_lines, load_model, read_lines

    lines = load_lines(FIXTURE)
    model = load_model(PARAMS, device="cpu", compute_dtype="float32")
    res = read_lines(model, lines, TH, NMS, batch_size=2)
    assert res["greedy"] == lines["jax_greedy"]
    assert res["nms"] == lines["jax_nms"]
    a = agreement(res, lines)
    assert a["lines_compared"] >= len(lines["texts"]) // 2, a
    assert a["max_swap_score_gap"] < 1e-3, a
    assert a["max_pred_boxes_err"] < 1e-3, a
    assert a["max_logit_err"] < 1e-3, a


def test_bf16_reading_loads():
    from dtlr_tpu_torch.eval.evaluate import load_lines

    assert os.path.getsize(FIXTURE_BF16) < 300 << 10
    ref = load_lines(FIXTURE_BF16)
    assert ref["compute_dtype"] == ["bfloat16"]
    assert set(READING) <= set(ref)
    for k in ("jax_pred_boxes", "jax_anchors"):
        assert ref[k].shape == (8, 900, 4) and np.isfinite(ref[k]).all()
    for k in ("jax_max_logit", "jax_interm_max_logit"):
        assert ref[k].shape == (8, 900) and np.isfinite(ref[k]).all()
    assert len(ref["jax_greedy"]) == len(ref["jax_nms"]) == 8


@pytest.mark.slow
def test_port_reads_fixture_like_jax_bf16():
    """The port on the CPU in the recipe's bfloat16 against JAX's bf16
    reading. On bf16 scores the two-stage top-900 meets many exact and
    near ties, and the two frameworks round a few values differently, so
    no line keeps JAX's selection slot for slot (measured: 6041 of 7200
    slots moved, every swap between proposals whose scores differ by at
    most 0.0625, one bf16 step at 8-16). The reading is therefore held by
    its strings: CER at most 0.02 against JAX's bf16 strings (measured
    0.0) and at most 0.01 above JAX's CER against the ground truth, and
    every swap by a score gap of at most 0.25 (four bf16 steps)."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import agreement, load_lines, load_model, read_lines

    lines = load_lines(FIXTURE)
    ref = load_lines(FIXTURE_BF16)
    model = load_model(PARAMS, device="cpu", compute_dtype="bfloat16")
    res = read_lines(model, lines, TH, NMS, batch_size=2)
    a = agreement(res, ref)
    assert max(a["cer_vs_ref"].values()) <= 0.02, a
    assert a["max_swap_score_gap"] <= 0.25, a
    for k in ("greedy", "nms"):
        assert (metrics.mean_cer(res[k], lines["texts"])
                <= metrics.mean_cer(ref[f"jax_{k}"], lines["texts"]) + 0.01), k


if __name__ == "__main__":
    if sys.argv[1:] == ["bf16"]:
        make_bf16_reading()
        print(FIXTURE_BF16, os.path.getsize(FIXTURE_BF16))
    else:
        make_fixture()
        print(FIXTURE, os.path.getsize(FIXTURE))
