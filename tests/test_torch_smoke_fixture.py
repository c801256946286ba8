"""The committed line fixture (dtlr_tpu_torch/assets/smoke_lines.npz) and
the port reading it with the flagship checkpoint.

The fixture holds eight pre-rendered uint8 lines, so that a machine
without PIL or fonts (the GPU host) can drive the port end to end, plus
what the JAX package makes of them with ``artifacts/r4ft_params.npz`` in
float32: the greedy and TH 0.1 / NMS 0.4 strings, the final
``pred_boxes`` and each query's max logit. ``make_fixture()`` rebuilds
it (``python tests/test_torch_smoke_fixture.py``).
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
FLAGSHIP_CFG = os.path.join(REPO, "outputs", "finetune_r4b", "config_cfg.py")
TH, NMS = 0.1, 0.4


def make_fixture(path: str = FIXTURE, n: int = 8) -> None:
    """Render ``n`` held-out lines as the flagship eval does and record
    the JAX package's float32 reading of them."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.charset import resolve_synthetic_charset
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator
    from dtlr_tpu.eval.decode import (greedy_decode, greedy_labels,
                                      labels_to_text, nms_decode)
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz

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

    cfg.num_classes = len(charset)
    cfg.dn_labelbook_size = len(charset) + 1
    cfg.compute_dtype = "float32"
    model = build_dino_from_config(cfg)
    params = {"params": load_params_npz(PARAMS)["params"]}
    fwd = jax.jit(lambda p, im, vh: model.apply(
        p, prep_images(im, vh), vh, None, train=False))
    out = fwd(params, batch.images, batch.valid_hw)
    logits = np.asarray(out["pred_logits"], np.float32)
    boxes = np.asarray(out["pred_boxes"], np.float32)
    greedy = [labels_to_text(l, charset)
              for l in greedy_labels(greedy_decode(logits, boxes))]
    nms = [labels_to_text(l, charset) for l in nms_decode(logits, boxes, TH, NMS)]
    np.savez_compressed(
        path,
        images=np.asarray(batch.images, np.uint8),
        valid_hw=np.asarray(batch.valid_hw, np.int32),
        texts=np.asarray(batch.texts),
        charset=np.asarray(charset),
        jax_greedy=np.asarray(greedy),
        jax_nms=np.asarray(nms),
        nms_point=np.asarray([TH, NMS], np.float32),
        jax_pred_boxes=boxes,
        jax_max_logit=logits.max(-1),
        jax_anchors=np.asarray(
            out["interm_outputs_for_matching_pre"]["pred_boxes"], np.float32),
        jax_interm_max_logit=np.asarray(
            out["interm_outputs"]["pred_logits"], np.float32).max(-1),
    )


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
    model = load_model(PARAMS, device="cpu")
    res = read_lines(model, lines, TH, NMS, batch_size=2)
    assert res["greedy"] == lines["jax_greedy"]
    assert res["nms"] == lines["jax_nms"]
    a = agreement(res, lines)
    assert a["lines_compared"] >= len(lines["texts"]) // 2, a
    assert a["max_swap_score_gap"] < 1e-3, a
    assert a["max_pred_boxes_err"] < 1e-3, a
    assert a["max_logit_err"] < 1e-3, a


if __name__ == "__main__":
    make_fixture()
    print(FIXTURE, os.path.getsize(FIXTURE))
