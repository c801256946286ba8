"""The port's detection pretraining entry point (``python -m
dtlr_tpu_torch.train.pretrain``) on the CPU at the tiny geometry
(``TINY`` with the 166-class head of the pretraining trunk): two steps
of the detection trainer on 128x256 crops of the detection fixture's
lines (their character boxes carried into the crop), the save, the
exported weights and the detection-loss evaluation. What is checked is
the plumbing; test_torch_detection_step.py holds the numbers to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train import pretrain
from test_torch_model import TINY
from test_torch_smoke_detect import FIXTURE

OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
           "dim_feedforward=64", "encoder_win=8", "batch_size=2", "print_freq=1",
           "warmup_steps=0", "max_targets=16"]
NUM_CLASSES, WIDTH = 166, 256


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A TINY snapshot with the trunk's 166 classes and label book, and
    four crops of the detection fixture, each keeping the characters
    that lie inside it."""
    d = tmp_path_factory.mktemp("pretrain")
    torch.manual_seed(0)
    model = build_dino(dataclasses.replace(TINY, dn_labelbook_size=NUM_CLASSES + 1),
                       NUM_CLASSES, device="cpu")
    np.savez(d / "tiny.npz", **ckpt.params_to_flax(dict(model.named_parameters())))
    lines = load_lines(FIXTURE)
    frame_w = lines["images"].shape[2]
    boxes = lines["boxes"][:4].copy()
    boxes[..., 0] *= frame_w / WIDTH
    boxes[..., 2] *= frame_w / WIDTH
    inside = lines["valid"][:4] & (boxes[..., 0] + boxes[..., 2] / 2 <= 1.0)
    np.savez(d / "lines.npz", images=np.ascontiguousarray(lines["images"][:4, :, :WIDTH]),
             valid_hw=np.minimum(lines["valid_hw"][:4], [128, WIDTH]).astype(np.int32),
             labels=lines["labels"][:4], boxes=np.where(inside[..., None], boxes, 0),
             valid=inside, texts=np.asarray(lines["texts"][:4]),
             charset=np.asarray(lines["charset"]))
    # the same lines under a charset of 64 characters, which the 166-class
    # head does not fit
    with np.load(d / "lines.npz") as z:
        np.savez(d / "charset_64.npz", **{k: z[k] for k in z.files if k != "charset"},
                 charset=np.asarray(lines["charset"][:64]))
    np.savez(d / "no_boxes.npz", images=lines["images"][:2, :, :WIDTH],
             valid_hw=np.minimum(lines["valid_hw"][:2], [128, WIDTH]).astype(np.int32),
             texts=np.asarray(lines["texts"][:2]), charset=np.asarray(lines["charset"]))
    return d


def run(files, out, lines="lines.npz", *extra):
    return pretrain.main(["--params", str(files / "tiny.npz"), "--lines", str(files / lines),
                          "--output_dir", str(out), "--steps", "2", "--device", "cpu",
                          "--compute_dtype", "float32", "--options", *OPTIONS, *extra])


def test_two_steps_save_and_evaluate(files, tmp_path):
    res = run(files, tmp_path)
    assert res["train"]["iterations"] == 2 and res["train"]["skipped"] == 0.0
    assert np.isfinite(res["train"]["loss"]) and np.isfinite(res["train"]["loss_ce_dn"])
    assert set(res["eval"]) == {"loss", "loss_ce", "loss_bbox", "loss_giou"}
    assert all(np.isfinite(v) for v in res["eval"].values())
    saved = ckpt.restore_checkpoint(str(tmp_path / "checkpoint"))
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    assert saved["ema_params"] is not None  # the recipe keeps EMA
    weights = ckpt.load_params_npz(res["params"])
    assert weights["params/class_embed/fc/kernel"].shape == (TINY.hidden_dim, NUM_CLASSES)
    assert weights["params/label_enc"].shape == (NUM_CLASSES + 2, TINY.hidden_dim)
    snap = ckpt.load_params_npz(str(files / "tiny.npz"))
    # the label encoder learned in the rows of the crops' labels (the CDN)
    moved = np.flatnonzero(np.abs(weights["params/label_enc"] - snap["params/label_enc"])
                           .max(-1) > 0)
    assert len(moved) > 0
    for name in ("info.txt", "log.txt", "config_cfg.json"):
        assert (tmp_path / name).exists(), name


def test_runs_on_the_card_unless_told_otherwise(files, tmp_path, monkeypatch):
    assert pretrain.parse_args(["--params", "p", "--lines", "l"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["--params", str(files / "tiny.npz"), "--lines",
                       str(files / "lines.npz"), "--output_dir", str(tmp_path)])


def test_refuses_lines_without_boxes(files, tmp_path):
    with pytest.raises(ValueError, match="character boxes"):
        run(files, tmp_path, "no_boxes.npz")
    with pytest.raises(KeyError, match="unknown option"):
        run(files, tmp_path, "lines.npz", "nope=1")


def test_refuses_a_charset_the_class_head_does_not_fit(files, tmp_path):
    """JAX sizes the class head from the lines' charset; the port starts
    from the snapshot's head and refuses lines whose charset has another
    size, as finetune and evaluate do."""
    with pytest.raises(ValueError, match="166 classes and the lines' charset 64"):
        run(files, tmp_path, "charset_64.npz")
    assert not (tmp_path / "checkpoint").exists()
