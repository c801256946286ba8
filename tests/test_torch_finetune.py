"""The port's CTC finetuning entry point (``python -m
dtlr_tpu_torch.train.finetune``) on the CPU at the tiny geometry
(``TINY``): a stage-1 run with the class-head surgery, the head-only
optimizer and an evaluation, then a stage-2 run that resumes it with
the full-model optimizer. Lines: 128x256 crops of the committed fixture
lines. What is checked is the plumbing (the files each stage writes,
the steps it counts, which parameters each optimizer moves), not the
numbers, which test_torch_train_step.py holds to JAX's.
"""

import json

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train import finetune
from test_torch_grad_stops import flat
from test_torch_model import NUM_CLASSES, TINY, jax_tiny, make_lines, perturbed_params
from test_torch_smoke_fixture import FIXTURE

OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
           "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32", "batch_size=2",
           "max_iterations=2", "print_freq=1", "lr=1e-3"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A TINY snapshot with NUM_CLASSES classes, its charset (the first
    NUM_CLASSES - 1 characters of the lines' charset and one they lack),
    and four 128x256 line crops."""
    d = tmp_path_factory.mktemp("finetune")
    images, valid_hw = make_lines()
    tree = flat(perturbed_params(jax_tiny(False), images, valid_hw))
    np.savez(d / "tiny.npz", **{k: v.astype(np.float16) for k, v in tree.items()})
    lines = load_lines(FIXTURE)
    old = lines["charset"][:NUM_CLASSES - 1] + ["é"]
    with open(d / "old_charset.json", "w") as fh:
        json.dump(old, fh)
    np.savez(d / "lines.npz", images=np.ascontiguousarray(lines["images"][:4, :, :256]),
             valid_hw=np.minimum(lines["valid_hw"][:4], [128, 256]).astype(np.int32),
             texts=np.asarray([t[:6] for t in lines["texts"][:4]]),
             charset=np.asarray(lines["charset"]))
    return d


def run(files, out, *extra):
    return finetune.main(["--lines", str(files / "lines.npz"), "--output_dir", str(out),
                          "--device", "cpu", "--epochs", "1", "--options", *OPTIONS, *extra])


def test_stage1_surgery_head_only_then_stage2_resume(files, tmp_path):
    out = tmp_path / "run"
    res = run(files, out, "--pretrain_dir", str(files / "tiny.npz"), "--new_class_embedding",
              "--smart_mapping", "--path_old_charset", str(files / "old_charset.json"))
    assert res["train"]["iterations"] == 2 and res["train"]["skipped"] == 0.0
    assert np.isfinite(res["train"]["loss"])
    assert set(res["eval"]) >= {"cer", "wer", "nms_cer", "loss_CTC", "n"}
    assert res["eval"]["n"] == 4
    saved = ckpt.restore_checkpoint(str(out / "checkpoint"))
    assert saved["step"] == 2 and saved["epoch"] == 1
    assert saved["params"]["class_embed.fc.weight"].shape == (65, TINY.hidden_dim)
    assert saved["params"]["label_enc"].shape == (67, TINY.hidden_dim)
    # stage 1 trains the class heads alone: the rest is the snapshot's
    snap = ckpt.load_params_npz(str(files / "tiny.npz"))
    enc = saved["params"]["transformer.encoder_layer_0.linear1.weight"]
    np.testing.assert_array_equal(
        enc.numpy(), snap["params/transformer/encoder_layer_0/linear1/kernel"].T)
    assert set(saved["opt_state"]["mu"]) == {n for n in saved["params"]
                                             if "class_embed" in n or n == "label_enc"}
    for name in ("info.txt", "log.txt", "config_cfg.json"):
        assert (out / name).exists(), name
    assert ckpt.latest_step(str(out / "checkpoint_best_regular")) == 2

    # stage 2: resume the run with the full-model optimizer; the head-only
    # optimizer state does not fit it, so the parameters carry over alone
    res2 = run(files, out, "--resume_finetuning", "--epochs", "2")
    assert res2["train"]["iterations"] == 2
    saved2 = ckpt.restore_checkpoint(str(out / "checkpoint"))
    assert saved2["step"] == 4 and saved2["epoch"] == 2
    assert saved2["opt_state"]["count"] == 2
    assert len(saved2["opt_state"]["mu"]) == len(saved2["params"])
    assert not torch.equal(saved2["params"]["transformer.encoder_layer_0.linear1.weight"], enc)


def test_refuses_a_class_count_that_does_not_fit(files, tmp_path):
    with pytest.raises(ValueError, match="new_class_embedding"):
        run(files, tmp_path, "--pretrain_dir", str(files / "tiny.npz"))
    with pytest.raises(ValueError, match="pretrain_dir"):
        run(files, tmp_path)
    with pytest.raises(KeyError, match="unknown option"):
        run(files, tmp_path, "--pretrain_dir", str(files / "tiny.npz"), "--options", "nope=1")
