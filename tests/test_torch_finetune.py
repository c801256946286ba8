"""The port's CTC finetuning entry point (``python -m
dtlr_tpu_torch.train.finetune``) on the CPU at the tiny geometry
(``TINY``): a stage-1 run with the class-head surgery, the head-only
optimizer and an evaluation, then a stage-2 run that resumes it with
the full-model optimizer; a run from scratch (the fresh initialization)
with the training CER; a run from a port pretraining run's directory;
and a config file's run on the HWDB stream. Lines: 128x256 crops of the
committed fixture lines. What is checked is the plumbing (the files each
stage writes, the steps it counts, which parameters each optimizer
moves, where the weights start), not the numbers, which
test_torch_train_step.py holds to JAX's.
"""

import json

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.config import load_config
from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train import finetune, pretrain
from test_torch_grad_stops import flat
from test_torch_hwdb_synth import bank_chars, bank_root
from test_torch_model import NUM_CLASSES, TINY, jax_tiny, make_lines, perturbed_params
from test_torch_smoke_fixture import FIXTURE

OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
           "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32", "batch_size=2",
           "max_iterations=2", "print_freq=1", "lr=1e-3"]
#: 64x128 batches (the recipe pads to 1024 columns), for the runs that
#: check where the weights start, not the recipe's batches
SMALL = ["data_aug_scales=[64]", "data_aug_max_size=128", "image_w_max=128", "image_h_max=64"]


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
    with pytest.raises(ValueError, match="--lines"):
        finetune.main(["--output_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown option"):
        run(files, tmp_path, "--pretrain_dir", str(files / "tiny.npz"), "--options", "nope=1")


def test_from_scratch_with_the_training_cer(files, tmp_path):
    """No --pretrain_dir: the fresh initialization (train/init.py) sized by
    the lines' charset, as JAX's finetune starts (its finetune.py:218-220);
    the training CER and WER of the first step's batch (every 100 steps)
    come with the epoch's stats."""
    res = finetune.main(["--lines", str(files / "lines.npz"), "--output_dir", str(tmp_path),
                         "--device", "cpu", "--epochs", "1", "--full_model", "--options",
                         *OPTIONS, *SMALL])
    assert res["train"]["iterations"] == 2 and np.isfinite(res["train"]["loss"])
    assert 0.0 <= res["train"]["cer"] and 0.0 <= res["train"]["wer"]
    saved = ckpt.restore_checkpoint(str(tmp_path / "checkpoint"))
    charset = load_lines(str(files / "lines.npz"))["charset"]
    assert saved["params"]["class_embed.fc.weight"].shape == (len(charset), TINY.hidden_dim)
    assert saved["params"]["label_enc"].shape == (len(charset) + 2, TINY.hidden_dim)
    assert "fresh initialization" in (tmp_path / "info.txt").read_text()
    cfg = load_config(str(tmp_path / "config_cfg.py"))
    assert cfg.num_classes == len(charset) and cfg.dn_labelbook_size == len(charset) + 1
    assert cfg.hidden_dim == TINY.hidden_dim and cfg.encoder_type == "windowed"


def test_from_a_pretraining_runs_directory(tmp_path):
    """--pretrain_dir a port pretraining run's output_dir: the finetune
    starts from its newest checkpoint's parameters (the trunk the head-only
    stage leaves as it was)."""
    from test_torch_pretrain import OPTIONS as PRE_OPTIONS, make_lines_with_boxes

    lines = make_lines_with_boxes(tmp_path)
    pre = tmp_path / "pre"
    pretrain.main(["--lines", str(lines), "--output_dir", str(pre), "--epochs", "1",
                   "--steps_per_epoch", "1", "--device", "cpu", "--compute_dtype", "float32",
                   "--options", *PRE_OPTIONS, *SMALL])
    trunk = ckpt.restore_checkpoint(str(pre / "checkpoint"))["params"]
    out = tmp_path / "ft"
    res = finetune.main(["--lines", str(lines), "--output_dir", str(out), "--device", "cpu",
                         "--epochs", "1", "--pretrain_dir", str(pre), "--options", *OPTIONS,
                         *SMALL])
    assert res["train"]["iterations"] == 2
    saved = ckpt.restore_checkpoint(str(out / "checkpoint"))["params"]
    name = "transformer.encoder_layer_0.linear1.weight"
    assert torch.equal(saved[name], trunk[name])
    assert not torch.equal(saved["class_embed.fc.weight"], trunk["class_embed.fc.weight"])
    # a directory without a checkpoint keeps the fresh start
    res = finetune.main(["--lines", str(lines), "--output_dir", str(tmp_path / "ft2"),
                         "--device", "cpu", "--epochs", "1", "--pretrain_dir",
                         str(tmp_path / "nowhere"), "--full_model", "--options", *OPTIONS,
                         "max_iterations=1", *SMALL])
    assert "fresh initialization" in (tmp_path / "ft2" / "info.txt").read_text()


def test_config_file_on_the_hwdb_stream(tmp_path):
    """-c HWDB_full_TPU.py --dataset_file HWDB_synth, as
    scripts/round5_chain.sh runs it, at TINY: the class count is the
    bank's characters, the label book the Chinese family's (no offset),
    the run's config_cfg.py records both."""
    root = bank_root(tmp_path / "data")
    out = tmp_path / "run"
    res = finetune.main([
        "-c", "dtlr_tpu_torch/configs/HWDB_full_TPU.py", "--dataset_file", "HWDB_synth",
        "--data_root", root, "--output_dir", str(out), "--device", "cpu", "--epochs", "1",
        "--options", "num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2",
        "dec_layers=2", "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32",
        "batch_size=2", "max_iterations=1", "eval_epoch=1", "eval_set_size=2",
        "max_targets=16", "data_aug_scales=[64]", "data_aug_max_size=256",
        "image_w_max=256", "image_h_max=64", "hwdb_glyphs_per_line=[3,5]"])
    assert res["train"]["iterations"] == 1 and np.isfinite(res["train"]["loss"])
    assert res["eval"]["n"] == 2 and {"ar", "cr", "max_conf"} <= set(res["eval"])
    saved = ckpt.restore_checkpoint(str(out / "checkpoint"))["params"]
    n = len(bank_chars())
    assert saved["class_embed.fc.weight"].shape[0] == n
    assert saved["label_enc"].shape[0] == n + 1
    cfg = load_config(str(out / "config_cfg.py"))
    assert (cfg.num_classes, cfg.dn_labelbook_size, cfg.lr) == (n, n, 1e-5)
    assert "compilation_cache_dir" in (out / "info.txt").read_text()
