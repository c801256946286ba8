"""The port's detection pretraining entry point (``python -m
dtlr_tpu_torch.train.pretrain``) on the CPU at the tiny geometry
(``TINY`` with the 166-class head of the pretraining trunk): two steps
of the detection trainer on 128x256 crops of the detection fixture's
lines (their character boxes carried into the crop), the save, the
exported weights and the detection-loss evaluation; JAX's loop: a
two-epoch run with its evaluations, then a resume whose state is the
saved one exactly, ``--eval``, the deadlines and ``--train_seed``; the
class count and label book that a config family derives from the
charset, against JAX's own entry point. What is checked is the plumbing;
test_torch_detection_step.py holds the numbers to JAX's.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.config import load_config
from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train import engine, pretrain
from test_torch_hwdb_synth import bank_chars, bank_root
from test_torch_model import TINY
from test_torch_smoke_detect import FIXTURE

OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
           "dim_feedforward=64", "encoder_win=8", "batch_size=2", "print_freq=1",
           "warmup_steps=0", "max_targets=16"]
NUM_CLASSES, WIDTH = 166, 256
#: 64x128 batches, for the loop's runs (the recipe pads to 1024 columns)
SMALL = ["data_aug_scales=[64]", "data_aug_max_size=128", "image_w_max=128",
         "image_h_max=64", "eval_set_size=2"]
#: TINY in a config file's keys (JAX's --options)
TINY_KEYS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
             "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32", "batch_size=2",
             "print_freq=1", "max_targets=16", "dn_number=3", *SMALL]


def make_lines_with_boxes(d):
    """Four 128xWIDTH crops of the detection fixture, each keeping the
    characters that lie inside it, in ``d``/lines.npz."""
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
    return d / "lines.npz"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A TINY snapshot with the trunk's 166 classes and label book, and
    four crops of the detection fixture (``make_lines_with_boxes``)."""
    d = tmp_path_factory.mktemp("pretrain")
    torch.manual_seed(0)
    model = build_dino(dataclasses.replace(TINY, dn_labelbook_size=NUM_CLASSES + 1),
                       NUM_CLASSES, device="cpu")
    np.savez(d / "tiny.npz", **ckpt.params_to_flax(dict(model.named_parameters())))
    lines = load_lines(FIXTURE)
    make_lines_with_boxes(d)
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
                          "--output_dir", str(out), "--epochs", "1", "--steps_per_epoch", "2",
                          "--device", "cpu",
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


def loop(files, out, *extra, lines="lines.npz"):
    """The loop from a fresh start: epochs of one step, evaluated each."""
    return pretrain.main(["--lines", str(files / lines), "--output_dir", str(out),
                          "--steps_per_epoch", "1", "--eval_every", "1", "--device", "cpu",
                          "--compute_dtype", "float32", *extra,
                          "--options", *OPTIONS, *SMALL])


def assert_same(a, b, where=""):
    """Equal exactly: tensors bit for bit, containers key for key."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


def test_two_epochs_then_a_resume_restores_the_state_exactly(files, tmp_path, monkeypatch):
    """Two epochs, each saved and evaluated (raw and EMA weights); then
    the same run with three epochs resumes the saved state, parameters,
    optimizer state, EMA, step and epoch exactly, and runs the third
    epoch. The data stream is not checkpointed, in JAX either."""
    res = loop(files, tmp_path, "--epochs", "2")
    assert [e["epoch"] for e in res["epochs"]] == [0, 1] and res["resumed"] is None
    for e in res["epochs"]:
        assert [r["tag"] for r in e["evals"]] == ["eval", "eval_ema"]
        assert {"cer", "nms_cer", "max_conf", "nq@0.3", "wer"} <= set(e["evals"][0])
    saved = ckpt.restore_checkpoint(str(tmp_path / "checkpoint"))
    assert (saved["step"], saved["epoch"]) == (2, 2)
    restored = {}
    orig = engine.Trainer.try_resume

    def spy(self, name="checkpoint"):
        ok = orig(self, name)
        restored.update(copy.deepcopy(self.checkpoint_state()))
        return ok

    monkeypatch.setattr(engine.Trainer, "try_resume", spy)
    res = loop(files, tmp_path, "--epochs", "3")
    assert res["resumed"]["epoch"] == 2 and res["resumed"]["step"] == 2
    assert_same({k: restored[k] for k in ("params", "opt_state", "ema_params")},
                {k: saved[k] for k in ("params", "opt_state", "ema_params")})
    assert (restored["step"], restored["epoch"]) == (2, 2)
    assert [e["epoch"] for e in res["epochs"]] == [2]
    assert ckpt.restore_checkpoint(str(tmp_path / "checkpoint"))["step"] == 3
    log = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert sum("eval_ema" in r for r in log) == 3

    # --eval: the held-out set read with the resumed weights, nothing trained
    res = loop(files, tmp_path, "--epochs", "3", "--eval")
    assert [r["tag"] for r in res["evals"]] == ["eval"] and res["evals"][0]["epoch"] == 3
    assert ckpt.latest_step(str(tmp_path / "checkpoint")) == 3


def test_deadlines(files, tmp_path):
    """A deadline file read after every epoch stops the run after the
    epoch that passes it; missing or unreadable, --deadline holds."""
    args = pretrain.parse_args(["--deadline", "5", "--deadline_file", str(tmp_path / "lease")])
    assert pretrain.effective_deadline(args) == 5.0
    (tmp_path / "lease").write_text("not a time")
    assert pretrain.effective_deadline(args) == 5.0
    (tmp_path / "lease").write_text("1.5\n")
    assert pretrain.effective_deadline(args) == 1.5
    res = loop(files, tmp_path / "run", "--epochs", "3", "--eval_every", "9",
               "--deadline_file", str(tmp_path / "lease"))
    assert [e["epoch"] for e in res["epochs"]] == [0]
    assert "deadline reached after epoch 0" in (tmp_path / "run" / "info.txt").read_text()
    res = loop(files, tmp_path / "run2", "--epochs", "2", "--eval_every", "9",
               "--deadline", "1")
    assert [e["epoch"] for e in res["epochs"]] == [0]


def test_train_seed_moves_the_training_stream_alone(tmp_path, monkeypatch):
    """--train_seed seeds the training stream and its batcher; the held-out
    stream and its batcher stay on --seed (+1 and +7), as in JAX."""
    root = bank_root(tmp_path / "data")
    streams, batchers = [], []
    orig_stream, orig_batcher = pretrain.hwdb_stream, pretrain.make_batcher
    monkeypatch.setattr(pretrain, "hwdb_stream",
                        lambda root, seed, *a: streams.append(seed) or orig_stream(root, seed, *a))
    monkeypatch.setattr(pretrain, "make_batcher",
                        lambda cfg, src, train, seed, *a, **k:
                        batchers.append((train, seed)) or orig_batcher(cfg, src, train, seed,
                                                                       *a, **k))
    for train_seed in ([], ["--train_seed", "9"]):
        streams.clear(), batchers.clear()
        pretrain.main(["-c", "dtlr_tpu_torch/configs/Chinese_TPU.py", "--dataset_file",
                       "HWDB_synth", "--data_root", root, "--output_dir",
                       str(tmp_path / f"run{len(train_seed)}"), "--epochs", "0", "--seed", "3",
                       "--device", "cpu", *train_seed, "--options", *TINY_KEYS,
                       "hwdb_glyphs_per_line=[3,5]"])
        want = 9 if train_seed else 3
        assert streams == [want, 4]
        assert batchers == [(True, want), (False, 10)]


class _Stop(Exception):
    pass


def derived_classes(monkeypatch, tmp_path, config, dataset, jax_side):
    """The class count and label book that a run derives, from its dumped
    config_cfg.py, its Trainer stopped where the model would be built."""
    out = tmp_path / ("jax" if jax_side else "port")
    if jax_side:
        from dtlr_tpu.train import pretrain as jax_pretrain

        def stop(*a, **k):
            raise _Stop

        monkeypatch.setattr(jax_pretrain, "Trainer", stop)
        argv = ["-c", f"dtlr_tpu/configs/{config}", "--output_dir", str(out), *dataset,
                "--options", "eval_set_size=1", "hwdb_glyphs_per_line=[3,5]"]
        with pytest.raises(_Stop):
            jax_pretrain.main(argv)
    else:
        def stop(self, *a, **k):
            raise _Stop

        monkeypatch.setattr(engine.Trainer, "build", stop)
        argv = ["-c", f"dtlr_tpu_torch/configs/{config}", "--output_dir", str(out), *dataset,
                "--device", "cpu", "--options", *TINY_KEYS, "hwdb_glyphs_per_line=[3,5]"]
        with pytest.raises(_Stop):
            pretrain.main(argv)
    cfg = load_config(str(out / "config_cfg.py"))
    return cfg.num_classes, cfg.dn_labelbook_size


def test_class_count_and_label_book_as_jax_derives_them(files, tmp_path, monkeypatch):
    """Latin keeps the label book one past the class count, Chinese none
    past it (dtlr_tpu/train/pretrain.py:201-212): JAX's entry point on its
    own streams (the Latin renderer's 166 characters, the HWDB bank)
    against the port's (the fixture lines' 166 characters, the same
    bank), each read from the run's dumped config."""
    root = bank_root(tmp_path / "data")
    hwdb = ["--dataset_file", "HWDB_synth", "--data_root", root]
    n = len(bank_chars())
    jax = derived_classes(monkeypatch, tmp_path, "Chinese_TPU.py", hwdb, True)
    assert jax == derived_classes(monkeypatch, tmp_path, "Chinese_TPU.py", hwdb, False) == (n, n)
    jax = derived_classes(monkeypatch, tmp_path / "latin", "Latin_TPU.py",
                          ["--dataset_file", "synthetic_line_OCR_general"], True)
    port = derived_classes(monkeypatch, tmp_path / "latin", "Latin_TPU.py",
                           ["--lines", str(files / "lines.npz")], False)
    assert jax == port == (NUM_CLASSES, NUM_CLASSES + 1)


def test_config_file_run_lists_the_keys_it_does_not_read(files, tmp_path):
    """-c Latin_TPU.py with --lines: a fresh start sized by the lines'
    charset, the config's keys that the port does not read in the log,
    the run's config_cfg.py with the derived class count; a config
    whose model the port lacks (a backbone JAX does not know) is refused."""
    res = pretrain.main(["-c", "dtlr_tpu_torch/configs/Latin_TPU.py", "--lines",
                         str(files / "lines.npz"), "--output_dir", str(tmp_path),
                         "--epochs", "1", "--steps_per_epoch", "1", "--eval_every", "1",
                         "--device", "cpu", "--options", *TINY_KEYS])
    assert res["epochs"][0]["train"]["iterations"] == 1
    assert (res["num_classes"], res["dn_labelbook_size"]) == (NUM_CLASSES, NUM_CLASSES + 1)
    info = (tmp_path / "info.txt").read_text()
    assert "config keys the port does not read" in info and "compilation_cache_dir" in info
    cfg = load_config(str(tmp_path / "config_cfg.py"))
    assert (cfg.num_classes, cfg.epochs, cfg.steps_per_epoch) == (NUM_CLASSES, 1, 1)
    with pytest.raises(NotImplementedError, match="backbone in"):
        pretrain.main(["-c", "dtlr_tpu_torch/configs/Latin.py", "--lines",
                       str(files / "lines.npz"), "--output_dir", str(tmp_path / "swin"),
                       "--device", "cpu", "--options", "backbone=swin_X_224_1k"])
