"""Both training entry points over two data-parallel ranks on the CPU:
``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
dtlr_tpu_torch.train.pretrain --device cpu`` (and ``finetune``) at the
tiny geometry on test_torch_pretrain.py's files (a 166-class snapshot,
four 128x256 crops of the detection fixture), with no flag of their own.

Checked: one run directory's files are written once (one checkpoint per
save, ``log.txt`` with one line per record, ``info.txt`` from rank 0
and ``info_rank1.txt`` from rank 1); a deadline stops both ranks after
the same epoch; the run resumed from that epoch restores on both ranks
the state that was saved, bit for bit, which is the uninterrupted run's
state after that epoch (two runs of the same command step alike); the
two ranks' evaluation of a held-out set equals one process's on the
same weights (the strings' metrics exactly, the float means to 1e-4);
a batch size that two ranks do not split is refused. Each launch has
a time limit, and each rank ``cores / (xdist workers x ranks)`` threads;
the runs' files are removed after their tests.
"""

import json
import re
import shutil

import numpy as np
import pytest

from dtlr_tpu_torch.parallel import launch
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train import pretrain
from test_torch_ddp_step import RANKS, rank_threads
from test_torch_finetune import OPTIONS as FT_OPTIONS
from test_torch_pretrain import OPTIONS, SMALL, files  # noqa: F401 (fixture)

LAUNCH_TIMEOUT = 300
#: the evaluation's float means and maxima, relative: a rank's forward
#: runs on 1 line where one process's runs on 2, and the convolutions sum
#: in another order (measured 4.9e-6 on max_conf at one thread a rank)
EVAL_REL = 1e-4
EXACT = ("cer", "nms_cer", "wer", "n", "nq@0.05", "nq@0.1", "nq@0.2", "nq@0.3")


def pretrain_args(files, out, *extra):
    return ["--lines", str(files / "lines.npz"), "--output_dir", str(out),
            "--steps_per_epoch", "1", "--eval_every", "1", "--device", "cpu",
            "--compute_dtype", "float32", *extra, "--options", *OPTIONS, *SMALL]


def ranks(module, args):
    return launch.launch(RANKS, module, args, timeout=LAUNCH_TIMEOUT, threads=rank_threads())


def ranks_ok(module, args):
    done = ranks(module, args)
    assert done.returncode == 0, done.stderr[-4000:]
    return done


def log_records(out):
    return [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """The uninterrupted two-epoch run, the same command stopped by a
    deadline after epoch 0, and that run resumed to the end."""
    whole, cut = tmp_path_factory.mktemp("whole"), tmp_path_factory.mktemp("cut")
    ranks_ok("dtlr_tpu_torch.train.pretrain", pretrain_args(files, whole, "--epochs", "2"))
    ranks_ok("dtlr_tpu_torch.train.pretrain",
             pretrain_args(files, cut, "--epochs", "2", "--deadline", "1"))
    cut_state = ckpt.restore_checkpoint(str(cut / "checkpoint"))
    ranks_ok("dtlr_tpu_torch.train.pretrain", pretrain_args(files, cut, "--epochs", "2"))
    yield whole, cut, cut_state
    # each checkpoint of the train state takes hundreds of MB
    for path in (whole, cut):
        shutil.rmtree(path, ignore_errors=True)


def test_run_files_are_written_once(runs):
    whole, _, _ = runs
    assert ckpt._steps(str(whole / "checkpoint")) == [1, 2]
    assert not [p for p in whole.rglob("*.tmp")]
    assert sorted(p.name for p in whole.glob("info*.txt")) == ["info.txt", "info_rank1.txt"]
    records = log_records(whole)
    # per epoch: the train stats, the raw and the EMA evaluation; then the
    # final detection evaluation's
    assert [sorted(set(r) - {"epoch"}) for r in records] == (
        [[k for k in sorted(records[0]) if k != "epoch"], ["eval"], ["eval_ema"]] * 2
        + [["eval"]])
    # an epoch's evaluations carry the count of epochs done
    assert [r["epoch"] for r in records] == [0, 1, 1, 1, 2, 2, 2]
    assert records[0]["iterations"] == 1 and records[0]["skipped"] == 0.0
    assert np.isfinite(records[3]["loss"]) and np.isfinite(records[3]["loss_ce_dn"])
    assert (whole / "params.npz").exists() and (whole / "config_cfg.py").exists()
    assert "saved checkpoint" in (whole / "info.txt").read_text()
    assert "saved checkpoint" not in (whole / "info_rank1.txt").read_text()


def test_deadline_stops_both_ranks_after_the_same_epoch(runs):
    _, cut, cut_state = runs
    assert (cut_state["step"], cut_state["epoch"]) == (1, 1)
    for name in ("info.txt", "info_rank1.txt"):
        text = (cut / name).read_text()
        assert text.count("wall-clock deadline reached after epoch 0") == 1, name


def test_resume_restores_the_saved_state_on_both_ranks(runs):
    """Both ranks log the sha256 of the state they resumed: the one the
    cut run saved, and the one the uninterrupted run saved after the same
    epoch."""
    whole, cut, cut_state = runs
    want = ckpt.state_sha256(cut_state)
    assert want == ckpt.state_sha256(ckpt.restore_checkpoint(str(whole / "checkpoint"), 1))
    for name in ("info.txt", "info_rank1.txt"):
        found = re.findall(r"resumed state sha256 (\w+)", (cut / name).read_text())
        assert found == [want], name
    resumed = ckpt.restore_checkpoint(str(cut / "checkpoint"))
    assert (resumed["step"], resumed["epoch"]) == (2, 2)


def test_two_ranks_evaluate_as_one_process(files, runs):
    """The uninterrupted run's last evaluation (two ranks, the weights of
    its last checkpoint) against ``--eval`` in this process on the same
    checkpoint."""
    whole, _, _ = runs
    two = [r for r in log_records(whole) if "eval" in r and r["epoch"] == 2][0]["eval"]
    one = pretrain.main(pretrain_args(files, whole, "--epochs", "2", "--eval"))["evals"][0]
    assert set(one) - {"epoch", "tag"} == set(two)
    for k, v in two.items():
        if k in EXACT:
            assert v == one[k], (k, v, one[k])
        else:
            assert abs(v - one[k]) <= EVAL_REL * max(abs(one[k]), 1e-6), (k, v, one[k])


def test_finetune_over_two_ranks(files, tmp_path):
    """Stage 1 from the 166-class snapshot, its class heads rebuilt for
    the lines' charset, the whole model trained, then evaluated."""
    out = tmp_path / "ft"
    ranks_ok("dtlr_tpu_torch.train.finetune",
             ["--lines", str(files / "lines.npz"), "--output_dir", str(out), "--device",
              "cpu", "--epochs", "1", "--pretrain_dir", str(files / "tiny.npz"),
              "--full_model", "--new_class_embedding", "--options", *FT_OPTIONS, *SMALL[:-1]])
    records = log_records(out)
    assert [sorted(r) for r in records] == [sorted(records[0]), ["epoch", "eval"]]
    assert records[0]["iterations"] == 2 and np.isfinite(records[0]["loss"])
    assert records[1]["eval"]["n"] == 4
    assert ckpt._steps(str(out / "checkpoint")) == [2]
    assert ckpt._steps(str(out / "checkpoint_best_regular")) == [2]
    assert sorted(p.name for p in out.glob("info*.txt")) == ["info.txt", "info_rank1.txt"]
    shutil.rmtree(out)


def test_a_batch_size_two_ranks_do_not_split_is_refused(files, tmp_path):
    done = ranks("dtlr_tpu_torch.train.pretrain",
                 pretrain_args(files, tmp_path, "--epochs", "1") + ["batch_size=3"])
    assert done.returncode != 0
    assert "batch_size 3 is the global batch" in done.stderr + done.stdout
    assert "batch_size 2 or 4" in done.stderr + done.stdout
    assert not (tmp_path / "checkpoint").exists()
