"""The port's logging utilities (dtlr_tpu_torch/utils/logging_utils.py)
against dtlr_tpu/utils/logging_utils.py on the same updates and
messages: ``SmoothedValue``'s window and global means, ``MetricLogger``'s
means, its line and ``log_every``'s lines, ``append_log_line``'s JSON
lines, and ``setup_logger``'s files (``info.txt`` on rank 0,
``info_rank{r}.txt`` on rank r) and line format, the time aside. The
port's loggers are kept apart per run directory, so that two runs in one
process do not write into each other's files (JAX's keeps the first
directory's handlers for a name)."""

import json
import re

import numpy as np
import pytest

from dtlr_tpu.utils import logging_utils as jax_logging
from dtlr_tpu_torch.utils import logging_utils as port_logging

UPDATES = np.random.default_rng(3).normal(2.0, 1.5, 57).tolist()


@pytest.mark.parametrize("window", [1, 5, 20])
def test_smoothed_value_is_jax(window):
    a, b = jax_logging.SmoothedValue(window), port_logging.SmoothedValue(window)
    for i, v in enumerate(UPDATES):
        n = 1 + i % 3
        a.update(v, n)
        b.update(v, n)
        assert (a.avg, a.global_avg, a.count) == (b.avg, b.global_avg, b.count)
    assert list(a.deque) == list(b.deque)


def strip_time(text):
    return re.sub(r"^\[\d\d:\d\d:\d\d ", "[", text, flags=re.M)


def test_metric_logger_is_jax(tmp_path):
    a, b = jax_logging.MetricLogger(), port_logging.MetricLogger()
    for i, v in enumerate(UPDATES):
        kw = {"loss": v, "loss_ce": v / 3, "cer": i % 2, "other": -v}
        a.update(**kw)
        b.update(**kw)
    assert str(a) == str(b)
    assert {k: (m.avg, m.global_avg) for k, m in a.meters.items()} == \
        {k: (m.avg, m.global_avg) for k, m in b.meters.items()}
    logs = []
    for mod, name in ((jax_logging, "jax_every"), (port_logging, "port_every")):
        logger = mod.setup_logger(str(tmp_path / name), name)
        mlog = mod.MetricLogger()
        for i, v in mlog.log_every(range(7), 3, logger, header="hdr"):
            mlog.update(loss=UPDATES[v], cer=v)
        logs.append((tmp_path / name / "info.txt").read_text())
    drop_times = lambda s: re.sub(r"(iter_t: |done in )[\d.]+", r"\1T", strip_time(s))
    jax_lines, port_lines = (drop_times(t).replace(n, "N").splitlines()
                             for t, n in zip(logs, ("jax_every", "port_every")))
    assert jax_lines == port_lines and len(port_lines) == 4


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_setup_logger_writes_the_rank_file(tmp_path, rank):
    texts = []
    for mod, name in ((jax_logging, f"jax_{rank}"), (port_logging, f"port_{rank}")):
        out = tmp_path / name
        logger = mod.setup_logger(str(out), name, rank)
        logger.info("epoch 0 it 0: loss=1.0000")
        logger.info("saved checkpoint @2")
        files = sorted(p.name for p in out.iterdir())
        assert files == ["info.txt" if rank == 0 else f"info_rank{rank}.txt"]
        texts.append(strip_time((out / files[0]).read_text()).replace(name, "N"))
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[0] == "[N]: epoch 0 it 0: loss=1.0000"


def test_port_loggers_keep_runs_apart(tmp_path):
    first = port_logging.setup_logger(str(tmp_path / "a"), "run")
    second = port_logging.setup_logger(str(tmp_path / "b"), "run")
    assert first is not second
    assert port_logging.setup_logger(str(tmp_path / "a"), "run") is first
    first.info("to a")
    second.info("to b")
    assert strip_time((tmp_path / "a" / "info.txt").read_text()) == "[run]: to a\n"
    assert strip_time((tmp_path / "b" / "info.txt").read_text()) == "[run]: to b\n"


def test_append_log_line_is_jax(tmp_path):
    records = [{"epoch": 0, "loss": 1.5, "eval": {"cer": 0.25, "n": 4}}, {"epoch": 1}]
    for mod, name in ((jax_logging, "jax"), (port_logging, "port")):
        for r in records:
            mod.append_log_line(str(tmp_path / name), r)
    assert (tmp_path / "jax" / "log.txt").read_text() == (tmp_path / "port" / "log.txt").read_text()
    assert [json.loads(l) for l in (tmp_path / "port" / "log.txt").read_text().splitlines()] \
        == records
