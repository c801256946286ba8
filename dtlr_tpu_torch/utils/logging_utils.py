"""Metric logging (counterpart of dtlr_tpu/utils/logging_utils.py;
reference util/misc.py:32-262 MetricLogger / SmoothedValue,
util/logger.py setup_logger, the JSON-lines log.txt of
main_synthetic.py:405-407).

``setup_logger`` writes to stdout and, under ``output_dir``, to
``info.txt`` on rank 0 and ``info_rank{r}.txt`` on rank r. One logger
serves one (name, directory, rank): a second call for the same returns
it as it is, and a call for another directory gets a logger of its own,
so that two runs in one process do not write into each other's files.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


def setup_logger(output_dir: Optional[str] = None, name: str = "dtlr_tpu_torch",
                 rank: int = 0) -> logging.Logger:
    key = f"{name}|{os.path.abspath(output_dir) if output_dir else ''}|{rank}"
    logger = logging.getLogger(key)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter(f"[%(asctime)s {name}]: %(message)s", datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        suffix = "" if rank == 0 else f"_rank{rank}"
        fh = logging.FileHandler(os.path.join(output_dir, f"info{suffix}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items())
        )

    def log_every(self, iterable: Iterable, print_freq: int, logger, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue()
        last = time.time()
        for i, obj in enumerate(iterable):
            yield i, obj
            iter_time.update(time.time() - last)
            last = time.time()
            if i % print_freq == 0:
                short = self.delimiter.join(
                    f"{k}: {m.avg:.4f}"
                    for k, m in sorted(self.meters.items())
                    if k in ("loss", "loss_CTC", "loss_ce", "loss_bbox", "loss_giou", "cer", "wer")
                )
                logger.info(
                    f"{header} [{i}] {short} iter_t: {iter_time.avg:.3f}s"
                )
        logger.info(f"{header} done in {time.time() - start:.1f}s :: {self}")


def append_log_line(output_dir: str, record: dict):
    """JSON-lines epoch stats (reference main_synthetic.py:405-407)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as fh:
        fh.write(json.dumps(record) + "\n")
