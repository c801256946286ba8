"""CER and WER (counterpart of the Latin metrics of
dtlr_tpu/eval/metrics.py): Levenshtein distance over characters or
space-split words, divided by the ground truth's length, averaged over
lines."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    ids: dict = {}
    b_arr = np.asarray([ids.setdefault(x, len(ids)) for x in b], np.int64)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i, ca in enumerate(a, start=1):
        cur = np.empty_like(prev)
        cur[0] = i
        # substitutions and deletions vectorized; insertions need the
        # sequential pass below
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b_arr != ids.setdefault(ca, len(ids))))
        for j in range(1, len(b) + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[-1])


def cer(pred: str, gt: str) -> float:
    gt = gt if len(gt) else " "
    return levenshtein(list(pred), list(gt)) / max(len(gt), 1)


def wer(pred: str, gt: str) -> float:
    g = gt.split(" ")
    return levenshtein(pred.split(" "), g) / max(len(g), 1)


def mean_cer(preds: List[str], gts: List[str]) -> float:
    vals = [cer(p, g) for p, g in zip(preds, gts)]
    return sum(vals) / max(len(vals), 1)


def mean_wer(preds: List[str], gts: List[str]) -> float:
    vals = [wer(p, g) for p, g in zip(preds, gts)]
    return sum(vals) / max(len(vals), 1)
