"""CER and WER (counterpart of the Latin metrics of
dtlr_tpu/eval/metrics.py): Levenshtein distance over characters or
space-split words, divided by the ground truth's length, averaged over
lines (``mean_cer``, ``mean_wer``) or summed over a corpus after the
reference's string standardization (``corpus_cer``, ``corpus_wer``,
which the training loop's evaluation reports)."""

from __future__ import annotations

import re
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


def standardize(s: str) -> str:
    """The reference's ``process_pred_string``, applied to predictions and
    ground truths alike before a corpus CER."""
    s = s.replace("B B C", "BBC")
    s = s.replace("I T V", "ITV")
    s = s.replace("  ", " ")
    s = s.replace(" -", "-")
    s = s.replace("- ", "-")
    s = s.replace(" .", ".")
    s = s.replace(" ,", ",")
    s = re.sub(r"(\d), (\d)", r"\1,\2", s)
    s = s.replace(" '", "'")
    s = s.replace("' ", "'")
    s = re.sub(r"(?<=\S)€(?=\S)", " € ", s)
    s = re.sub(r"(?<!\.)\.\.(?!\.)", ".", s)
    s = s.replace(",,", ",")
    return s


def corpus_cer(preds: List[str], gts: List[str]) -> float:
    """Sum of character distances over the sum of lengths, standardized."""
    num = den = 0
    for p, g in zip(preds, gts):
        p, g = standardize(p), standardize(g)
        num += levenshtein(list(p), list(g))
        den += len(g)
    return num / max(den, 1)


def corpus_wer(preds: List[str], gts: List[str]) -> float:
    """Sum of word distances over the sum of word counts, standardized."""
    num = den = 0
    for p, g in zip(preds, gts):
        p, g = standardize(p), standardize(g)
        num += levenshtein(p.split(" "), g.split(" "))
        den += len(g.split(" "))
    return num / max(den, 1)
