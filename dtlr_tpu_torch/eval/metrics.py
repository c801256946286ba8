"""Recognition metrics (counterpart of dtlr_tpu/eval/metrics.py): CER and
WER, the Levenshtein distance over characters or space-split words
divided by the ground truth's length, averaged over lines (``mean_cer``,
``mean_wer``) or summed over a corpus after the reference's string
standardization (``corpus_cer``, ``corpus_wer``); AR and CR of the
Chinese lines (``ar_cr``) and SER and WA of the ciphers (``ser_wa``)
over label sequences (reference evaluation.py:214-292, 543-582).

The distance and the edit operations run in the native host runtime
(``runtime/native.py``), as the JAX package's do; ``levenshtein_plain``
and ``edit_operations_plain`` are their numpy versions."""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences of hashable items."""
    from ..runtime import native

    return native.levenshtein(a, b)


def levenshtein_plain(a: Sequence, b: Sequence) -> int:
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


def edit_operations(pred: Sequence, gt: Sequence) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) turning ``pred`` into ``gt``
    along one DP backtrace (reference evaluation.py:242-284): a deletion
    is a ground-truth item the prediction lacks."""
    from ..runtime import native

    return native.edit_ops(pred, gt)


def edit_operations_plain(pred: Sequence, gt: Sequence) -> Tuple[int, int, int]:
    m, n = len(pred), len(gt)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            c = 0 if pred[i - 1] == gt[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + c)
    i, j = m, n
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (pred[i - 1] != gt[j - 1]):
            subs += int(pred[i - 1] != gt[j - 1])
            i, j = i - 1, j - 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            dels += 1
            j -= 1
        else:
            ins += 1
            i -= 1
    return subs, dels, ins


def process_gt_string(s: str) -> str:
    """The reference's ground-truth clean-up (evaluation.py:414-427)."""
    s = s.replace("B B C", "BBC")
    s = s.replace("I T V", "ITV")
    s = s.replace(" -", "-")
    s = s.replace("- ", "-")
    s = s.replace(" -", "-")
    s = s.replace("- ", "-")
    s = s.replace(" .", ".")
    s = s.replace(" ,", ",")
    s = s.replace(" '", "'")
    s = s.replace("' ", "'")
    s = re.sub(r"(\d), (\d)", r"\1,\2", s)
    s = re.sub(r"(?<=\S)€(?=\S)", " € ", s)
    return s


def process_pred_string(s: str) -> str:
    """The reference's prediction clean-up (evaluation.py:430-450), which
    the corpus metrics apply to predictions and ground truths alike."""
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


standardize = process_pred_string


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


def ar_cr(pred_labels: List[Sequence[int]], gt_labels: List[Sequence[int]]):
    """Accurate and correct rates of the Chinese lines, means over lines
    (reference evaluation.py:560-571): AR = 1 - CER, CR = (len - del -
    sub) / len."""
    ars, crs = [], []
    for p, g in zip(pred_labels, gt_labels):
        p, g = list(p), list(g)
        ars.append(1.0 - levenshtein(p, g) / max(len(g), 1))
        s, d, _ = edit_operations(p, g)
        crs.append((len(g) - d - s) / max(len(g), 1))
    n = max(len(ars), 1)
    return sum(ars) / n, sum(crs) / n


def ser_wa(pred_labels: List[Sequence[int]], gt_labels: List[Sequence[int]]):
    """Symbol error rate and positional word accuracy of the ciphers,
    means over lines (reference evaluation.py:214-241, 573-582)."""
    sers, was = [], []
    for p, g in zip(pred_labels, gt_labels):
        p, g = list(p), list(g)
        sers.append(levenshtein(p, g) / max(len(g), 1))
        was.append(sum(1 for k in range(min(len(p), len(g))) if p[k] == g[k]) / max(len(g), 1))
    n = max(len(sers), 1)
    return sum(sers) / n, sum(was) / n
