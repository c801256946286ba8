"""The port's metrics (dtlr_tpu_torch/eval/metrics.py) against the JAX
package's (dtlr_tpu/eval/metrics.py) on seeded strings and label
sequences: equal values (both are exact integer arithmetic divided the
same way). The JAX package's edit operations take its C++ helper when it
is built; the port's DP backtrace must agree with it operation for
operation."""

import numpy as np
import pytest

from dtlr_tpu.eval import metrics as J
from dtlr_tpu_torch.eval import metrics as T

ALPHABET = list("abcde .,-'0123€") + ["BBC", "B B C", "I T V", ".."]


def strings(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 30))
        out.append("".join(rng.choice(ALPHABET, k)) if k else "")
    return out


def label_lists(seed, n=40):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 7, int(rng.integers(0, 25)))) for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_edit_operations(seed):
    for p, g in zip(strings(seed), strings(seed + 10)):
        assert T.edit_operations(list(p), list(g)) == J.edit_operations(list(p), list(g))
    for p, g in zip(label_lists(seed), label_lists(seed + 10)):
        assert T.edit_operations(p, g) == J.edit_operations(p, g)


@pytest.mark.parametrize("seed", range(3))
def test_string_metrics(seed):
    preds, gts = strings(seed), strings(seed + 20)
    for name in ("mean_cer", "mean_wer", "corpus_cer", "corpus_wer"):
        assert getattr(T, name)(preds, gts) == getattr(J, name)(preds, gts), name
    for s in preds + gts:
        assert T.process_gt_string(s) == J.process_gt_string(s)
        assert T.process_pred_string(s) == J.process_pred_string(s)
        assert T.standardize(s) == J.standardize(s)
        assert T.levenshtein(list(s), list(gts[0])) == J.levenshtein(list(s), list(gts[0]))


@pytest.mark.parametrize("seed", range(3))
def test_ar_cr_and_ser_wa(seed):
    preds, gts = label_lists(seed), label_lists(seed + 30)
    assert T.ar_cr(preds, gts) == J.ar_cr(preds, gts)
    assert T.ser_wa(preds, gts) == J.ser_wa(preds, gts)
    assert T.ar_cr([], []) == J.ar_cr([], [])
