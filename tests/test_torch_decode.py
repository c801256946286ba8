"""The port's reader against dtlr_tpu's: blank synthesis, greedy decode,
the flattened top-k, NMS and the NMS decode, and CER/WER. Ties are
built in (equal box x-centres, equal scores) because jnp.argsort and
lax.top_k are stable and the port must order ties the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.eval import decode as jdec
from dtlr_tpu.eval import metrics as jmet
from dtlr_tpu.ops.ctc import blank_synthesis as jax_blank_synthesis
from dtlr_tpu.ops.nms import nms_mask as jax_nms_mask
from dtlr_tpu_torch.eval import decode as tdec
from dtlr_tpu_torch.eval import metrics as tmet
from dtlr_tpu_torch.ops.ctc import blank_synthesis
from dtlr_tpu_torch.ops.nms import batched_nms_mask

B, NQ, K = 3, 40, 12


def outputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(-3.0, 2.5, (B, NQ, K)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.05, 0.95, (B, NQ, 2)),
                            rng.uniform(0.02, 0.2, (B, NQ, 2))], -1).astype(np.float32)
    boxes[:, 5, 0] = boxes[:, 6, 0]       # equal x-centres: a sort tie
    logits[:, 7] = logits[:, 8]           # equal scores: a top-k tie
    boxes[:, 7] = boxes[:, 8]
    return logits, boxes


@pytest.mark.parametrize("eps", [0.003, 0.03 / K])
def test_blank_synthesis_matches_jax(eps):
    logits, boxes = outputs()
    got = blank_synthesis(torch.from_numpy(logits), torch.from_numpy(boxes), eps)
    want = jax_blank_synthesis(jnp.asarray(logits), jnp.asarray(boxes), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_jax(seed):
    logits, boxes = outputs(seed)
    got = tdec.greedy_decode(torch.from_numpy(logits), torch.from_numpy(boxes))
    want = jdec.greedy_decode(jnp.asarray(logits), jnp.asarray(boxes))
    np.testing.assert_array_equal(got, want)
    assert tdec.greedy_labels(got) == jdec.greedy_labels(want)


def test_postprocess_topk_matches_jax():
    logits, boxes = outputs()
    got = tdec.postprocess_topk(torch.from_numpy(logits), torch.from_numpy(boxes), 50)
    want = jdec.postprocess_topk(jnp.asarray(logits), jnp.asarray(boxes), 50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("thr", [0.1, 0.4, 0.7])
def test_nms_mask_matches_jax(thr):
    _, boxes = outputs()
    xyxy = np.concatenate([boxes[0, :, :2] - boxes[0, :, 2:] / 2,
                           boxes[0, :, :2] + boxes[0, :, 2:] / 2], -1) * 0.3
    scores = np.random.default_rng(4).uniform(size=NQ).astype(np.float32)
    got = batched_nms_mask(torch.from_numpy(xyxy)[None], torch.from_numpy(scores)[None], thr)[0]
    want = jax_nms_mask(jnp.asarray(xyxy), jnp.asarray(scores), thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < NQ  # some boxes suppressed, some kept


@pytest.mark.parametrize("th,nms", [(0.1, 0.4), (0.3, 0.5), (0.05, 0.2)])
def test_nms_decode_matches_jax(th, nms):
    logits, boxes = outputs(1)
    got = tdec.nms_decode(torch.from_numpy(logits), torch.from_numpy(boxes), th, nms)
    want = jdec.nms_decode(jnp.asarray(logits), jnp.asarray(boxes), th, nms)
    assert got == want
    assert any(got)


@pytest.mark.parametrize("pred,gt", [("the scikit learn", "the scikit-learn"),
                                     ("", "one"), ("abc", ""), ("K5R", "K5R"),
                                     ("welcome a bug", "welcome a bug report"),
                                     ("xzWp4I bqE", "xzWp4 I bqE MI")])
def test_cer_wer_match_jax(pred, gt):
    assert tmet.levenshtein(list(pred), list(gt)) == jmet.levenshtein(list(pred), list(gt))
    assert tmet.cer(pred, gt) == jmet.cer(pred, gt)
    assert tmet.wer(pred, gt) == jmet.wer(pred, gt)
    assert tmet.mean_cer([pred, gt], [gt, gt]) == jmet.mean_cer([pred, gt], [gt, gt])
    assert tmet.mean_wer([pred, gt], [gt, gt]) == jmet.mean_wer([pred, gt], [gt, gt])
