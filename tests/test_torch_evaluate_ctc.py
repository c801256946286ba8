"""``Trainer.evaluate_ctc`` (dtlr_tpu_torch/train/engine.py) against the
JAX package's (dtlr_tpu/train/engine.py) on the same model outputs: the
same seeded logits and boxes per batch go through both, each package's
own decode, metrics and CTC loss.

For a charset without a space (HWDB, the ciphers) both report AR and CR
of the NMS decode and no WER (dtlr_tpu/train/engine.py:372-377,483-489);
with a space, the greedy WER. Every key the port reports is JAX's, with
JAX's value: the metrics exactly, the CTC loss within 1e-5 relative
(two float32 CTC implementations). JAX's report has, besides, the
decode diagnostics that the port does not compute yet (ROADMAP.md,
Queue 1 item 7).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.data.batching import Batch as JaxBatch
from dtlr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from dtlr_tpu.train import engine as jax_engine
from dtlr_tpu_torch.data.batching import Batch
from dtlr_tpu_torch.data.charset import labels_to_text
from dtlr_tpu_torch.train.config import RECIPE
from dtlr_tpu_torch.train.engine import Trainer

NQ, N_LABELS, B, N_BATCHES = 24, 6, 2, 2
#: what JAX's report has besides the port's
JAX_DIAGNOSTICS = {"max_conf", "mean_max_conf", "nq@0.05", "nq@0.1", "nq@0.2", "nq@0.3",
                   "p_gt_matched"}
CHARSETS = {"spaceless": list("abcdefghijklmnopqrst"),
            "with_space": list("abcdefghijklmnopqrs ")}


def outputs_and_batches(charset, seed=0):
    """Per batch seeded (logits, boxes) of NQ queries, the batch's labels
    and texts: background queries mostly below the decode's TH, some
    queries confident in a line's labels in order."""
    rng = np.random.default_rng(seed)
    K = len(charset)
    out = []
    for _ in range(N_BATCHES):
        logits = (2 * rng.standard_normal((B, NQ, K)) - 6).astype(np.float32)
        cx = np.sort(rng.uniform(0.05, 0.95, (B, NQ)), axis=1)
        boxes = np.stack([cx, rng.uniform(0.3, 0.7, (B, NQ)), rng.uniform(0.02, 0.08, (B, NQ)),
                          rng.uniform(0.2, 0.6, (B, NQ))], -1).astype(np.float32)
        labels = rng.integers(0, K, (B, N_LABELS)).astype(np.int32)
        valid = np.zeros((B, N_LABELS), bool)
        valid[0, :4] = valid[1, :6] = True
        texts = [labels_to_text(l[v].tolist(), charset) for l, v in zip(labels, valid)]
        # every fourth query (in x order) is confident in the next label
        for b in range(B):
            for n in np.flatnonzero(valid[b]):
                logits[b, 4 * n, labels[b, n]] = 4.0
        fields = dict(images=np.zeros((B, 8, 16, 3), np.uint8),
                      valid_hw=np.asarray([[8, 16], [8, 12]], np.int32), labels=labels,
                      boxes=boxes[:, :N_LABELS].copy(), valid=valid, texts=texts)
        out.append(((logits, boxes), fields))
    return out


def jax_report(data, charset, tmp_path):
    """JAX's evaluate_ctc with the outputs in place of its model."""
    calls = iter(data)

    def eval_fn(params, arrays):
        (logits, boxes), fields = next(calls)
        loss, _ = jax_ctc_loss(jnp.asarray(logits), jnp.asarray(boxes),
                               jnp.asarray(fields["labels"]), jnp.asarray(fields["valid"]),
                               eps=RECIPE.ctc_eps)
        return {"pred_logits": logits, "pred_boxes": boxes, "loss_CTC": loss}

    trainer = types.SimpleNamespace(
        _eval_fn=eval_fn, mesh=None, output_dir=str(tmp_path / "jax"), epoch=0,
        state=types.SimpleNamespace(params={}, ema_params=None),
        logger=types.SimpleNamespace(info=lambda msg: None))
    batches = [JaxBatch(**fields) for _, fields in data]
    return jax_engine.Trainer.evaluate_ctc(trainer, batches, charset, snapshot=False)


def port_report(data, charset, tmp_path):
    """The port's evaluate_ctc with the outputs in place of its model."""
    calls = iter(data)

    class Outputs(torch.nn.Module):
        def forward(self, images, valid_hw):
            (logits, boxes), _ = next(calls)
            return {"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)}

    trainer = types.SimpleNamespace(
        state=types.SimpleNamespace(model=Outputs()), device=torch.device("cpu"), cfg=RECIPE,
        epoch=0, log=lambda msg: None, append_log_line=lambda record: None)
    batches = [Batch(**fields) for _, fields in data]
    return Trainer.evaluate_ctc(trainer, batches, charset)


@pytest.mark.parametrize("name", list(CHARSETS))
def test_evaluate_ctc_reports_as_jax(name, tmp_path, monkeypatch):
    charset = CHARSETS[name]
    data = outputs_and_batches(charset)
    monkeypatch.setattr(jax_engine, "shard_batch", lambda mesh, arrays: arrays)
    want = jax_report(data, charset, tmp_path)
    got = port_report(data, charset, tmp_path)
    spaceless = " " not in charset
    assert ({"ar", "cr"} <= set(got)) == spaceless and ("wer" in got) != spaceless
    assert set(want) - set(got) == JAX_DIAGNOSTICS
    assert set(got) <= set(want)
    for k, v in got.items():
        if k == "loss_CTC":
            assert abs(v - want[k]) <= 1e-5 * abs(want[k]), (k, v, want[k])
        else:
            assert v == pytest.approx(want[k], rel=0, abs=1e-12), (k, v, want[k])
    # the NMS decode reads most characters, so AR and CR are not trivial
    if spaceless:
        assert got["cr"] > 0.5 and got["nms_cer"] < 1
