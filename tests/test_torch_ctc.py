"""The port's CTC (dtlr_tpu_torch/ops/ctc.py) against dtlr_tpu/ops/ctc.py
on seeded random logits and boxes.

``ctc_loss`` runs torch's CTC on the log of the interleaved frames; JAX's
runs optax's, which log-softmaxes its input, and subtracts the constant
that this adds back, so the two return the same number: relative 1e-5
(float32, measured about 1e-7). The batches hold padded labels, a line
with no label, a label sequence that no alignment of the frames can
spell (the port zeroes its loss, ``zero_infinity``, where JAX's keeps
a finite log-epsilon score; see ``test_infeasible_line_is_zeroed``),
repeats that need the
interleaved blank frames, and valid labels that do not sit at the front
of their row. Gradients with respect to the logits: 1e-5 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.ops import ctc as jax_ctc
from dtlr_tpu_torch.ops import ctc

REL = 1e-5


def batch(seed, B=4, nq=30, K=12, N=8):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0, 2, (B, nq, K)) - 2).astype(np.float32)
    boxes = rng.uniform(0, 1, (B, nq, 4)).astype(np.float32)
    labels = rng.integers(0, K, (B, N)).astype(np.int32)
    valid = np.zeros((B, N), bool)
    valid[0, :3] = True            # padded
    valid[1, :] = True             # full
    # row 2: no label
    valid[3, :5] = True
    labels[1, :] = 3               # repeats: only the blank frames separate them
    return logits, boxes, labels, valid


def infeasible(seed):
    """Line 0 asks for more labels than 2*nq frames can spell (all
    repeats need a blank between them): its loss is infinite and zeroed."""
    logits, boxes, labels, valid = batch(seed, nq=6, N=8)
    labels[0, :] = 5
    valid[0, :] = True
    valid[1, 3:] = False  # eight repeats need 15 of the 12 frames: keep three
    return logits, boxes, labels, valid


def scattered(seed):
    """Valid labels with padding between them: both packages read the valid
    ones in order."""
    logits, boxes, labels, valid = batch(seed)
    valid[0] = [True, False, True, False, False, True, False, False]
    return logits, boxes, labels, valid


def jax_loss(logits, boxes, labels, valid):
    return float(jax_ctc.ctc_loss(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(labels),
                                  jnp.asarray(valid))[0])


def port_loss(logits, boxes, labels, valid):
    return float(ctc.ctc_loss(*(torch.from_numpy(a) for a in (logits, boxes, labels, valid)))[0])


CASES = {"padded_and_empty": lambda: batch(0), "second_seed": lambda: batch(1)}


@pytest.mark.parametrize("case", list(CASES))
def test_ctc_loss_matches_jax(case):
    args = CASES[case]()
    want, got = jax_loss(*args), port_loss(*args)
    assert np.isfinite(got)
    assert abs(got - want) <= REL * abs(want), (got, want)


def test_infeasible_line_is_zeroed():
    """The infeasible line adds 0 to the batch's sum, as torch's
    ``CTCLoss(zero_infinity=True)`` (the reference's) does: the batch's
    mean equals JAX's mean over the other lines times (B-1)/B. JAX itself
    keeps such a line: optax's CTC scores an impossible alignment with a
    finite log-epsilon (-1e5) in place of -inf, so the package's
    ``isfinite`` guard never fires and the line adds thousands."""
    logits, boxes, labels, valid = infeasible(2)
    B = logits.shape[0]
    got = port_loss(logits, boxes, labels, valid)
    want = jax_loss(logits[1:], boxes[1:], labels[1:], valid[1:]) * (B - 1) / B
    assert abs(got - want) <= REL * abs(want), (got, want)
    np.testing.assert_allclose(got, port_loss(logits[1:], boxes[1:], labels[1:], valid[1:])
                               * (B - 1) / B, rtol=1e-6)
    assert jax_loss(logits, boxes, labels, valid) > 100 * got


def test_scattered_valid_labels():
    """The port packs valid labels to the front of each row before
    torch's CTC: the same as packing them by hand."""
    logits, boxes, labels, valid = scattered(3)
    packed_labels, packed_valid = np.zeros_like(labels), np.zeros_like(valid)
    for b in range(labels.shape[0]):
        lab = labels[b][valid[b]]
        packed_labels[b, :len(lab)] = lab
        packed_valid[b, :len(lab)] = True
    got = port_loss(logits, boxes, labels, valid)
    assert got == port_loss(logits, boxes, packed_labels, packed_valid)
    want = jax_loss(logits, boxes, packed_labels, packed_valid)
    assert abs(got - want) <= REL * abs(want), (got, want)


def test_ctc_gradient_matches_jax():
    logits, boxes, labels, valid = batch(4)
    want = np.asarray(jax.grad(lambda x: jax_ctc.ctc_loss(
        x, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))[0])(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    ctc.ctc_loss(x, torch.from_numpy(boxes), torch.from_numpy(labels),
                 torch.from_numpy(valid))[0].backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_interleave_blanks_exact(seed):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(size=(3, 7, 5)).astype(np.float32)
    want = np.asarray(jax_ctc.interleave_blanks(jnp.asarray(probs)))
    got = ctc.interleave_blanks(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_blank_synthesis_matches_jax():
    logits, boxes, _, _ = batch(5)
    want = np.asarray(jax_ctc.blank_synthesis(jnp.asarray(logits), jnp.asarray(boxes)))
    got = ctc.blank_synthesis(torch.from_numpy(logits), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_nan_line_counts_zero_like_jax():
    """A line whose logits hold a NaN adds 0 to the loss in both packages
    (JAX's ``isfinite`` guard; the port's the same), so the loss stays
    finite."""
    logits, boxes, labels, valid = batch(6)
    logits[0, 3, 2] = np.nan
    want, got = jax_loss(logits, boxes, labels, valid), port_loss(logits, boxes, labels, valid)
    assert np.isfinite(got)
    assert abs(got - want) <= REL * abs(want), (got, want)
