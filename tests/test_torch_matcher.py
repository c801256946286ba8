"""The port's matcher (dtlr_tpu_torch/ops/matcher.py) against
dtlr_tpu/ops/matcher.py.

The auction is held to JAX's ``auction_assign`` exactly, assignment for
assignment, on seeded cost matrices: random ones at several sizes, with
invalid targets, and the adversarial ones of tests/test_matcher_adversarial.py
(all-zero costs, identical columns, identical rows, one target, and the
flagship's 900 queries). Both run the same float32 arithmetic; a tie in
the port's argmax goes to the lower index as ``lax.top_k``'s does. The
batched auction over many images equals one call per image. The scipy
path is the exact Hungarian optimum, as JAX's is. ``match_cost`` agrees
with JAX's to 1e-5 of its scale; ``hungarian_match`` gives JAX's
assignments on random model outputs with both methods.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.ops.matcher import auction_assign as jax_auction_assign
from dtlr_tpu.ops.matcher import hungarian_match as jax_hungarian_match
from dtlr_tpu.ops.matcher import match_cost as jax_match_cost
from dtlr_tpu.ops.matcher import scipy_assign as jax_scipy_assign
from dtlr_tpu_torch.ops import matcher

scipy_opt = pytest.importorskip("scipy.optimize")


def jax_assign(cost, valid):
    return np.asarray(jax_auction_assign(jnp.asarray(cost), jnp.asarray(valid)))


def port_assign(cost, valid, **kw):
    return matcher.auction_assign(torch.from_numpy(cost)[None],
                                  torch.from_numpy(valid)[None], **kw)[0].numpy()


def adversarial(name):
    rng = np.random.default_rng({"flagship": 11, "holes": 12}.get(name, 0))
    if name == "all_zero":
        return np.zeros((30, 8), np.float32), np.ones(8, bool)
    if name == "identical_columns":
        col = np.random.default_rng(0).standard_normal((40, 1)).astype(np.float32)
        return np.repeat(col, 10, axis=1), np.ones(10, bool)
    if name == "identical_rows":
        row = np.random.default_rng(1).standard_normal((1, 12)).astype(np.float32)
        return np.repeat(row, 50, axis=0), np.ones(12, bool)
    if name == "single_target":
        return np.random.default_rng(2).standard_normal((900, 1)).astype(np.float32), \
            np.ones(1, bool)
    if name == "flagship":  # 900 queries, 64 target slots, 37 of them real
        valid = np.zeros(64, bool)
        valid[:37] = True
        cost = rng.standard_normal((900, 64)).astype(np.float32) * 2
        return np.where(valid[None], cost, 0).astype(np.float32), valid
    if name == "holes":  # valid targets not a prefix
        valid = rng.uniform(size=20) < 0.6
        return rng.standard_normal((60, 20)).astype(np.float32), valid
    raise KeyError(name)


@pytest.mark.parametrize("nq,n", [(60, 10), (120, 40), (300, 100), (50, 12)])
@pytest.mark.parametrize("seed", [0, 1])
def test_auction_equals_jax_on_random_costs(nq, n, seed):
    rng = np.random.default_rng(1000 * seed + nq + n)
    cost = (rng.standard_normal((nq, n)) * 3).astype(np.float32)
    valid = np.ones(n, bool)
    if n == 12:
        valid[5:] = False
    want = jax_assign(cost, valid)
    got = port_assign(cost, valid)
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()
    assert len(set(got[valid].tolist())) == int(valid.sum())


@pytest.mark.parametrize("name", ["all_zero", "identical_columns", "identical_rows",
                                  "single_target", "flagship", "holes"])
def test_auction_equals_jax_on_adversarial_costs(name):
    cost, valid = adversarial(name)
    np.testing.assert_array_equal(port_assign(cost, valid), jax_assign(cost, valid))


def test_auction_equals_jax_at_the_round_cap():
    """A cap of 2 rounds leaves targets unassigned: the consistency pass
    and the greedy completion decide, as in JAX."""
    cost, valid = adversarial("identical_columns")
    want = np.asarray(jax_auction_assign(jnp.asarray(cost), jnp.asarray(valid), max_iters=2))
    matcher.reset_stats()
    got = port_assign(cost, valid, max_iters=2)
    np.testing.assert_array_equal(got, want)
    assert matcher.auction_assign.stats["completions"] == 1
    assert matcher.auction_assign.stats["rounds"] == 2


def test_batched_auction_equals_per_image_calls():
    """7 matchings of a batch of 3 images (the final, 5 auxiliary and the
    two-stage outputs of a step) as one auction over 21 rows: each row
    is its own image's auction."""
    rng = np.random.default_rng(7)
    R, nq, N = 21, 120, 16
    cost = (rng.standard_normal((R, nq, N)) * 2).astype(np.float32)
    valid = np.zeros((R, N), bool)
    for r, n in enumerate(rng.integers(1, N + 1, R)):
        valid[r, :n] = True
    cost = np.where(valid[:, None], cost, 0).astype(np.float32)
    matcher.reset_stats()
    got = matcher.auction_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    stats = dict(matcher.auction_assign.stats)
    assert stats["calls"] == 1 and stats["rounds"] >= 1
    # the host reads a flag every 4 rounds and once before the completion
    assert stats["syncs"] <= stats["rounds"] // 4 + 2
    for r in range(R):
        np.testing.assert_array_equal(got[r], port_assign(cost[r], valid[r]))
        np.testing.assert_array_equal(got[r], jax_assign(cost[r], valid[r]))


@pytest.mark.parametrize("name", ["flagship", "holes", "identical_rows"])
def test_scipy_path_is_exact(name):
    cost, valid = adversarial(name)
    got = matcher.scipy_assign(torch.from_numpy(cost)[None], torch.from_numpy(valid)[None])[0]
    want = np.asarray(jax_scipy_assign(jnp.asarray(cost), jnp.asarray(valid)))
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    cols = np.flatnonzero(valid)
    rows, picked = scipy_opt.linear_sum_assignment(cost[:, cols])
    assert np.isclose(cost[got[cols], cols].sum(), cost[:, cols][rows, picked].sum())
    assert (got[~valid] == -1).all()


def model_outputs(seed, B=3, nq=40, K=7, N=9):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, nq, K)).astype(np.float32)
    pboxes = np.concatenate([rng.uniform(0.2, 0.8, (B, nq, 2)),
                             rng.uniform(0.02, 0.3, (B, nq, 2))], -1).astype(np.float32)
    labels = rng.integers(0, K, (B, N)).astype(np.int32)
    tboxes = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                             rng.uniform(0.02, 0.3, (B, N, 2))], -1).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[1, 5:] = False
    valid[2, :] = False
    valid[2, :2] = True
    return logits, pboxes, labels, tboxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_match_cost_matches_jax(seed):
    logits, pboxes, labels, tboxes, _ = model_outputs(seed)
    for b in range(logits.shape[0]):
        want = np.asarray(jax_match_cost(*(jnp.asarray(a[b]) for a in
                                           (logits, pboxes, labels, tboxes))))
        got = matcher.match_cost(*(torch.from_numpy(a[b]) for a in
                                   (logits, pboxes, labels, tboxes))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1, np.abs(want).max()))
    # over a batch (vectorized in another order: within float32 rounding)
    batched = matcher.match_cost(*(torch.from_numpy(a) for a in
                                   (logits, pboxes, labels, tboxes))).numpy()
    for b in range(logits.shape[0]):
        np.testing.assert_allclose(batched[b], matcher.match_cost(
            *(torch.from_numpy(a[b]) for a in (logits, pboxes, labels, tboxes))).numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["jax", "scipy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_match_equals_jax(impl, seed):
    arrays = model_outputs(seed)
    want = np.asarray(jax_hungarian_match(*(jnp.asarray(a) for a in arrays), impl=impl))
    got = matcher.hungarian_match(*(torch.from_numpy(a) for a in arrays), impl=impl).numpy()
    np.testing.assert_array_equal(got, want)


def test_match_outputs_is_one_batched_match():
    logits, pboxes, labels, tboxes, valid = model_outputs(3)
    outs = [{"pred_logits": torch.from_numpy(logits + i), "pred_boxes": torch.from_numpy(pboxes)}
            for i in range(3)]
    t = lambda a: torch.from_numpy(a)
    matcher.reset_stats()
    got = matcher.match_outputs(outs, t(labels), t(tboxes), t(valid), impl="jax")
    assert matcher.auction_assign.stats["calls"] == 1
    for o, a in zip(outs, got):
        want = matcher.hungarian_match(o["pred_logits"], o["pred_boxes"], t(labels), t(tboxes),
                                       t(valid))
        assert torch.equal(a, want)
