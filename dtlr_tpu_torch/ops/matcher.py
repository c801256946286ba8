"""Bipartite matching of queries to targets (counterpart of
dtlr_tpu/ops/matcher.py).

Cost (reference matcher.py:76-90): C = 2 * focal class cost + 5 * L1 box
cost + 2 * (-GIoU). Two assignment methods:

- ``auction_assign``, the recipe's (``matcher_impl="jax"``): JAX's
  Jacobi auction with its arithmetic (eps = 1e-3 * spread, the
  target-index tie-break scaled by spread * 1e-5, eviction, the
  owner-consistency pass and the greedy completion), written out over a
  batch of cost matrices. JAX runs one ``while_loop`` per image under
  ``vmap``; here every image bids in each round, and a finished image's
  round changes nothing (it has no unassigned target, so it bids for no
  query), so the batch runs until its slowest image is done and every
  image ends as JAX's would. ``detection_loss`` runs all of a step's
  matchings (final layer, auxiliary layers, two-stage) as one batch.
  The loop reads one flag from the device every ``SYNC_EVERY`` rounds.
- ``scipy_assign`` (``matcher_impl="scipy"``): the exact Hungarian
  solver on the host, as JAX's ``pure_callback`` runs it.

``auction_assign.stats`` counts the rounds, the host reads and the
greedy completions since ``reset_stats``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou


def match_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, tgt_labels: torch.Tensor,
               tgt_boxes: torch.Tensor, cost_class: float = 2.0, cost_bbox: float = 5.0,
               cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """(..., nq, N) matching cost from pred_logits (..., nq, K),
    pred_boxes (..., nq, 4) cxcywh, tgt_labels (..., N), tgt_boxes
    (..., N, 4)."""
    out_prob = pred_logits.float().sigmoid()
    gamma = 2.0
    neg = (1 - focal_alpha) * (out_prob ** gamma) * (-torch.log(1 - out_prob + 1e-8))
    pos = focal_alpha * ((1 - out_prob) ** gamma) * (-torch.log(out_prob + 1e-8))
    idx = tgt_labels.long()[..., None, :].expand(*pos.shape[:-1], tgt_labels.shape[-1])
    cost_cls = pos.gather(-1, idx) - neg.gather(-1, idx)  # (..., nq, N)
    cost_l1 = (pred_boxes[..., :, None, :] - tgt_boxes[..., None, :, :]).abs().sum(-1)
    cost_g = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    return cost_bbox * cost_l1 + cost_class * cost_cls + cost_giou * cost_g


def reset_stats() -> None:
    auction_assign.stats = {"calls": 0, "rounds": 0, "syncs": 0, "completions": 0}


#: rounds between the auction's host reads of its "any target unassigned"
#: flag; a finished image's extra rounds change nothing
SYNC_EVERY = 4


@torch.no_grad()
def auction_assign(cost: torch.Tensor, valid: torch.Tensor, eps_rel: float = 1e-3,
                   max_iters: int = 256) -> torch.Tensor:
    """Assign each valid target a distinct query of near-least total cost.

    cost (R, nq, N) float32, valid (R, N) bool -> (R, N) int64: the query
    of each target, -1 for invalid targets. Every row is JAX's
    ``auction_assign`` of that image: at most ``max_iters`` rounds, then
    the owner-consistency pass and the greedy completion. The host reads
    whether any valid target is unassigned every ``SYNC_EVERY`` rounds,
    and once more before the completion (which runs only where one is)."""
    R, nq, N = cost.shape
    dev = cost.device
    stats = auction_assign.stats
    stats["calls"] += 1
    benefit = -cost.float().transpose(1, 2)  # (R, N, nq), maximize
    spread = (benefit.amax((1, 2)) - benefit.amin((1, 2))).clamp(min=1e-6)[:, None]  # (R, 1)
    eps = eps_rel * spread
    NEG = -1e15
    benefit = torch.where(valid[:, :, None], benefit, torch.tensor(NEG, device=dev))
    tie = torch.arange(N, dtype=torch.float32, device=dev)[None] * (spread * 1e-5)  # (R, N)
    targets = torch.arange(N, device=dev)[None].expand(R, N)
    neg = torch.tensor(NEG, device=dev)

    prices = torch.zeros((R, nq), dtype=torch.float32, device=dev)
    assigned = torch.full((R, N), -1, dtype=torch.long, device=dev)
    owner = torch.full((R, nq), -1, dtype=torch.long, device=dev)

    def round_():
        nonlocal assigned, owner, prices
        unassigned = (assigned < 0) & valid
        values = benefit - prices[:, None, :]
        v_masked = torch.where(unassigned[:, :, None], values, neg)
        # the best query (the lowest index among equals, as lax.top_k) and
        # the second-best value
        i1 = v_masked.argmax(-1)  # (R, N)
        v1 = v_masked.gather(-1, i1[..., None])[..., 0]
        v2 = v_masked.scatter(-1, i1[..., None], float("-inf")).amax(-1)
        bid = prices.gather(1, i1) + (v1 - v2) + eps
        order = torch.where(unassigned, bid - tie, neg)
        win_order = torch.full((R, nq), float("-inf"), device=dev).scatter_reduce(
            1, i1, order, reduce="amax")
        is_winner = unassigned & (order >= win_order.gather(1, i1))
        win_q = torch.where(is_winner, i1, nq)
        # evict the previous owners of won queries
        won = torch.zeros((R, nq + 1), dtype=torch.bool, device=dev).scatter(1, win_q, True)[:, :nq]
        evicted = torch.where(won & (owner >= 0), owner, N)
        gone = torch.zeros((R, N + 1), dtype=torch.bool, device=dev).scatter(1, evicted, True)[:, :N]
        assigned = torch.where(gone, -1, assigned)
        assigned = torch.where(is_winner, i1, assigned)
        owner = torch.cat([owner, owner.new_full((R, 1), -1)], 1).scatter(
            1, win_q, torch.where(is_winner, targets, -1))[:, :nq]
        prices = torch.cat([prices, prices.new_zeros((R, 1))], 1).scatter(
            1, win_q, torch.where(is_winner, bid, 0.0))[:, :nq]

    it = 0
    while it < max_iters:
        stats["syncs"] += 1
        if not bool(((assigned < 0) & valid).any()):
            break
        for _ in range(min(SYNC_EVERY, max_iters - it)):
            round_()
            it += 1
    stats["rounds"] += it

    # consistency: a target keeps its query only as the query's recorded owner
    safe_q = assigned.clamp(min=0)
    consistent = (assigned >= 0) & (owner.gather(1, safe_q) == targets)
    assigned = torch.where(consistent, assigned, -1)

    # greedy completion: every valid target gets a distinct query even if
    # the round cap was hit; a no-op where none is unassigned
    stats["syncs"] += 1
    if bool(((assigned < 0) & valid).any()):
        stats["completions"] += 1
        taken = torch.zeros((R, nq + 1), dtype=torch.bool, device=dev).scatter(
            1, torch.where(assigned >= 0, assigned, nq), True)[:, :nq]
        rows = torch.arange(R, device=dev)
        for j in range(N):
            need = valid[:, j] & (assigned[:, j] < 0)
            q = torch.where(taken, float("inf"), cost[:, :, j].float()).argmin(1)
            assigned[:, j] = torch.where(need, q, assigned[:, j])
            taken[rows, q] = taken[rows, q] | need
    return torch.where(valid, assigned, -1)


reset_stats()


def _scipy_assign_host(cost: np.ndarray, n_valid: int) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    out = np.full((cost.shape[1],), -1, np.int64)
    if n_valid > 0:
        rows, cols = linear_sum_assignment(cost[:, :n_valid])
        out[cols] = rows
    return out


@torch.no_grad()
def scipy_assign(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact Hungarian assignment on the host: cost (R, nq, N), valid
    (R, N) -> (R, N) int64, -1 for invalid targets. Valid columns are
    compacted to a prefix (stable) before the solver, and the result is
    scattered back, as JAX's ``scipy_assign`` does."""
    R, nq, N = cost.shape
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)  # valid first
    cost_np = cost.float().gather(2, order[:, None, :].expand(R, nq, N)).cpu().numpy()
    order_np = order.cpu().numpy()
    n_valid = valid.sum(1).cpu().numpy()
    out = np.full((R, N), -1, np.int64)
    for r in range(R):
        prefix = _scipy_assign_host(cost_np[r], int(n_valid[r]))
        out[r, order_np[r]] = prefix
    return torch.from_numpy(out).to(cost.device)


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                    impl: str = "jax", cost_class: float = 2.0, cost_bbox: float = 5.0,
                    cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """Batched matching: pred_logits (R, nq, K), pred_boxes (R, nq, 4),
    targets (R, N[, 4]) -> (R, N) query index per target (-1 invalid).
    Invalid targets get zero cost, so they never distort the auction."""
    cost = match_cost(pred_logits.detach(), pred_boxes.detach().float(), tgt_labels,
                      tgt_boxes.float(), cost_class=cost_class, cost_bbox=cost_bbox,
                      cost_giou=cost_giou, focal_alpha=focal_alpha)
    cost = torch.where(tgt_valid[:, None, :], cost, torch.zeros((), device=cost.device))
    if impl == "scipy":
        return scipy_assign(cost, tgt_valid)
    if impl == "jax":
        return auction_assign(cost, tgt_valid)
    raise ValueError(f"matcher_impl is 'jax' or 'scipy', got {impl!r}")


def match_outputs(outputs: Sequence[dict], labels: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, **kw) -> list:
    """Match several decoder outputs to the same targets as one batch:
    one ``hungarian_match`` over their concatenated rows. Returns one
    (B, N) assignment per output."""
    n = len(outputs)
    B = labels.shape[0]
    assign = hungarian_match(torch.cat([o["pred_logits"] for o in outputs]),
                             torch.cat([o["pred_boxes"] for o in outputs]),
                             labels.repeat(n, 1), boxes.repeat(n, 1, 1), valid.repeat(n, 1),
                             **kw)
    return list(assign.split(B))
