"""CTC on x-sorted character detections (counterpart of
dtlr_tpu/ops/ctc.py).

``blank_synthesis``: the queries are sorted by box x-centre, the class
logits sigmoided and a blank column prepended: p_blank = 1 - sum(p) when
sum(p) < 1 - eps, else p_blank = eps with the class probabilities
rescaled to 1 - eps. ``interleave_blanks`` puts a constant near-pure
blank frame after every query (T doubles, 900 -> 1800), which gives CTC
room for repeated characters. ``ctc_loss`` is the finetuning loss on
those frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn import functional as F


def blank_synthesis(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    eps: float = 0.003) -> torch.Tensor:
    """(B, nq, K) logits, (B, nq, 4) cxcywh -> (B, nq, K+1) probs, blank at 0."""
    K = pred_logits.shape[-1]
    order = torch.argsort(pred_boxes[:, :, 0], dim=1, stable=True)
    logits = torch.gather(pred_logits.float(), 1, order[..., None].expand(-1, -1, K))
    p = logits.sigmoid()
    s = p.sum(-1)
    under = s < 1.0 - eps
    blank = torch.where(under, 1.0 - s, torch.full_like(s, eps))
    scale = torch.where(under, torch.ones_like(s), (1.0 - eps) / s.clamp(min=1e-12))
    return torch.cat([blank[..., None], p * scale[..., None]], dim=-1)


def interleave_blanks(probs: torch.Tensor) -> torch.Tensor:
    """(B, T, K+1) -> (B, 2T, K+1): after every frame a constant frame of
    1.0 on the blank and 1e-5 elsewhere."""
    B, T, C = probs.shape
    blank_frame = torch.full((B, T, C), 1e-5, dtype=probs.dtype, device=probs.device)
    blank_frame[:, :, 0] = 1.0
    return torch.stack([probs, blank_frame], dim=2).reshape(B, 2 * T, C)


def ctc_loss(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, labels: torch.Tensor,
             label_valid: torch.Tensor, eps: float = 0.003, lines: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CTC loss of the lines and the probs (B, nq, K+1).

    labels (B, N) are charset indices, ``label_valid`` (B, N) marks the
    real ones (in order; padding may sit anywhere). ``F.ctc_loss`` runs on
    the log of the interleaved frames laid out (2*nq, B, K+1), blank 0,
    labels + 1; a line whose loss is not finite counts 0 (an infeasible
    one, with its gradient, through ``zero_infinity``; a NaN one too, as
    JAX's ``isfinite`` guard zeroes it); each line's loss is divided by
    its length (at least 1) and the mean taken over the lines: torch's
    ``CTCLoss(reduction='mean', zero_infinity=True)``, as the reference
    computes it. JAX's optax CTC log-softmaxes its input and subtracts
    (T/2)*log1p(K*1e-5) to land on this same value; torch's CTC takes the
    log-probabilities as they are, so nothing is subtracted. On CUDA the
    2-D targets take torch's native kernel (cuDNN's takes 1-D targets
    only). ``lines``: the count the lines' sum is divided by, in place of
    the mean over this batch's lines (a data-parallel rank's share of the
    mean over the global batch, JAX's mean over the sharded batch)."""
    probs = blank_synthesis(pred_logits, pred_boxes, eps)
    frames = interleave_blanks(probs)
    B, T, _ = frames.shape
    log_probs = frames.log().transpose(0, 1)  # (T, B, K+1)
    # the valid labels first, in order, without leaving the device
    order = torch.argsort((~label_valid).to(torch.int8), dim=1, stable=True)
    targets = torch.gather(labels.long() + 1, 1, order)
    target_lengths = label_valid.sum(-1)
    input_lengths = torch.full((B,), T, dtype=torch.long, device=frames.device)
    per_line = F.ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=0,
                          reduction="none", zero_infinity=True)
    per_line = torch.where(torch.isfinite(per_line), per_line, torch.zeros_like(per_line))
    per_line = per_line / target_lengths.clamp(min=1)
    loss = per_line.mean() if lines is None else per_line.sum() / lines
    return loss, probs
