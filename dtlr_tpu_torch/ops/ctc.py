"""Blank synthesis over x-sorted detections (counterpart of
dtlr_tpu/ops/ctc.py:27-43; the CTC loss itself is training and not
ported yet).

The queries are sorted by box x-centre, the class logits sigmoided and a
blank column prepended: p_blank = 1 - sum(p) when sum(p) < 1 - eps,
else p_blank = eps with the class probabilities rescaled to 1 - eps.
"""

from __future__ import annotations

import torch


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
