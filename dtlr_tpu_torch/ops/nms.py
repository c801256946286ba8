"""Greedy class-agnostic NMS as a keep mask (counterpart of
dtlr_tpu/ops/nms.py). The IoU matrix is computed where the boxes are;
the sequential suppression runs on the host."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.boxes import pairwise_box_iou


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """boxes (B, n, 4) xyxy, scores (B, n) -> keep (B, n) bool: a box is
    dropped if a kept box of higher score overlaps it by more than the
    threshold."""
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    over = (pairwise_box_iou(boxes_sorted, boxes_sorted) > iou_threshold).cpu().numpy()
    B, n = scores.shape
    keep_sorted = np.ones((B, n), bool)
    for i in range(1, n):
        keep_sorted[:, i] = ~(over[:, i, :i] & keep_sorted[:, :i]).any(1)
    keep = torch.zeros((B, n), dtype=torch.bool)
    keep.scatter_(1, order.cpu(), torch.from_numpy(keep_sorted))
    return keep.to(boxes.device)

