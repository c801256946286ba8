"""Model output -> text: greedy and NMS paths (counterpart of
dtlr_tpu/eval/decode.py).

- greedy: x-sort + blank synthesis (eps = 0.03/K) -> argmax per query,
  drop blanks, charset[argmax - 1] left to right
- NMS: top-``num_select`` over the flattened query x class scores,
  class-agnostic NMS, score > TH, sort by box x-centre. The NMS keep
  mask does not depend on TH, so ``nms_candidates`` computes it once
  and ``threshold_labels`` applies any TH to it (the evaluate sweep).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.ctc import blank_synthesis
from ..ops.nms import batched_nms_mask
from ..models.transformer import top_k_stable
from ..utils.boxes import box_cxcywh_to_xyxy


def greedy_decode(pred_logits: torch.Tensor, pred_boxes: torch.Tensor) -> np.ndarray:
    """(B, nq) int32: class+1 per x-sorted query, 0 = blank; the blank
    synthesis uses eps = 0.03 / K (reference evaluation.py:116-159)."""
    K = pred_logits.shape[-1]
    probs = blank_synthesis(pred_logits, pred_boxes, eps=0.03 / K)
    return probs.argmax(-1).int().cpu().numpy()


def greedy_labels(frame_argmax: np.ndarray) -> List[List[int]]:
    """Drop blank frames; labels are argmax-1, repeats kept."""
    return [[int(v) - 1 for v in row if v != 0] for row in frame_argmax]


def postprocess_topk(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                     num_select: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``num_select`` over the flattened query x class sigmoid scores.
    Returns scores (B, k), labels (B, k), boxes (B, k, 4) cxcywh."""
    B, nq, K = pred_logits.shape
    prob = pred_logits.float().sigmoid().reshape(B, nq * K)
    idx = top_k_stable(prob, min(num_select, nq * K))
    scores = torch.gather(prob, 1, idx)
    boxes = torch.gather(pred_boxes.float(), 1,
                         torch.div(idx, K, rounding_mode="floor")[..., None].expand(-1, -1, 4))
    return scores, idx % K, boxes


def nms_candidates(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                   nms_iou: float) -> Dict[str, np.ndarray]:
    """On the host: the top-k (query, class) pairs' scores, labels and box
    x-centres, and the NMS keep mask; the top-k keeps as many pairs as
    there are queries, as the reference's 900 (evaluation.py:97)."""
    scores, labels, boxes = postprocess_topk(pred_logits, pred_boxes, pred_logits.shape[1])
    keep = batched_nms_mask(box_cxcywh_to_xyxy(boxes), scores, nms_iou)
    return {"scores": scores.cpu().numpy(), "labels": labels.cpu().numpy(),
            "cx": boxes[..., 0].cpu().numpy(), "keep": keep.cpu().numpy()}


def threshold_labels(cand: Dict[str, np.ndarray], score_threshold: float) -> List[List[int]]:
    """Labels per line of the kept pairs scoring above the threshold, in
    x order."""
    keep = cand["keep"] & (cand["scores"] > np.float32(score_threshold))
    out = []
    for b in range(keep.shape[0]):
        idx = np.nonzero(keep[b])[0]
        idx = idx[np.argsort(cand["cx"][b, idx], kind="stable")]
        out.append([int(cand["labels"][b, i]) for i in idx])
    return out


def nms_decode(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
               score_threshold: float, nms_iou: float) -> List[List[int]]:
    """Labels per line after NMS and the score threshold, in x order."""
    return threshold_labels(nms_candidates(pred_logits, pred_boxes, nms_iou), score_threshold)
