"""The DINO detection loss with static shapes (counterpart of
dtlr_tpu/losses/criterion.py; reference SetCriterion,
models/dino/dino.py:428-982): focal classification, L1 and GIoU box
losses, the cardinality error (logging only) and the denoising losses
on the fixed positive slots.

Targets are padded: labels (B, N), boxes (B, N, 4) cxcywh, valid (B, N).
An assignment is (B, N): the query of each target, -1 for invalid
targets (ops/matcher.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.matcher import match_outputs
from ..utils.boxes import box_cxcywh_to_xyxy, elementwise_generalized_box_iou


def focal_label_loss(pred_logits: torch.Tensor, assign: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, num_boxes: torch.Tensor, focal_alpha: float = 0.25,
                     gamma: float = 2.0) -> torch.Tensor:
    B, nq, K = pred_logits.shape
    logits = pred_logits.float()
    # one-hot targets: matched queries get their class, the rest zeros
    safe_q = torch.where((assign >= 0) & valid, assign, nq).long()
    onehot = torch.zeros((B, nq + 1, K), dtype=torch.float32, device=logits.device)
    batch_idx = torch.arange(B, device=logits.device)[:, None].expand_as(safe_q)
    onehot.index_put_((batch_idx, safe_q, labels.long()), valid.float(), accumulate=True)
    onehot = onehot[:, :nq].clamp(0.0, 1.0)

    prob = logits.sigmoid()
    ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * ((1 - p_t) ** gamma)
    alpha_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    loss = alpha_t * loss
    # the reference's loss.mean(1).sum() / num_boxes * nq
    return loss.sum() / num_boxes


def box_losses(pred_boxes: torch.Tensor, assign: torch.Tensor, tgt_boxes: torch.Tensor,
               valid: torch.Tensor, num_boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    matched = (assign >= 0) & valid
    safe_q = torch.where(matched, assign, 0).long()
    src = pred_boxes.float().gather(1, safe_q[..., None].expand(-1, -1, 4))  # (B, N, 4)
    m = matched.float()
    tgt = tgt_boxes.float()
    l1 = (src - tgt).abs()
    loss_bbox = (l1.sum(-1) * m).sum() / num_boxes
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt))
    loss_giou = ((1.0 - giou) * m).sum() / num_boxes
    loss_xy = (l1[..., :2].sum(-1) * m).sum() / num_boxes
    loss_hw = (l1[..., 2:].sum(-1) * m).sum() / num_boxes
    return {"loss_bbox": loss_bbox, "loss_giou": loss_giou,
            "loss_xy": loss_xy.detach(), "loss_hw": loss_hw.detach()}


@torch.no_grad()
def cardinality_error(pred_logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Logging only (reference :602-616): predictions whose argmax is not
    the last class, against the target count."""
    K = pred_logits.shape[-1]
    card_pred = (pred_logits.argmax(-1) != K - 1).sum(1)
    return (card_pred.float() - valid.sum(1).float()).abs().mean()


def dn_assignment(n_max: int, num_groups: int, device=None) -> torch.Tensor:
    """The fixed DN positive slots: target i of group g sits at slot
    g*2*n_max + i (reference dino.py:818-833). Returns (G*N,)."""
    g = torch.arange(num_groups, device=device)[:, None]
    i = torch.arange(n_max, device=device)[None, :]
    return (g * 2 * n_max + i).reshape(-1)


def detection_loss(outputs: Dict, targets: Dict, num_classes: int,
                   weight_dict: Dict[str, float], focal_alpha: float = 0.25,
                   matcher_impl: str = "jax", cost_class: float = 2.0, cost_bbox: float = 5.0,
                   cost_giou: float = 2.0, assignments=None):
    """The full DINO detection loss (reference forward_standard,
    dino.py:780-964). Returns (total, loss_dict) with the unweighted
    terms. The final, auxiliary and two-stage outputs are matched in one
    batch (``match_outputs``); ``assignments`` (one (B, N) tensor per
    matched output, in that order) replaces the matching."""
    labels = targets["labels"].long()
    boxes = targets["boxes"].float()
    valid = targets["valid"].bool()
    B, N = labels.shape
    num_boxes = valid.sum().float().clamp(min=1.0)

    def standard_losses(out, assign, nb):
        d = {"loss_ce": focal_label_loss(out["pred_logits"], assign, labels, valid, nb,
                                         focal_alpha)}
        d.update(box_losses(out["pred_boxes"], assign, boxes, valid, nb))
        return d

    aux = list(outputs.get("aux_outputs", []))
    matched = [outputs] + aux + ([outputs["interm_outputs"]] if "interm_outputs" in outputs
                                 else [])
    if assignments is None:
        assignments = match_outputs(matched, labels, boxes, valid, impl=matcher_impl,
                                    cost_class=cost_class, cost_bbox=cost_bbox,
                                    cost_giou=cost_giou, focal_alpha=focal_alpha)

    losses: Dict[str, torch.Tensor] = {}
    losses.update(standard_losses(outputs, assignments[0], num_boxes))
    losses["cardinality_error"] = cardinality_error(outputs["pred_logits"], valid)
    for i, out in enumerate(aux):
        for k, v in standard_losses(out, assignments[1 + i], num_boxes).items():
            losses[f"{k}_{i}"] = v
    if "interm_outputs" in outputs:
        for k, v in standard_losses(outputs["interm_outputs"], assignments[1 + len(aux)],
                                    num_boxes).items():
            losses[f"{k}_interm"] = v

    # DN losses: the fixed slot assignment, no matching
    if "dn_outputs" in outputs and outputs.get("dn_meta") is not None:
        meta = outputs["dn_meta"]
        G = meta.num_groups
        dn_q = dn_assignment(meta.n_max, G, labels.device)
        dn_assign = dn_q[None].expand(B, G * N)
        dn_labels = labels.repeat(1, G)
        dn_boxes = boxes.repeat(1, G, 1)
        dn_valid = valid.repeat(1, G)
        nb_dn = num_boxes * G
        dn_out = outputs["dn_outputs"]
        for suffix, out in [("", dn_out)] + [(f"_{i}", a) for i, a in
                                             enumerate(dn_out.get("aux_outputs", []))]:
            losses[f"loss_ce_dn{suffix}"] = focal_label_loss(
                out["pred_logits"], dn_assign, dn_labels, dn_valid, nb_dn, focal_alpha)
            for k, v in box_losses(out["pred_boxes"], dn_assign, dn_boxes, dn_valid,
                                   nb_dn).items():
                losses[f"{k}_dn{suffix}"] = v

    total = sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
    return total, losses


def build_weight_dict(cfg) -> Dict[str, float]:
    """The loss weights (reference models/dino/dino.py:1124-1165) from an
    object with the config's fields (``getattr`` with the reference's
    defaults where a field is absent)."""
    get = lambda k, d: getattr(cfg, k, d)
    wd = {"loss_ce": cfg.cls_loss_coef, "loss_bbox": cfg.bbox_loss_coef,
          "loss_giou": cfg.giou_loss_coef}
    clean_wo_dn = dict(wd)
    if get("use_dn", True):
        wd.update({"loss_ce_dn": cfg.cls_loss_coef, "loss_bbox_dn": cfg.bbox_loss_coef,
                   "loss_giou_dn": cfg.giou_loss_coef})
    clean = dict(wd)
    if get("aux_loss", True):
        for i in range(cfg.dec_layers - 1):
            wd.update({f"{k}_{i}": v for k, v in clean.items()})
    if get("two_stage_type", "standard") != "no":
        no_box = get("no_interm_box_loss", False)
        coeff = {"loss_ce": 1.0, "loss_bbox": 0.0 if no_box else 1.0,
                 "loss_giou": 0.0 if no_box else 1.0}
        interm_coef = get("interm_loss_coef", 1.0)
        wd.update({f"{k}_interm": v * interm_coef * coeff[k] for k, v in clean_wo_dn.items()})
    wd["loss_CTC"] = get("CTC_loss_coef", 1.0)
    return wd
