"""The train state, the detection training step and the CTC finetuning
step (counterpart of dtlr_tpu/train/train_step.py:22-150).

One step: the forward in train mode (dropout at the model's rate, drawn
from the step's generator ``dropout``, JAX's ``rngs={"dropout": ...}``;
the recipes' rate is 0), the loss (the DINO detection loss with its
contrastive denoising queries, or ``ctc_loss``), the backward, the
optimizer's update with the NaN-skip (a non-finite loss zeroes the
gradients and the update, and still advances the optimizer's state,
as JAX's step does), and EMA with a warmed decay. The CTC step never
waits for the device: its metrics stay tensors until the caller reads
them. The detection step's matcher reads from the device (a few flags
per step for the auction, the costs for the scipy path).

Data parallelism (a process group, ``parallel/mesh.py``): each rank
steps on its rows of the global batch (an even share: ``batch_size`` is
the global batch, as JAX's mesh shards it); the losses divide by the
global batch's normalizers, the gradients, the total and the terms are
summed over the ranks in one collective after the backward
(``_all_reduce``), and the denoising noise is the global batch's draws
cut to the rank's rows. Without a group nothing of this runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..losses.criterion import detection_loss
from ..models.cdn import CdnDraws, draw_cdn_noise, take_rows
from ..models.dino import DINO
from ..ops.ctc import ctc_loss
from ..ops.matcher import match_outputs
from ..ops.pixels import prep_images
from ..parallel import mesh
from .optim import Optimizer, label_params

Batch = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The model (whose parameters are the fp32 master weights), its
    optimizer, the steps taken and, with EMA, the averaged parameters by
    name."""

    model: DINO
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def init_train_state(model: DINO, optimizer: Optimizer, use_ema: bool = False) -> TrainState:
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if use_ema else None)
    return TrainState(model, optimizer, 0, ema)


def _warmed_decay(ema_decay: float, step: int) -> float:
    """EMA decay with warmup, min(decay, (1+t)/(10+t)) in float32: early
    on the average follows the weights closely, later at ``ema_decay``."""
    t = np.float32(step)
    return float(min(np.float32(ema_decay),
                     np.float32(np.float32(1.0) + t) / np.float32(np.float32(10.0) + t)))


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float) -> None:
    """ema = ema * decay + (1 - decay) * params, in place, for every
    parameter but the frozen norms' statistics: the optimizer never moves
    them, so their average is their value, which float rounding of the
    weighted sum could otherwise move by an ulp."""
    labels = label_params(list(ema))
    names = [n for n in ema if labels[n] != "frozen"]
    if not names:
        return
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names],
                        alpha=float(np.float32(1.0) - np.float32(decay)))


def _apply_update(state: TrainState, total: torch.Tensor, ema_decay: float) -> torch.Tensor:
    """The backward's gradients through the optimizer (NaN-skip on a
    non-finite ``total``) and EMA; returns the gradients' global norm."""
    finite = torch.isfinite(total.detach())
    params = dict(state.model.named_parameters())
    norm = state.optimizer.step({n: p.grad for n, p in params.items()}, finite)
    if state.ema is not None:
        update_ema(state.ema, params, _warmed_decay(ema_decay, state.step))
    state.step += 1
    return norm


def _no_mark(phase: str) -> None:
    pass


def _all_reduce(model: DINO, total: torch.Tensor, terms: Dict[str, torch.Tensor]):
    """Sum the backward's gradients and the loss terms over the ranks in
    one collective (``parallel.all_reduce_coalesced``): every parameter's
    gradient in the model's order, a zero one where the parameter got none
    (as optax sees a leaf that the loss does not reach), then the total
    and the terms. The sums go back into ``p.grad``; returns the global
    total and terms. Each rank's loss is its share of the global loss (the
    losses divide by the global batch's normalizers), so the sums are one
    process's step on the whole batch, and every rank gets the same bits:
    the clip, the NaN-skip, AdamW and EMA then take the same branch and
    the same values on every rank."""
    params = [p for p in model.parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    names = list(terms)
    scalars = torch.stack([total.detach().float()] + [terms[k].detach().float() for k in names])
    reduced = mesh.all_reduce_coalesced(grads + [scalars])
    for p, g in zip(params, reduced):
        p.grad = g
    return reduced[-1][0], dict(zip(names, reduced[-1][1:]))


def _rank_noise(model: DINO, batch: Batch, cdn_noise):
    """The rank's denoising noise under data parallelism: the global
    batch's draws (from the generator, or as given) cut to the rank's
    rows, so that the ranks draw what one process draws."""
    if not model.cfg.use_dn:
        return cdn_noise
    W, B = mesh.world_size(), batch["labels"].shape[0]
    rows = mesh.shard_rows(B * W, mesh.rank(), W)
    if isinstance(cdn_noise, CdnDraws):
        return take_rows(cdn_noise, rows)
    return draw_cdn_noise(B * W, batch["labels"].shape[1], model.cfg.dn_number,
                          model.num_classes, cdn_noise, batch["labels"].device, rows)


def make_detection_train_step(num_classes: int, weight_dict: Dict[str, float],
                              focal_alpha: float = 0.25, matcher_impl: str = "jax",
                              cost_class: float = 2.0, cost_bbox: float = 5.0,
                              cost_giou: float = 2.0, ema_decay: float = 0.0):
    """Returns step(state, batch, cdn_noise=None, mark=None, dropout=None)
    -> (state, metrics), the counterpart of dtlr_tpu/train/train_step.py:52-106.
    ``batch`` holds ``images`` (B, H, W, 3) uint8 or normalized,
    ``valid_hw`` (B, 2), ``labels`` (B, N), ``boxes`` (B, N, 4) cxcywh in
    [0, 1] and ``valid`` (B, N) on the model's device; ``cdn_noise`` is
    the generator of the denoising queries' noise or the draws
    (``models/cdn.py``); ``mark(phase)``, when given, is called as each of
    "forward", "matching", "loss", "backward" and "update" ends (a
    profiler records events there); ``dropout`` the generator of the
    dropout masks (the global one when None). Metrics: ``loss`` (the weighted
    total), ``skipped`` (1.0 when it was not finite), ``grad_norm``
    (before the clip) and every unweighted loss term, all 0-d tensors.
    ``step.loss_fn(model, batch, cdn_noise, mark, dropout)`` is the
    forward and the loss alone, returning (total, terms)."""

    def loss_fn(model: DINO, batch: Batch, cdn_noise=None, mark=_no_mark, dropout=None):
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        images = prep_images(batch["images"], batch["valid_hw"])
        if mesh.world_size() > 1:
            cdn_noise = _rank_noise(model, batch, cdn_noise)
        outputs = model(images, batch["valid_hw"], targets, train=True, cdn_noise=cdn_noise,
                        dropout=dropout)
        mark("forward")
        matched = [outputs] + list(outputs.get("aux_outputs", [])) + (
            [outputs["interm_outputs"]] if "interm_outputs" in outputs else [])
        assignments = match_outputs(matched, targets["labels"].long(), targets["boxes"].float(),
                                    targets["valid"].bool(), impl=matcher_impl, cost_class=cost_class,
                                    cost_bbox=cost_bbox, cost_giou=cost_giou,
                                    focal_alpha=focal_alpha)
        mark("matching")
        result = detection_loss(outputs, targets, num_classes, weight_dict,
                                focal_alpha=focal_alpha, assignments=assignments)
        mark("loss")
        return result

    def step(state: TrainState, batch: Batch, cdn_noise=None, mark=None, dropout=None):
        mark = mark or _no_mark
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        total, losses = loss_fn(model, batch, cdn_noise, mark, dropout)
        total.backward()
        if mesh.distributed():
            total, losses = _all_reduce(model, total, losses)
        mark("backward")
        norm = _apply_update(state, total, ema_decay)
        mark("update")
        metrics = {"loss": total.detach(), "skipped": (~torch.isfinite(total.detach())).float(),
                   "grad_norm": norm}
        metrics.update({k: v.detach() for k, v in losses.items()})
        return state, metrics

    step.loss_fn = loss_fn
    return step


def make_ctc_train_step(ctc_eps: float = 0.003, ctc_coef: float = 1.0,
                        ema_decay: float = 0.0) -> Callable[[TrainState, Batch], Tuple[TrainState, dict]]:
    """Returns step(state, batch, dropout=None) -> (state, metrics) with
    metrics
    ``loss`` (ctc_coef * loss_CTC), ``loss_CTC``, ``skipped`` (1.0 when
    the loss was not finite) and ``grad_norm`` (the gradients' global
    norm before the clip), all 0-d tensors on the model's device.
    ``batch`` holds ``images`` (B, H, W, 3) uint8 or normalized,
    ``valid_hw`` (B, 2), ``labels`` (B, N) and ``valid`` (B, N) on that
    device; ``dropout`` the generator of the dropout masks. The forward is
    in train mode without targets, as JAX's (no denoising queries).
    ``step.loss_fn(model, batch, dropout)`` is the forward and the loss
    alone."""

    def loss_fn(model: DINO, batch: Batch, dropout=None):
        images = prep_images(batch["images"], batch["valid_hw"])
        outputs = model(images, batch["valid_hw"], train=True, dropout=dropout)
        W = mesh.world_size()
        loss, probs = ctc_loss(outputs["pred_logits"], outputs["pred_boxes"],
                               batch["labels"], batch["valid"], eps=ctc_eps,
                               lines=batch["labels"].shape[0] * W if W > 1 else None)
        return ctc_coef * loss, (loss, probs)

    def step(state: TrainState, batch: Batch, dropout=None):
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        total, (raw, _) = loss_fn(model, batch, dropout)
        total.backward()
        if mesh.distributed():
            total, raw = _all_reduce(model, total, {"loss_CTC": raw})
            raw = raw["loss_CTC"]
        norm = _apply_update(state, total, ema_decay)
        metrics = {"loss": total.detach(), "loss_CTC": raw.detach(),
                   "skipped": (~torch.isfinite(total.detach())).float(), "grad_norm": norm}
        return state, metrics

    step.loss_fn = loss_fn
    return step
