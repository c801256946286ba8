"""The train state and the CTC finetuning step (counterpart of
dtlr_tpu/train/train_step.py:22-50,109-150).

One step: the forward in train mode (no CDN; the recipe's dropout is 0,
and the port's modules have none), ``ctc_loss``, the backward, the
optimizer's update with the NaN-skip (a non-finite loss zeroes the
gradients and the update, and still advances the optimizer's state,
as JAX's step does), and EMA with a warmed decay. Nothing in the step
waits for the device: the metrics stay tensors until the caller reads
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.dino import DINO
from ..ops.ctc import ctc_loss
from ..ops.pixels import prep_images
from .optim import Optimizer

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
    """ema = ema * decay + (1 - decay) * params, in place."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names],
                        alpha=float(np.float32(1.0) - np.float32(decay)))


def make_ctc_train_step(ctc_eps: float = 0.003, ctc_coef: float = 1.0,
                        ema_decay: float = 0.0) -> Callable[[TrainState, Batch], Tuple[TrainState, dict]]:
    """Returns step(state, batch) -> (state, metrics) with metrics
    ``loss`` (ctc_coef * loss_CTC), ``loss_CTC``, ``skipped`` (1.0 when
    the loss was not finite) and ``grad_norm`` (the gradients' global
    norm before the clip), all 0-d tensors on the model's device.
    ``batch`` holds ``images`` (B, H, W, 3) uint8 or normalized,
    ``valid_hw`` (B, 2), ``labels`` (B, N) and ``valid`` (B, N) on that
    device. ``step.loss_fn(model, batch)`` is the forward and the loss
    alone."""

    def loss_fn(model: DINO, batch: Batch):
        images = prep_images(batch["images"], batch["valid_hw"])
        outputs = model(images, batch["valid_hw"])
        loss, probs = ctc_loss(outputs["pred_logits"], outputs["pred_boxes"],
                               batch["labels"], batch["valid"], eps=ctc_eps)
        return ctc_coef * loss, (loss, probs)

    def step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        total, (raw, _) = loss_fn(model, batch)
        total.backward()
        finite = torch.isfinite(total.detach())
        params = dict(model.named_parameters())
        norm = state.optimizer.step({n: p.grad for n, p in params.items()}, finite)
        if state.ema is not None:
            update_ema(state.ema, params, _warmed_decay(ema_decay, state.step))
        state.step += 1
        metrics = {"loss": total.detach(), "loss_CTC": raw.detach(),
                   "skipped": (~finite).float(), "grad_norm": norm}
        return state, metrics

    step.loss_fn = loss_fn
    return step
