"""Parameter groups, learning-rate schedules, the global-norm clip and
AdamW with optax's semantics (counterpart of dtlr_tpu/train/optim.py).

``build_optimizer`` is optax's ``chain(clip_by_global_norm(clip),
multi_transform({"main": adamw(lr), "backbone": adamw(lr_backbone),
"frozen": set_to_zero()}))`` and ``build_head_only_optimizer`` the same
with only the class heads and the label encoder trained. What optax does
and ``torch.optim.AdamW`` does not, and this optimizer does:

- the clip takes the norm of every gradient, those of parameters that no
  group updates included;
- a parameter that got no gradient counts as a zero gradient: its
  moments decay and weight decay still shrinks it (optax decays every
  leaf, biases, norms and ``ca_box_gamma`` too);
- the schedule is read at the step count before the increment, and the
  bias corrections at the count after it;
- ``eps`` is added outside the square root;
- a step whose loss is not finite (``finite`` False) zeroes the
  gradients and still advances the moments and the count, then leaves
  every parameter as it was, as dtlr_tpu/train/train_step.py:135-140
  does; ``finite`` may stay on the device, so the step never syncs.

Schedules are computed in float32 on the host, as optax's are on the
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]

HEAD_SCOPES = ("class_embed", "enc_out_class_embed", "label_enc")


def label_params(names: Sequence[str]) -> Dict[str, str]:
    """The group of each parameter name: ``frozen`` for frozen-norm
    statistics (none in the GroupNorm recipe), ``backbone`` for the
    ResNet, ``main`` for the rest."""
    def label(name: str) -> str:
        if "FrozenBatchNorm" in name:
            return "frozen"
        if "backbone_net" in name:
            return "backbone"
        return "main"

    return {n: label(n) for n in names}


def _f32(x) -> np.float32:
    return np.float32(x)


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: Mapping[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule: each scale applies from its
    boundary on (count >= boundary)."""
    def schedule(count: int) -> float:
        v = _f32(init_value)
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v = _f32(_f32(scale) * v)
        return float(v)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule from ``init_value`` to ``end_value``."""
    if transition_steps <= 0:
        return lambda count: float(_f32(init_value))

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = _f32(1.0) - _f32(_f32(c) / _f32(transition_steps))
        return float(_f32(_f32(init_value - end_value) * frac) + _f32(end_value))

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: past a boundary the next schedule reads the
    steps since that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div_factor up to
    the peak at ``pct_start`` of the steps, then down to
    peak/(div_factor*final_div_factor)."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs transition_steps > 0")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return float(_f32(values[-1]))
        i = 0 if count < bounds[1] else 1
        pct = _f32(_f32(count - bounds[i]) / _f32(bounds[i + 1] - bounds[i]))
        # the half-difference in float64, the rest in float32, as optax
        half = _f32((values[i] - values[i + 1]) / 2.0)
        cos = _f32(np.cos(_f32(np.pi) * pct))
        return float(_f32(_f32(values[i + 1]) + _f32(half * _f32(cos + _f32(1.0)))))

    return schedule


def make_lr_schedule(base_lr: float, cfg) -> Schedule:
    """StepLR (x0.1 at ``lr_drop`` epochs of ``steps_per_epoch`` steps),
    multistep (x0.1 at each of ``lr_drop_list``) or onecycle over
    ``epochs``, after a linear warmup of ``warmup_steps`` from 0."""
    spe = int(cfg.steps_per_epoch)
    if cfg.onecyclelr:
        return cosine_onecycle_schedule(cfg.epochs * spe, base_lr)
    if cfg.multi_step_lr:
        main = piecewise_constant_schedule(base_lr, {int(e * spe): 0.1 for e in cfg.lr_drop_list})
    else:
        main = piecewise_constant_schedule(base_lr, {int(cfg.lr_drop * spe): 0.1})
    if cfg.warmup_steps > 0:
        return join_schedules([linear_schedule(0.0, base_lr, cfg.warmup_steps), main],
                              [cfg.warmup_steps])
    return main


class Optimizer:
    """Global-norm clip, then AdamW per group (optax.adamw with b1, b2,
    eps and weight decay; no mask), on named parameters.

    ``schedules`` maps each trained group to its schedule; a group that
    is not in it is not updated (optax's ``set_to_zero``) and keeps no
    state. ``state`` holds ``count`` (the steps taken, on the host) and
    per trained parameter the moments ``mu`` and ``nu``."""

    def __init__(self, params: Mapping[str, torch.Tensor], labels: Mapping[str, str],
                 schedules: Mapping[str, Schedule], clip_max_norm: float,
                 weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = dict(params)
        self.labels = dict(labels)
        self.schedules = dict(schedules)
        self.clip_max_norm = clip_max_norm
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.groups = {g: [n for n in self.params if self.labels[n] == g]
                       for g in self.schedules}
        self.state = {"count": 0,
                      "mu": {n: torch.zeros_like(self.params[n]) for ns in self.groups.values()
                             for n in ns},
                      "nu": {n: torch.zeros_like(self.params[n]) for ns in self.groups.values()
                             for n in ns}}

    @torch.no_grad()
    def clip(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Scale ``grads`` in place to a global norm of at most
        ``clip_max_norm``; returns the norm before the clip."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_max_norm > 0:
            scale = torch.where(norm < self.clip_max_norm, torch.ones_like(norm),
                                self.clip_max_norm / norm)
            torch._foreach_mul_(grads, scale)
        return norm

    @torch.no_grad()
    def step(self, grads: Mapping[str, Optional[torch.Tensor]],
             finite: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from ``grads`` (name -> gradient, None for none);
        ``finite`` (a bool tensor) False skips the update as the class
        docstring says. Returns the gradients' global norm before the
        clip (0 on a skipped step)."""
        names = list(self.params)
        g = [grads.get(n) for n in names]
        g = [torch.zeros_like(self.params[n]) if x is None else x.detach().float().clone()
             for n, x in zip(names, g)]
        if finite is not None:
            g = [torch.where(finite, x, torch.zeros((), dtype=x.dtype, device=x.device))
                 for x in g]
        norm = self.clip(g)
        by_name = dict(zip(names, g))
        count = self.state["count"]
        c = count + 1
        bc1 = float(_f32(1.0) - _f32(self.b1) ** _f32(c))
        bc2 = float(_f32(1.0) - _f32(self.b2) ** _f32(c))
        keep = None if finite is None else finite.to(torch.float32)
        for group, members in self.groups.items():
            if not members:
                continue
            lr = self.schedules[group](count)
            p = [self.params[n] for n in members]
            gr = [by_name[n] for n in members]
            mu = [self.state["mu"][n] for n in members]
            nu = [self.state["nu"][n] for n in members]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, gr, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, gr, gr, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if self.weight_decay:
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -lr)
            if keep is not None:
                torch._foreach_mul_(upd, keep)
            torch._foreach_add_(p, upd)
        self.state["count"] = c
        return norm

    def state_dict(self) -> dict:
        return {"count": self.state["count"], "mu": dict(self.state["mu"]),
                "nu": dict(self.state["nu"])}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore a ``state_dict``; raises KeyError if its moments are not
        this optimizer's (another stage's groups)."""
        if set(state["mu"]) != set(self.state["mu"]) or set(state["nu"]) != set(self.state["nu"]):
            raise KeyError("optimizer state holds other parameters than this optimizer trains")
        for key in ("mu", "nu"):
            for n, t in state[key].items():
                self.state[key][n].copy_(t)
        self.state["count"] = int(state["count"])


def build_optimizer(cfg, params: Mapping[str, torch.Tensor]) -> Optimizer:
    """The full-model optimizer: ``main`` at ``lr``, ``backbone`` at
    ``lr_backbone``, ``frozen`` not updated."""
    return Optimizer(params, label_params(list(params)),
                     {"main": make_lr_schedule(cfg.lr, cfg),
                      "backbone": make_lr_schedule(cfg.lr_backbone, cfg)},
                     clip_max_norm=cfg.clip_max_norm, weight_decay=cfg.weight_decay)


def build_head_only_optimizer(cfg, params: Mapping[str, torch.Tensor],
                              head_scopes: Sequence[str] = HEAD_SCOPES) -> Optimizer:
    """Stage 1 of CTC finetuning: only the class heads and the label
    encoder train, at ``lr``; the clip still takes every gradient's norm."""
    labels = {n: "head" if any(s in n for s in head_scopes) else "rest" for n in params}
    return Optimizer(params, labels, {"head": make_lr_schedule(cfg.lr, cfg)},
                     clip_max_norm=cfg.clip_max_norm, weight_decay=cfg.weight_decay)
