"""The training recipes' settings: CTC finetuning (``RECIPE``) and the
detection pretraining that made every shipped trunk (``RECIPE_DETECTION``).

The data settings (``DataConfig``), shared by both recipes, are those of
the batches the shipped checkpoints trained on.

CTC finetuning:

The port's own copy of the values in outputs/finetune_r4b/config_cfg.py
(the run that finetuned the shipped Latin checkpoints), with the JAX
package's defaults where that file sets nothing. Its ``dropout = 0.0``
has no field: the port's modules have no dropout (``steps_per_epoch``
1250 and ``warmup_steps`` 0, dtlr_tpu/train/optim.py:32-33; ``print_freq``
50, dtlr_tpu/train/engine.py:209).
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class DataConfig:
    """``BucketBatcher``'s settings (data/batching.py) in the recipe."""

    data_aug_scales: Tuple[int, ...] = (128,)  # finetune_r4b/config_cfg.py:16, round4_chain.sh:52
    data_aug_max_size: int = 1024      # finetune_r4b/config_cfg.py:14, round4_chain.sh:52
    image_w_max: int = 1024            # finetune_r4b/config_cfg.py:51, round4_chain.sh:53
    image_h_max: Optional[int] = 192   # finetune_r4b/config_cfg.py:50, round4_chain.sh:53
    transfer_uint8: bool = True        # finetune_r4b/config_cfg.py:97, Latin_TPU.py:46
    truly_random_erasing: bool = False  # dtlr_tpu/train/pretrain.py:223 (unset in Latin.py)
    h_quant: int = 64                  # dtlr_tpu/data/batching.py:196 (never overridden)
    # the pretraining's sample reuse (synthetic_reuse, Latin_TPU.py:51);
    # the finetune passes none (dtlr_tpu/train/finetune.py:206-214)
    reuse: int = 1


@dataclass
class TrainConfig(DataConfig):
    batch_size: int = 8
    epochs: int = 2
    max_iterations: int = 6000
    eval_epoch: int = 1
    print_freq: int = 50
    max_targets: int = 64
    # optimizer (dtlr_tpu/train/optim.py)
    lr: float = 1e-5
    lr_backbone: float = 1e-10
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.01
    # schedule: StepLR x0.1 at lr_drop epochs, or multistep / onecycle
    lr_drop: int = 11
    steps_per_epoch: int = 1250
    warmup_steps: int = 0
    multi_step_lr: bool = False
    lr_drop_list: Tuple[int, ...] = (33, 45)
    onecyclelr: bool = False
    # the CTC step (dtlr_tpu/train/train_step.py:109-150)
    ctc_eps: float = 0.003
    CTC_loss_coef: float = 1.0
    use_ema: bool = False
    ema_decay: float = 0.9997


RECIPE = TrainConfig()


@dataclass
class PretrainConfig(DataConfig):
    """The detection pretraining recipe that made ``artifacts/r4run_params.npz``
    (scripts/round4_chain.sh:43-56 on dtlr_tpu/configs/Latin_TPU.py and its
    base Latin.py). Each value's source is beside it. The model's CDN
    settings and target capacity are ``DinoConfig``'s (models/dino.py)."""

    batch_size: int = 8                # round4_chain.sh:51
    epochs: int = 400                  # round4_chain.sh:49
    steps_per_epoch: int = 500         # round4_chain.sh:48
    print_freq: int = 50               # dtlr_tpu/train/engine.py:209
    max_targets: int = 64              # round4_chain.sh:52
    # optimizer (dtlr_tpu/train/optim.py)
    lr: float = 1e-4                   # Latin.py:9
    lr_backbone: float = 1e-4          # Latin_TPU.py:19, round4_chain.sh:55
    weight_decay: float = 1e-4         # Latin.py:16
    clip_max_norm: float = 0.1         # Latin.py:20
    lr_drop: int = 50000               # round4_chain.sh:54 (no drop in the run)
    warmup_steps: int = 200            # round4_chain.sh:51
    multi_step_lr: bool = False        # Latin.py:22
    lr_drop_list: Tuple[int, ...] = (33, 45)  # Latin.py:23
    onecyclelr: bool = False           # Latin.py:21
    use_ema: bool = True               # round4_chain.sh:51
    reuse: int = 4                     # synthetic_reuse, Latin_TPU.py:51
    ema_decay: float = 0.9997          # Latin.py:86
    # matcher (dtlr_tpu/ops/matcher.py) and loss (dtlr_tpu/losses/criterion.py)
    matcher_impl: str = "jax"          # Latin.py:99, the auction
    set_cost_class: float = 2.0        # Latin.py:65
    set_cost_bbox: float = 5.0         # Latin.py:66
    set_cost_giou: float = 2.0         # Latin.py:67
    cls_loss_coef: float = 1.0         # Latin.py:68
    bbox_loss_coef: float = 5.0        # Latin.py:69
    giou_loss_coef: float = 2.0        # Latin.py:70
    focal_alpha: float = 0.25          # Latin.py:74
    # build_weight_dict's defaults are the recipe's: aux_loss (Latin.py:50),
    # two_stage_type "standard" (:45), interm_loss_coef 1 (:72),
    # no_interm_box_loss False (:73)


RECIPE_DETECTION = PretrainConfig()


def _parse_value(text: str, kind):
    if typing.get_origin(kind) is typing.Union:  # Optional[int]
        if text.lower() == "none":
            return None
        kind = typing.get_args(kind)[0]
    if kind is bool:
        if text.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"not a bool: {text!r}")
        return text.lower() in ("true", "1")
    if typing.get_origin(kind) is tuple:
        return tuple(int(v) for v in text.strip("()[]").split(",") if v.strip())
    return kind(text)


def apply_options(train_cfg, model_cfg, options):
    """``key=value`` strings onto the training settings (a ``TrainConfig``
    or ``PretrainConfig``) and the model's ``DinoConfig``; each key belongs
    to one of them, an unknown key raises."""
    train_hints = typing.get_type_hints(type(train_cfg))
    model_hints = typing.get_type_hints(type(model_cfg))
    train_kw, model_kw = {}, {}
    for opt in options or ():
        key, _, value = opt.partition("=")
        if key in train_hints:
            train_kw[key] = _parse_value(value, train_hints[key])
        elif key in model_hints:
            model_kw[key] = _parse_value(value, model_hints[key])
        else:
            raise KeyError(f"unknown option {key!r}")
    return dataclasses.replace(train_cfg, **train_kw), dataclasses.replace(model_cfg, **model_kw)
