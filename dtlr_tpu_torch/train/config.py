"""The CTC finetuning recipe's training settings.

The port's own copy of the values in outputs/finetune_r4b/config_cfg.py
(the run that finetuned the shipped Latin checkpoints), with the JAX
package's defaults where that file sets nothing. Its ``dropout = 0.0``
has no field: the port's modules have no dropout (``steps_per_epoch``
1250 and ``warmup_steps`` 0, dtlr_tpu/train/optim.py:32-33; ``print_freq``
50, dtlr_tpu/train/engine.py:209).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class TrainConfig:
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
