"""Detection pretraining entry point (counterpart of
dtlr_tpu/train/pretrain.py): the DINO detection step with contrastive
denoising, the matcher and the detection loss, from a parameter
snapshot, on pre-rendered lines with character boxes.

Usage:
    python -m dtlr_tpu_torch.train.pretrain --params artifacts/r4run_params.npz \\
        --lines lines_with_boxes.npz --output_dir outputs/pretrain --steps 100 \\
        [--val_lines ...] [--device cuda] [--compute_dtype bfloat16] \\
        [--options warmup_steps=0 matcher_impl=scipy ...]

``--lines`` is an npz of pre-rendered lines as ``eval/evaluate.py``'s
``load_lines`` reads them, with per line ``labels`` (N,) int32,
``boxes`` (N, 4) cxcywh in [0, 1] and ``valid`` (N,) bool beside the
uint8 ``images``, ``valid_hw`` and ``texts``
(``dtlr_tpu_torch/assets/smoke_detect.npz`` is one). The settings are the
recipe's (``train/config.py``'s ``RECIPE_DETECTION`` and the model's
``DinoConfig``); ``--options key=value`` overrides any of their fields.
The run takes ``--steps`` steps, saves the train state and the weights
(npz, float32) under ``--output_dir``, and evaluates the detection loss
on ``--val_lines`` (default: the same lines).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..eval.evaluate import load_lines
from ..models.dino import FLAGSHIP
from . import checkpoints as ckpt_lib
from .config import RECIPE_DETECTION
from .engine import Trainer, line_batches
from .finetune import apply_options


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port detection pretraining")
    p.add_argument("--params", required=True, help="parameter snapshot (.npz) to start from")
    p.add_argument("--lines", required=True, help="npz of pre-rendered lines with boxes")
    p.add_argument("--val_lines", default=None, help="npz of validation lines (default --lines)")
    p.add_argument("--output_dir", default="outputs/pretrain")
    p.add_argument("--steps", type=int, default=RECIPE_DETECTION.steps_per_epoch)
    p.add_argument("--compute_dtype", default=FLAGSHIP.compute_dtype,
                   choices=("bfloat16", "float32"))
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value overrides of PretrainConfig or DinoConfig fields")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    model_cfg = dataclasses.replace(FLAGSHIP, compute_dtype=args.compute_dtype)
    cfg, model_cfg = apply_options(RECIPE_DETECTION, model_cfg, args.options)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lines = load_lines(args.lines)
    val_lines = load_lines(args.val_lines) if args.val_lines else lines
    if "boxes" not in lines:
        raise ValueError(f"{args.lines} has no character boxes: the detection step needs "
                         "labels, boxes and valid per line")
    charset = list(lines["charset"])
    trainer = Trainer(cfg, model_cfg, args.output_dir, args.device, mode="detection",
                      seed=args.seed)
    with open(os.path.join(args.output_dir, "config_cfg.json"), "w") as fh:
        json.dump({"train": dataclasses.asdict(cfg), "model": dataclasses.asdict(model_cfg),
                   "args": vars(args)}, fh, indent=1)
    params = ckpt_lib.load_params_npz(args.params)
    trainer.log(f"loaded params snapshot {args.params}")
    trainer.build(params)
    batches = line_batches(lines, cfg.batch_size, charset, cfg.max_targets, seed=args.seed)
    stats = trainer.train_epoch(batches, max_iterations=args.steps)
    trainer.log(f"trained {args.steps} steps: {stats}")
    trainer.save()
    weights = os.path.join(args.output_dir, "params.npz")
    ckpt_lib.export_params_npz(trainer.state.model, weights, dtype=None)
    est = trainer.evaluate_detection(
        line_batches(val_lines, cfg.batch_size, charset, cfg.max_targets))
    return {"train": stats, "eval": est, "params": weights}


if __name__ == "__main__":
    main()
