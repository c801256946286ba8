"""Detection pretraining entry point (counterpart of
dtlr_tpu/train/pretrain.py): the DINO detection step with contrastive
denoising, the matcher and the detection loss, from a parameter
snapshot, on pre-rendered lines with character boxes.

Usage:
    python -m dtlr_tpu_torch.train.pretrain --params artifacts/r4run_params.npz \\
        --lines lines_with_boxes.npz --output_dir outputs/pretrain --steps 100 \\
        [--val_lines ...] [--device cuda] [--compute_dtype bfloat16] \\
        [--options warmup_steps=0 matcher_impl=scipy ...]

``--lines`` is an npz of pre-rendered lines (``data/loaders.py``'s
``NpzLines``), with per line ``labels`` (N,) int32, ``boxes`` (N, 4)
cxcywh in [0, 1] and ``valid`` (N,) bool beside the uint8 ``images``,
``valid_hw`` and ``texts`` (``dtlr_tpu_torch/assets/smoke_detect.npz`` is
one). Training lines come reshuffled from ``default_rng(0)`` through the
recipe's ``BucketBatcher`` with the reuse pool (seed ``--seed``), the
validation lines in order, unaugmented (seed ``--seed`` + 7), as
dtlr_tpu/train/pretrain.py:214-246 has them. The settings are the
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

from ..data.batching import make_batcher
from ..data.loaders import NpzLines, dataset_iter, eval_iter
from ..models.dino import FLAGSHIP
from . import checkpoints as ckpt_lib
from .config import RECIPE_DETECTION, apply_options
from .engine import Trainer


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
    train_ds = NpzLines(args.lines)
    val_ds = NpzLines(args.val_lines) if args.val_lines else train_ds
    if "boxes" not in train_ds.arrays:
        raise ValueError(f"{args.lines} has no character boxes: the detection step needs "
                         "labels, boxes and valid per line")
    charset = train_ds.charset
    trainer = Trainer(cfg, model_cfg, args.output_dir, args.device, mode="detection",
                      seed=args.seed)
    with open(os.path.join(args.output_dir, "config_cfg.json"), "w") as fh:
        json.dump({"train": dataclasses.asdict(cfg), "model": dataclasses.asdict(model_cfg),
                   "args": vars(args)}, fh, indent=1)
    params = ckpt_lib.load_params_npz(args.params)
    trainer.log(f"loaded params snapshot {args.params}")
    trainer.build(params)
    space_label = charset.index(" ") if " " in charset else -1
    batches = make_batcher(cfg, dataset_iter(train_ds), True, args.seed, space_label,
                           reuse=cfg.reuse, erasing=cfg.truly_random_erasing)
    try:
        stats = trainer.train_epoch(iter(batches), max_iterations=args.steps)
    finally:
        batches.stop()
    trainer.log(f"trained {args.steps} steps: {stats}")
    trainer.save()
    weights = os.path.join(args.output_dir, "params.npz")
    ckpt_lib.export_params_npz(trainer.state.model, weights, dtype=None)
    val_batches = make_batcher(cfg, eval_iter(val_ds), False, args.seed + 7, space_label,
                               erasing=cfg.truly_random_erasing)
    est = trainer.evaluate_detection(iter(val_batches))
    val_batches.stop()
    return {"train": stats, "eval": est, "params": weights}


if __name__ == "__main__":
    main()
