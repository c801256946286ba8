"""CTC finetuning entry point (counterpart of dtlr_tpu/train/finetune.py).

Stage 1 (a fresh run): load a parameter snapshot, optionally rebuild the
class heads for the target charset (``--new_class_embedding``, with
``--smart_mapping`` copying the rows of characters the old charset
has), and train the class heads alone, or the whole model with
``--full_model``. Stage 2 (``--resume_finetuning``): resume the run in
``--output_dir`` and train the whole model.

Usage:
    python -m dtlr_tpu_torch.train.finetune --lines lines.npz \\
        --pretrain_dir artifacts/r4ft_params.npz --full_model \\
        --output_dir outputs/finetune [--epochs 2] [--device cuda] \\
        [--options max_iterations=100 compute_dtype=float32 ...]

``--lines`` is an npz of pre-rendered lines (``data/loaders.py``'s
``NpzLines``: uint8 ``images``, ``valid_hw``, ``texts``, ``charset``);
``--val_lines`` (default: the same file) is evaluated every
``eval_epoch`` epochs. Training lines come reshuffled from
``default_rng(0)`` through the recipe's ``BucketBatcher`` (seed
``--seed``): resized to the drawn scale, squashed to ``image_h_max``
rows, four random erasings, 64-row buckets, uint8; validation lines in
order, unaugmented (seed 7), as dtlr_tpu/train/finetune.py:206-268 has
them. The training settings are the recipe's (``train/config.py``);
``--options key=value`` overrides any field of ``TrainConfig`` or of
the model's ``DinoConfig``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..data.batching import make_batcher
from ..data.charset import load_charset_file, load_default_charset
from ..data.loaders import NpzLines, dataset_iter, eval_iter
from ..models.dino import FLAGSHIP
from . import checkpoints as ckpt_lib
from .config import RECIPE, apply_options
from .engine import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port CTC finetuning")
    p.add_argument("--lines", required=True, help="npz of pre-rendered training lines")
    p.add_argument("--val_lines", default=None, help="npz of validation lines (default --lines)")
    p.add_argument("--output_dir", default="outputs/finetune")
    p.add_argument("--pretrain_dir", default=None, help="parameter snapshot (.npz) to start from")
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value overrides of TrainConfig or DinoConfig fields")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--new_class_embedding", action="store_true")
    p.add_argument("--smart_mapping", action="store_true")
    p.add_argument("--path_old_charset", default=None)
    p.add_argument("--resume_finetuning", action="store_true")
    p.add_argument("--full_model", action="store_true",
                   help="train the whole model in stage 1 instead of the class heads")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, model_cfg = apply_options(RECIPE, FLAGSHIP, args.options)
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    train_ds = NpzLines(args.lines)
    val_ds = NpzLines(args.val_lines) if args.val_lines else train_ds
    charset = train_ds.charset
    trainer = Trainer(cfg, model_cfg, args.output_dir, args.device)
    with open(os.path.join(args.output_dir, "config_cfg.json"), "w") as fh:
        json.dump({"train": dataclasses.asdict(cfg), "model": dataclasses.asdict(model_cfg),
                   "args": vars(args)}, fh, indent=1)

    stage1 = not args.resume_finetuning
    if args.pretrain_dir is not None:
        params = ckpt_lib.load_params_npz(args.pretrain_dir)
        trainer.log(f"loaded pretrain params snapshot {args.pretrain_dir}")
    elif args.resume_finetuning:
        saved = ckpt_lib.restore_checkpoint(os.path.join(args.output_dir, "checkpoint"))
        if saved is None:
            raise FileNotFoundError(f"no checkpoint to resume under {args.output_dir}")
        params = ckpt_lib.params_to_flax(saved["params"])
    else:
        raise ValueError("pass --pretrain_dir (an .npz parameter snapshot) or "
                         "--resume_finetuning: the port does not train from scratch")
    if stage1 and args.new_class_embedding:
        old_charset = (load_default_charset() if args.path_old_charset is None
                       else load_charset_file(args.path_old_charset))
        params = ckpt_lib.surgery_class_heads(
            params, old_charset, charset, torch.Generator().manual_seed(args.seed),
            smart_mapping=args.smart_mapping)
        trainer.log(f"class-head surgery: {len(old_charset)} -> {len(charset)} classes "
                    f"(smart_mapping={args.smart_mapping})")
    if params["params/class_embed/fc/kernel"].shape[-1] != len(charset):
        raise ValueError(f"the model has {params['params/class_embed/fc/kernel'].shape[-1]} "
                         f"classes and the lines' charset {len(charset)}: pass "
                         "--new_class_embedding")

    trainer.build(params, head_only=stage1 and not args.full_model)
    if args.resume_finetuning:
        trainer.try_resume()

    space_label = charset.index(" ") if " " in charset else -1
    train_batches = make_batcher(cfg, dataset_iter(train_ds), True, args.seed, space_label)
    best_cer = float("inf")
    result = {}
    try:
        for epoch in range(trainer.epoch, cfg.epochs):
            stats = trainer.train_epoch(iter(train_batches), max_iterations=cfg.max_iterations)
            trainer.log(f"epoch {epoch}: {stats}")
            trainer.save()
            result = {"train": stats}
            if (epoch + 1) % cfg.eval_epoch == 0:
                val_batches = make_batcher(cfg, eval_iter(val_ds), False, 7, space_label)
                est = trainer.evaluate_ctc(iter(val_batches), charset)
                val_batches.stop()
                result["eval"] = est
                if est["cer"] < best_cer:
                    best_cer = est["cer"]
                    trainer.save("checkpoint_best_regular")
    finally:
        train_batches.stop()
    return result


if __name__ == "__main__":
    main()
