"""CTC finetuning entry point (counterpart of dtlr_tpu/train/finetune.py).

Stage 1 (a fresh run): start from a fresh initialization, or from
``--pretrain_dir``: a parameter snapshot (.npz) or a pretraining run's
output directory (the parameters of its newest ``checkpoint/``, taken
whole; none there keeps the fresh start, as JAX's tolerant restore does);
optionally rebuild the class heads for the target charset
(``--new_class_embedding``, with ``--smart_mapping`` copying the rows of
characters the old charset has), and train the class heads alone, or
the whole model with ``--full_model``. Stage 2 (``--resume_finetuning``):
resume the run in ``--output_dir`` and train the whole model.

Usage:
    python -m dtlr_tpu_torch.train.finetune -c dtlr_tpu_torch/configs/HWDB_full_TPU.py \\
        --dataset_file HWDB_synth --data_root data --pretrain_dir outputs/hwdb \\
        --output_dir outputs/hwdb_ft [--epochs 1] [--options max_iterations=2000 ...]
    python -m dtlr_tpu_torch.train.finetune --dataset_file RIMES --data_root data \
        --pretrain_dir artifacts/r4ft_params.npz --full_model --output_dir outputs/rimes_ft
    python -m dtlr_tpu_torch.train.finetune --lines lines.npz \\
        --pretrain_dir artifacts/r4ft_params.npz --full_model \\
        --output_dir outputs/finetune [--epochs 2] [--device cuda] \\
        [--options max_iterations=100 compute_dtype=float32 ...]

Settings: ``-c`` takes a config file (``dtlr_tpu_torch/configs/``, or a
run's dumped ``config_cfg.py``), ``--options`` overriding its keys;
without it the recipe (``train/config.py``'s ``RECIPE`` and the model's
``DinoConfig``), ``--options`` overriding their fields.

Lines: ``--dataset_file`` names a real dataset under ``--data_root``
(IAM, READ, RIMES, HWDB, borg, copiale, google1000; data/loaders.py):
its ``train`` split reshuffled from ``default_rng(0)``, its ``val`` split
held out (dtlr_tpu/train/finetune.py:194-200). ``--dataset_file
HWDB_synth`` composes Chinese lines from the
glyph bank under ``--data_root``/HWDB_gnt, the training stream seeded by
``--seed`` and ``eval_set_size`` held-out lines by ``--seed`` + 999
(dtlr_tpu/train/finetune.py:171-204); ``--lines`` is an npz of
pre-rendered lines (``data/loaders.py``'s ``NpzLines``: uint8 ``images``,
``valid_hw``, ``texts``, ``charset``), reshuffled from ``default_rng(0)``,
with ``--val_lines`` (default: the same file) held out. Training lines
go through the recipe's ``BucketBatcher`` (seed ``--seed``): resized to
the drawn scale, squashed to ``image_h_max`` rows, four random erasings,
64-row buckets, uint8; held-out lines in order, unaugmented (seed 7),
read every ``eval_epoch`` epochs. Every 100 steps the training CER of the
step's batch is logged (dtlr_tpu/train/finetune.py:261). The class count
is the charset's, the CDN label book keeps the config family's offset.

Data parallelism: ``torchrun --nproc_per_node W -m
dtlr_tpu_torch.train.finetune ...`` with the same arguments trains over W
ranks (NCCL on the cards, gloo with ``--device cpu``); ``batch_size`` is
the global batch, which W must divide. Every rank builds the same
batchers and keeps its rows; rank 0 writes the run's files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..data.batching import make_batcher
from ..data.charset import load_charset_file, load_default_charset
from ..data.hwdb_synth import hwdb_stream
from ..data.loaders import NpzLines, build_dataset, dataset_iter, eval_iter
from ..parallel import mesh
from . import checkpoints as ckpt_lib
from .config import dump_run_config, labelbook_offset, load_settings
from .engine import Trainer
from .init import init_params
from .torch_import import is_torch_checkpoint, load_params_file

#: steps between two training CER reads (dtlr_tpu/train/finetune.py:261)
TRAIN_CER_EVERY = 100


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port CTC finetuning")
    p.add_argument("-c", "--config_file", default=None,
                   help="config file (default: the finetune recipe, RECIPE)")
    p.add_argument("--dataset_file", default=None,
                   help="IAM, READ, RIMES, HWDB, borg, copiale, google1000 under --data_root, "
                        "or HWDB_synth; or pass --lines")
    p.add_argument("--data_root", default="./data")
    p.add_argument("--lines", default=None, help="npz of pre-rendered training lines")
    p.add_argument("--val_lines", default=None, help="npz of validation lines (default --lines)")
    p.add_argument("--output_dir", default="outputs/finetune")
    p.add_argument("--pretrain_dir", default=None,
                   help="parameter snapshot (.npz) or a pretraining run's output_dir to start "
                        "from (default: a fresh initialization)")
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value overrides of the config's keys (or, without -c, of "
                        "TrainConfig's and DinoConfig's fields)")
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


def line_sources(args, cfg):
    """The charset, the training stream and the held-out lines."""
    if args.lines and args.dataset_file:
        raise ValueError("pass --lines or --dataset_file, not both")
    if args.dataset_file == "HWDB_synth":
        train = hwdb_stream(args.data_root, args.seed, cfg.hwdb_charset_pickle,
                            cfg.hwdb_glyphs_per_line)
        val = hwdb_stream(args.data_root, args.seed + 999, cfg.hwdb_charset_pickle,
                          cfg.hwdb_glyphs_per_line)
        return train.charset, iter(train), [val.sample() for _ in range(cfg.eval_set_size)]
    if args.dataset_file is not None:
        train_ds = build_dataset(args.dataset_file, "train", root=args.data_root)
        val_ds = build_dataset(args.dataset_file, "val", root=args.data_root)
        return train_ds.charset, dataset_iter(train_ds), val_ds
    if args.lines is None:
        raise ValueError("pass --lines (an npz of lines) or --dataset_file")
    train_ds = NpzLines(args.lines)
    val_ds = NpzLines(args.val_lines) if args.val_lines else train_ds
    return train_ds.charset, dataset_iter(train_ds), val_ds


def pretrained(path: str, trainer: Trainer):
    """The parameters of an npz snapshot or a reference ``.pth``, or of
    the newest train state of a run's ``checkpoint/`` (None if it has
    none)."""
    if path.endswith(".npz") or is_torch_checkpoint(path):
        trainer.log(f"loaded pretrain params snapshot {path}")
        return load_params_file(path, trainer.model_cfg)
    saved = ckpt_lib.restore_checkpoint(os.path.join(path, "checkpoint"))
    if saved is None:
        trainer.log(f"no checkpoint under {path}: keeping the fresh initialization")
        return None
    trainer.log(f"loaded pretrain params from {path} (step {saved['step']})")
    return ckpt_lib.params_to_flax(saved["params"], trainer.model_cfg.nheads)


def main(argv=None) -> dict:
    args = parse_args(argv)
    own_group = not mesh.distributed()
    world = mesh.init_distributed(args.device)
    try:
        return run(args)
    finally:
        if own_group and world.backend is not None:
            mesh.shutdown()


def run(args) -> dict:
    cfg, model_cfg, config, unread = load_settings(args.config_file, args.options, "ctc")
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    charset, train_iter, val_lines = line_sources(args, cfg)
    trainer = Trainer(cfg, model_cfg, args.output_dir, args.device, seed=args.seed,
                      charset=charset)
    if unread:
        trainer.log(f"config keys the port does not read: {unread}")
    num_classes = len(charset)
    labelbook = num_classes + (labelbook_offset(config) if config is not None else 1)

    stage1 = not args.resume_finetuning
    params = None
    if args.resume_finetuning:
        saved = ckpt_lib.restore_checkpoint(os.path.join(args.output_dir, "checkpoint"))
        if saved is None:
            raise FileNotFoundError(f"no checkpoint to resume under {args.output_dir}")
        params = ckpt_lib.params_to_flax(saved["params"], model_cfg.nheads)
    elif args.pretrain_dir is not None:
        params = pretrained(args.pretrain_dir, trainer)
    if params is None:
        params = init_params(dataclasses.replace(model_cfg, dn_labelbook_size=labelbook),
                             num_classes, torch.Generator().manual_seed(args.seed))
        trainer.log("fresh initialization")
    if stage1 and args.new_class_embedding:
        old_charset = (load_default_charset() if args.path_old_charset is None
                       else load_charset_file(args.path_old_charset))
        params = ckpt_lib.surgery_class_heads(
            params, old_charset, charset, torch.Generator().manual_seed(args.seed),
            smart_mapping=args.smart_mapping)
        trainer.log(f"class-head surgery: {len(old_charset)} -> {len(charset)} classes "
                    f"(smart_mapping={args.smart_mapping})")
    if params["params/class_embed/fc/kernel"].shape[-1] != num_classes:
        raise ValueError(f"the model has {params['params/class_embed/fc/kernel'].shape[-1]} "
                         f"classes and the lines' charset {num_classes}: pass "
                         "--new_class_embedding")
    if trainer.rank == 0:
        with open(os.path.join(args.output_dir, "config_cfg.json"), "w") as fh:
            json.dump({"train": dataclasses.asdict(cfg), "model": dataclasses.asdict(model_cfg),
                       "args": vars(args), "unread_config_keys": unread}, fh, indent=1)
        dump_run_config(os.path.join(args.output_dir, "config_cfg.py"), config, cfg, model_cfg,
                        num_classes, params["params/label_enc"].shape[0] - 1)

    trainer.build(params, head_only=stage1 and not args.full_model)
    if args.resume_finetuning:
        trainer.try_resume()

    space_label = charset.index(" ") if " " in charset else -1
    train_batches = make_batcher(cfg, train_iter, True, args.seed, space_label)
    best_cer = float("inf")
    result = {}
    try:
        for epoch in range(trainer.epoch, cfg.epochs):
            stats = trainer.train_epoch(iter(train_batches), max_iterations=cfg.max_iterations,
                                        train_cer_every=TRAIN_CER_EVERY)
            trainer.log(f"epoch {epoch}: {stats}")
            trainer.save()
            result = {"train": stats}
            if (epoch + 1) % cfg.eval_epoch == 0:
                val_batches = make_batcher(cfg, eval_iter(val_lines), False, 7, space_label)
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
