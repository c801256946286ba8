"""Detection pretraining entry point (counterpart of
dtlr_tpu/train/pretrain.py): epochs of DINO detection steps with
contrastive denoising, the matcher and the detection loss, from a fresh
initialization, a warm start or a parameter snapshot, resumed from the
run's own checkpoint when it has one, with held-out evaluations.

Usage:
    python -m dtlr_tpu_torch.train.pretrain -c dtlr_tpu_torch/configs/Chinese_TPU.py \\
        --dataset_file HWDB_synth --data_root data --output_dir outputs/hwdb \\
        [--warm_start_npz artifacts/r4run_params.npz] [--epochs N] \\
        [--steps_per_epoch N] [--eval_every N] [--seed 42] [--train_seed N] \\
        [--deadline EPOCH_SECONDS] [--deadline_file PATH] [--eval] \\
        [--options key=value ...] [--device cuda] [--compute_dtype bfloat16] [--deterministic]
    python -m dtlr_tpu_torch.train.pretrain -c dtlr_tpu_torch/configs/Latin_TPU.py \\
        --lines lines_with_boxes.npz [--val_lines ...] [--params snapshot.npz] ...

Settings: ``-c`` takes a config file of the JAX package's kind (the
port's copies are ``dtlr_tpu_torch/configs/``; a run's dumped
``config_cfg.py`` works too), ``--options`` overriding its keys, through
``train/config.py``'s ``from_config``; the keys the port does not read
are listed in the run's log. Without ``-c`` the settings are the
flagship recipe's (``RECIPE_DETECTION`` and ``FLAGSHIP``) and
``--options`` overrides their fields.

Lines: ``--dataset_file HWDB_synth`` composes Chinese lines from the GNT
glyph bank under ``--data_root``/HWDB_gnt (data/hwdb_synth.py), the
training stream seeded by ``--train_seed`` (default ``--seed``), the
held-out stream by ``--seed`` + 1; ``--lines`` reads pre-rendered lines
with character boxes from an npz (``data/loaders.py``'s ``NpzLines``;
the Latin renderer needs PIL and fonts and is not ported), reshuffled
from ``default_rng(0)``, the held-out lines in order from ``--val_lines``
(default the same file). ``--dataset_file`` with a real dataset's name
(IAM, READ, RIMES, HWDB, borg, copiale, google1000) builds its ``train``
and ``val`` splits under ``--data_root``; their lines have no character
boxes, so only ``--eval`` reads them (the held-out ``val`` lines) and a
training run raises, as JAX's pretraining refuses them. Either way
through the recipe's
``BucketBatcher`` (seed: the training stream's; with the reuse pool),
as dtlr_tpu/train/pretrain.py:214-246 has it. The class count is the
charset's, the CDN label book keeps the config family's offset (1 for
Latin, 0 for Chinese).

Parameters: the run's own checkpoint under ``--output_dir`` if there is
one (``--resume``, on by default, as in JAX); else ``--params``, an npz
that must fit the model exactly; else a fresh initialization (seed
``--seed``, ``train/init.py``), into which ``--warm_start_npz`` copies
every leaf whose name and shape fit. Each epoch takes
``--steps_per_epoch`` steps and saves the train state (``checkpoint/``,
and ``checkpoint{epoch:04d}/`` every ``save_checkpoint_interval``
epochs); every ``--eval_every`` epochs the held-out set of
``eval_set_size`` lines is read (greedy and NMS CER and the decode's
diagnostics), again with the EMA weights when ``use_ema`` is on. A
deadline stops the run after the epoch that passes it. ``--eval`` only
reads the held-out set. At the end the weights go to ``params.npz``
(float32) and the detection loss of the held-out set is evaluated.
The TPU host's workarounds (the RSS limit, the stall watchdog, the
compilation cache, wandb, multi-host initialization) are left out.

Data parallelism: ``torchrun --nproc_per_node W -m
dtlr_tpu_torch.train.pretrain ...`` with the same arguments trains over W
ranks (NCCL on the cards, one per rank; gloo with ``--device cpu``).
``batch_size`` stays the global batch and W must divide it. Every rank
builds the same batcher from the same seed and keeps its rows of each
batch, so the batches are one process's; rank 0 writes the run's files
and decides the deadline for all. ``--deterministic`` makes a run repeat
bit for bit on the card (``dtlr_tpu_torch.set_deterministic``), with or
without torchrun at world size 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time

import torch

from .. import set_deterministic
from ..data.batching import make_batcher
from ..data.hwdb_synth import hwdb_stream
from ..data.loaders import REAL_DATASETS, NpzLines, build_dataset, dataset_iter, eval_iter
from ..parallel import mesh
from . import checkpoints as ckpt_lib
from .config import dump_run_config, labelbook_offset, load_settings
from .engine import Trainer
from .init import init_params
from .torch_import import load_params_file, merge_params_file


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port detection pretraining")
    p.add_argument("-c", "--config_file", default=None,
                   help="config file (default: the flagship recipe, RECIPE_DETECTION)")
    p.add_argument("--dataset_file", default=None,
                   help="HWDB_synth, or a real dataset's name for --eval; or pass --lines")
    p.add_argument("--data_root", default="./data")
    p.add_argument("--lines", default=None, help="npz of pre-rendered lines with boxes")
    p.add_argument("--val_lines", default=None, help="npz of held-out lines (default --lines)")
    p.add_argument("--params", default=None,
                   help="parameter snapshot (.npz, or a reference .pth) to start from, "
                        "every leaf")
    p.add_argument("--warm_start_npz", default=None,
                   help="npz whose fitting leaves go into the fresh initialization "
                        "(skipped when --output_dir holds a checkpoint)")
    p.add_argument("--output_dir", default="outputs/pretrain")
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value overrides of the config's keys (or, without -c, of "
                        "PretrainConfig's and DinoConfig's fields)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_seed", type=int, default=None,
                   help="seed of the training stream alone (default --seed); the "
                        "held-out set stays pinned to --seed")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True,
                   help="resume the run's own checkpoint if there is one")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--eval", action="store_true", help="read the held-out set and exit")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="epoch seconds: stop after the epoch that passes it")
    p.add_argument("--deadline_file", default=None,
                   help="file holding an epoch-seconds deadline, read after every epoch; "
                        "--deadline while it is missing or unreadable")
    p.add_argument("--compute_dtype", default=None, choices=("bfloat16", "float32"),
                   help="default: the settings'")
    p.add_argument("--device", default="cuda")
    p.add_argument("--deterministic", action="store_true",
                   help="repeat bit for bit on the card (deterministic algorithms; slower)")
    return p.parse_args(argv)


def effective_deadline(args) -> float:
    """The deadline file's value when it reads as a number, else
    ``--deadline``."""
    if args.deadline_file:
        try:
            with open(args.deadline_file) as fh:
                return float(fh.read().strip())
        except (OSError, ValueError):
            pass
    return args.deadline


def line_sources(args, cfg, train_seed: int):
    """The charset, the training stream and the held-out stream."""
    if args.lines and args.dataset_file:
        raise ValueError("pass --lines or --dataset_file, not both")
    if args.dataset_file == "HWDB_synth":
        train = hwdb_stream(args.data_root, train_seed, cfg.hwdb_charset_pickle,
                            cfg.hwdb_glyphs_per_line)
        val = hwdb_stream(args.data_root, args.seed + 1, cfg.hwdb_charset_pickle,
                          cfg.hwdb_glyphs_per_line)
        return train.charset, iter(train), iter(val)
    if args.dataset_file is not None:
        train_ds = build_dataset(args.dataset_file, "train", root=args.data_root)
        val_ds = build_dataset(args.dataset_file, "val", root=args.data_root)
        return train_ds.charset, dataset_iter(train_ds), eval_iter(val_ds)
    if args.lines is None:
        raise ValueError("pass --lines (an npz of lines with boxes) or --dataset_file")
    train_ds = NpzLines(args.lines)
    if "boxes" not in train_ds.arrays:
        raise ValueError(f"{args.lines} has no character boxes: the detection step needs "
                         "labels, boxes and valid per line")
    val_ds = NpzLines(args.val_lines) if args.val_lines else train_ds
    return train_ds.charset, dataset_iter(train_ds), eval_iter(val_ds)


def read_batches(batcher):
    """Every batch of a finite batcher, its thread stopped after."""
    try:
        yield from batcher
    finally:
        batcher.stop()


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.deterministic:
        set_deterministic()
    own_group = not mesh.distributed()
    world = mesh.init_distributed(args.device)
    try:
        return run(args)
    finally:
        if own_group and world.backend is not None:
            mesh.shutdown()


def run(args) -> dict:
    cfg, model_cfg, config, unread = load_settings(args.config_file, args.options, "pretrain")
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.steps_per_epoch is not None:
        cfg = dataclasses.replace(cfg, steps_per_epoch=args.steps_per_epoch)
    if args.compute_dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, compute_dtype=args.compute_dtype)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    train_seed = args.train_seed if args.train_seed is not None else args.seed
    charset, train_iter, val_iter = line_sources(args, cfg, train_seed)
    trainer = Trainer(cfg, model_cfg, args.output_dir, args.device, mode="detection",
                      seed=args.seed, charset=charset)
    if unread:
        trainer.log(f"config keys the port does not read: {unread}")

    # the class count is the charset's; the label book keeps the family's
    # offset (dtlr_tpu/train/pretrain.py:201-212)
    num_classes = len(charset)
    labelbook = num_classes + (labelbook_offset(config) if config is not None else 1)
    result = {"num_classes": num_classes, "warm_start": None, "resumed": None, "epochs": [],
              "train": None}
    if args.params is not None:
        params = load_params_file(args.params, model_cfg)
        trainer.log(f"loaded params snapshot {args.params}")
        classes = params["params/class_embed/fc/kernel"].shape[-1]
        if classes != num_classes:
            raise ValueError(f"the model has {classes} classes and the lines' charset "
                             f"{num_classes}: pretrain on lines of the snapshot's charset")
        labelbook = params["params/label_enc"].shape[0] - 1
    else:
        params = init_params(dataclasses.replace(model_cfg, dn_labelbook_size=labelbook),
                             num_classes, torch.Generator().manual_seed(args.seed))
        ckpt_dir = os.path.join(args.output_dir, "checkpoint")
        if args.warm_start_npz and ckpt_lib.latest_step(ckpt_dir) is None:
            fresh_tree = params
            params, counts = merge_params_file(fresh_tree, args.warm_start_npz,
                                               model_cfg.nheads)
            # a leaf that was not copied is the fresh tree's own array
            fresh = sorted(k for k in params if params[k] is fresh_tree[k])
            result["warm_start"] = {**counts, "fresh_leaves": fresh}
            trainer.log(f"warm start from {args.warm_start_npz}: {counts}, fresh {fresh}")
    result["dn_labelbook_size"] = labelbook
    if trainer.rank == 0:
        with open(os.path.join(args.output_dir, "config_cfg.json"), "w") as fh:
            json.dump({"train": dataclasses.asdict(cfg), "model": dataclasses.asdict(model_cfg),
                       "args": vars(args), "unread_config_keys": unread}, fh, indent=1)
        dump_run_config(os.path.join(args.output_dir, "config_cfg.py"), config, cfg, model_cfg,
                        num_classes, labelbook)

    trainer.build(params)
    if args.resume:
        t0 = time.perf_counter()
        if trainer.try_resume():
            result["resumed"] = {"epoch": trainer.epoch, "step": trainer.state.step,
                                 "seconds": time.perf_counter() - t0}

    space_label = charset.index(" ") if " " in charset else -1
    # the fixed held-out set (dtlr_tpu/train/pretrain.py:231-237)
    eval_samples = list(itertools.islice(val_iter, cfg.eval_set_size))

    def evaluate(use_ema=False, tag="eval"):
        batches = make_batcher(cfg, iter(eval_samples), False, args.seed + 7, space_label,
                               erasing=cfg.truly_random_erasing)
        stats = trainer.evaluate_ctc(read_batches(batches), charset, use_ema=use_ema, tag=tag)
        return {"epoch": trainer.epoch, "tag": tag, **stats}

    if args.eval:
        result["evals"] = [evaluate()]
        return result
    if args.dataset_file in REAL_DATASETS:
        raise ValueError(f"{args.dataset_file}'s lines have no character boxes, which the "
                         "detection step needs (JAX's pretrain refuses real datasets): "
                         "finetune on them with CTC, or read them with --eval")

    batches = make_batcher(cfg, train_iter, True, train_seed, space_label, reuse=cfg.reuse,
                           erasing=cfg.truly_random_erasing)
    try:
        for epoch in range(trainer.epoch, cfg.epochs):
            stats = trainer.train_epoch(iter(batches), max_iterations=cfg.steps_per_epoch)
            trainer.log(f"epoch {epoch}: {stats}")
            trainer.save()
            if (epoch + 1) % cfg.save_checkpoint_interval == 0:
                trainer.save(f"checkpoint{epoch:04d}")
            record = {"epoch": epoch, "train": stats, "evals": []}
            if (epoch + 1) % args.eval_every == 0:
                record["evals"].append(evaluate())
                if cfg.use_ema:
                    record["evals"].append(evaluate(use_ema=True, tag="eval_ema"))
            result["epochs"].append(record)
            result["train"] = stats
            # rank 0's clock and deadline file decide for every rank
            deadline = effective_deadline(args)
            if mesh.broadcast_object(deadline > 0 and time.time() > deadline):
                trainer.log(f"wall-clock deadline reached after epoch {epoch}")
                break
    finally:
        batches.stop()
    weights = os.path.join(args.output_dir, "params.npz")
    if trainer.rank == 0:
        ckpt_lib.export_params_npz(trainer.state.model, weights, dtype=None)
    val_batches = make_batcher(cfg, iter(eval_samples), False, args.seed + 7, space_label,
                               erasing=cfg.truly_random_erasing)
    result["eval"] = trainer.evaluate_detection(read_batches(val_batches))
    result["params"] = weights
    return result


if __name__ == "__main__":
    main()
