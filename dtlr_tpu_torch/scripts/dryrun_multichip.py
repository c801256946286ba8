"""The multi-rank dry run (counterpart of __graft_entry__.py:54-127
``dryrun_multichip``): the full detection training step over W
data-parallel ranks, one step on tiny shapes.

The JAX package's tiny model (``_latin_model(tiny=True)``: 166 classes,
60 queries, hidden 64, 1 deformable encoder layer, 2 decoder layers with
deformable cross-attention, CDN with dn_number 4 over 8 target slots,
GroupNorm, float32) with 2 heads of 32 in place of JAX's 4 of 16: the
attention kernel is built for the head size of every recipe (256 / 8 =
32) and raises on another, freshly initialized from seed 0,
the loss weights of configs/Latin.py, ``adamw(1e-4)`` (no clip, no
EMA), and JAX's global batch of W lines from ``np.random.default_rng(0)``:
uint8 64x128 pixels, 8 targets a line with labels in [0, 166) and boxes
in [0.3, 0.6]. Each rank takes its rows, the step sums the gradients
over the ranks; the run fails on a non-finite loss or on ranks whose
parameters after the step differ, and rank 0 prints
``dryrun_multichip(W) OK: loss=...``.

Usage:
    python -m dtlr_tpu_torch.scripts.dryrun_multichip --n 2 [--device cuda] [--backend gloo]
        (starts the W ranks itself through torch.distributed.run)
    torchrun --nproc_per_node 2 -m dtlr_tpu_torch.scripts.dryrun_multichip [--device cpu]
        (one rank of W)
``--device cuda`` puts rank r on ``cuda:r`` over NCCL; ``--device cuda:0
--backend gloo`` puts every rank on the one card over gloo.
"""

from __future__ import annotations

import argparse
import math
import os
import re
import sys

import numpy as np
import torch

from .. import resolve_device
from ..config import load_config
from ..losses.criterion import build_weight_dict
from ..models.dino import DinoConfig, build_dino
from ..parallel import launch, mesh
from ..train.checkpoints import state_sha256
from ..train.init import init_params
from ..train.optim import Optimizer
from ..train.train_step import init_train_state, make_detection_train_step
from ..weights import load_into

NUM_CLASSES = 166
#: __graft_entry__.py:11-18, 2 heads of 32 (the kernel's head size) for 4 of 16
TINY_LATIN = DinoConfig(num_queries=60, hidden_dim=64, nheads=2, enc_layers=1, dec_layers=2,
                        dim_feedforward=128, use_dn=True, dn_number=4, dn_labelbook_size=167,
                        encoder_type="deformable", decoder_ca="deform", dense_box_bias=False,
                        shared_offsets=False, norm_kind="group", compute_dtype="float32")
H, W, N_TARGETS = 64, 128, 8
LATIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                     "Latin.py")
MODULE = "dtlr_tpu_torch.scripts.dryrun_multichip"
OK = re.compile(r"dryrun_multichip\((\d+)\) OK: loss=(\S+)")


def global_batch(n: int) -> dict:
    """__graft_entry__.py:94-104: the same draws in the same order."""
    rng = np.random.default_rng(0)
    return {"images": rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
            "valid_hw": np.tile(np.asarray([[H, W]], np.int32), (n, 1)),
            "labels": rng.integers(0, NUM_CLASSES, (n, N_TARGETS)).astype(np.int32),
            "boxes": rng.uniform(0.3, 0.6, (n, N_TARGETS, 4)).astype(np.float32),
            "valid": np.ones((n, N_TARGETS), bool)}


def rank_step(device: str, backend=None, lines=None) -> float:
    """One rank's part: the step on its rows of a global batch of
    ``lines`` (default: one a rank); returns the global loss."""
    own_group = not mesh.distributed()
    world = mesh.init_distributed(device, backend)
    try:
        dev = resolve_device(device)
        n = lines or world.world_size
        model = build_dino(TINY_LATIN, NUM_CLASSES, str(dev))
        load_into(model, init_params(TINY_LATIN, NUM_CLASSES, torch.Generator().manual_seed(0)))
        params = dict(model.named_parameters())
        tx = Optimizer(params, dict.fromkeys(params, "main"), {"main": lambda count: 1e-4},
                       clip_max_norm=0.0, weight_decay=1e-4)
        state = init_train_state(model, tx, use_ema=False)
        step = make_detection_train_step(NUM_CLASSES, build_weight_dict(load_config(LATIN)))
        rows = mesh.shard_batch(global_batch(n), world.rank, world.world_size)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        state, metrics = step(state, batch, torch.Generator(dev).manual_seed(0))
        loss = float(metrics["loss"])
        digests = mesh.all_gather_object(state_sha256(dict(model.named_parameters())))
        if not math.isfinite(loss):
            raise AssertionError(f"multichip dryrun loss not finite: {loss}")
        if len(set(digests)) != 1:
            raise AssertionError(f"the ranks' parameters differ after the step: {digests}")
        if world.rank == 0:
            print(f"dryrun_multichip({world.world_size}) OK: loss={loss:.4f}", flush=True)
        return loss
    finally:
        if own_group:
            mesh.shutdown()


def dryrun_multichip(n_devices: int, device: str = "cuda", backend=None,
                     timeout: float = 600.0, threads=None) -> float:
    """Start ``n_devices`` ranks through torch.distributed.run and return
    the step's loss; raises if the run fails or passes ``timeout``."""
    args = ["--device", device] + (["--backend", backend] if backend else [])
    done = launch.launch(n_devices, MODULE, args, timeout=timeout, threads=threads)
    found = OK.search(done.stdout)
    if done.returncode != 0 or found is None or int(found.group(1)) != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed ({done.returncode}):\n"
                           f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    print(found.group(0), flush=True)
    return float(found.group(2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multi-rank dry run of the detection step")
    p.add_argument("--n", type=int, default=None,
                   help="ranks to start (without torchrun's environment)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="default: nccl on CUDA, gloo on the CPU")
    args = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        rank_step(args.device, args.backend)
    else:
        dryrun_multichip(args.n or 1, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
