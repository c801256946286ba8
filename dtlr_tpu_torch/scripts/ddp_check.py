"""Data-parallel train steps, recorded for a comparison with one process.

The recipe's ``Trainer`` (detection or CTC mode) takes the given global
batches one step each, over the ranks of the process group (under
``torchrun``) or in one process (without it). Each rank writes
``rank{r}.json`` under ``--out``: per step the global metrics, the ms
(host clock, the card synchronized before and after) and the attention
kernels' launches; after the steps a sha256 of its train state
(parameters, optimizer state, step, EMA); its peak memory; and the
ms of the gradients' all-reduce alone (``parallel.all_reduce_coalesced``
over buffers of the gradients' sizes, the card synchronized around
it). Rank 0 also writes ``grads.npz``, the first step's global gradient
of every parameter (what the optimizer took, before the clip), and with
``--save_state`` ``state.npz``, the parameters (``params/<name>``) and EMA
(``ema/<name>``) after the last step. Two runs, one over W ranks and one
in one process, on the same batches, then show whether the W ranks agree
bit for bit and step as one process does.

Usage:
    torchrun --nproc_per_node W -m dtlr_tpu_torch.scripts.ddp_check --mode detection \\
        --params artifacts/r4run_params.npz --batches batches.npz --out DIR \\
        [--device cuda] [--backend gloo] [--options key=value ...] [--cdn_draws draws.npz]
``--batches``: an npz of ``images`` (S, B, H, W, 3), ``valid_hw`` (S, B, 2),
``labels`` and ``valid`` (S, B, N) and in detection mode ``boxes`` (S, B,
N, 4), S global batches of B lines. ``--cdn_draws``: the denoising noise
of each step's global batch (``flip``, ``label``, ``sign``, ``mag``, each
(S, B, ...) as ``models/cdn.py``'s ``CdnDraws``) in place of the
trainer's seeded generator. ``--options`` override the recipe's fields
(``train/config.py``), ``--compute_dtype`` the model's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..models.cdn import CdnDraws
from ..ops.flash_attn import flash_mha, reset_launches
from ..parallel import mesh
from ..train.checkpoints import state_sha256
from ..train.config import load_settings
from ..train.engine import Trainer, rank_rows, to_device
from ..train.torch_import import load_params_file

# the trainer's seed (its CDN noise) and the all-reduce's timed calls
SEED, ALLREDUCE_REPS = 0, 5


def parse_args(argv=None):
    p = argparse.ArgumentParser("data-parallel train steps, recorded")
    p.add_argument("--mode", choices=("detection", "ctc"), required=True)
    p.add_argument("--params", required=True)
    p.add_argument("--batches", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--cdn_draws", default=None)
    p.add_argument("--options", nargs="*", default=None)
    p.add_argument("--compute_dtype", default="float32", choices=("bfloat16", "float32"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="default: nccl on CUDA, gloo on the CPU")
    p.add_argument("--save_state", action="store_true")
    return p.parse_args(argv)


def state_digests(trainer: Trainer) -> dict:
    """The train state's sha256 (parameters, optimizer state, step, EMA),
    its optimizer count and step."""
    return {"sha256": state_sha256(trainer.checkpoint_state()),
            "count": trainer.state.optimizer.state["count"], "step": trainer.state.step}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allreduce_ms(trainer: Trainer, reps: int = ALLREDUCE_REPS):
    """The gradients' all-reduce alone: median ms over ``reps`` calls."""
    if not mesh.distributed():
        return None
    dev = trainer.device
    bufs = [torch.zeros_like(p) for p in trainer.state.model.parameters()]
    times = []
    for _ in range(reps + 1):
        mesh.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        mesh.all_reduce_coalesced(bufs)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def main(argv=None) -> dict:
    args = parse_args(argv)
    own_group = not mesh.distributed()
    world = mesh.init_distributed(args.device, args.backend)
    try:
        return run(args, world)
    finally:
        if own_group and world.backend is not None:
            mesh.shutdown()


def run(args, world) -> dict:
    kind = "pretrain" if args.mode == "detection" else "ctc"
    cfg, model_cfg, _, _ = load_settings(None, args.options, kind)
    model_cfg = dataclasses.replace(model_cfg, compute_dtype=args.compute_dtype)
    with np.load(args.batches) as z:
        batches = {k: z[k] for k in z.files}
    steps, B = batches["images"].shape[:2]
    cfg = dataclasses.replace(cfg, batch_size=B)
    draws = None
    if args.cdn_draws:
        with np.load(args.cdn_draws) as z:
            draws = {k: z[k] for k in ("flip", "label", "sign", "mag")}
    os.makedirs(args.out, exist_ok=True)
    trainer = Trainer(cfg, model_cfg, os.path.join(args.out, "run"), args.device,
                      mode=args.mode, seed=SEED)
    dev = trainer.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trainer.build(load_params_file(args.params, model_cfg))
    trainer.cdn_generator.manual_seed(SEED)
    model = trainer.state.model
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records = []
    for i in range(steps):
        batch = {k: v[i] for k, v in batches.items()}
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        arrays = to_device(rank_rows(batch), dev)
        if args.mode == "detection":
            noise = trainer.cdn_generator if draws is None else CdnDraws(
                *(torch.from_numpy(draws[k][i]).to(dev) for k in ("flip", "label", "sign", "mag")))
            trainer.state, metrics = trainer.step_fn(trainer.state, arrays, noise)
        else:
            trainer.state, metrics = trainer.step_fn(trainer.state, arrays)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        records.append({"ms": ms, "launches": dict(flash_mha.launches),
                        **{k: float(v) for k, v in metrics.items()}})
        if i == 0 and world.rank == 0:
            np.savez(os.path.join(args.out, "grads.npz"),
                     **{n: (p.grad if p.grad is not None else torch.zeros_like(p))
                        .detach().float().cpu().numpy() for n, p in model.named_parameters()})
    result = {"rank": world.rank, "world_size": world.world_size, "backend": world.backend,
              "device": str(dev), "lines_per_rank": len(arrays["images"]), "steps": records,
              "digests": state_digests(trainer),
              "allreduce_ms": allreduce_ms(trainer),
              "grad_bytes": 4 * sum(p.numel() for p in model.parameters()),
              "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)}
    with open(os.path.join(args.out, f"rank{world.rank}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    if args.save_state and world.rank == 0:
        state = {f"params/{n}": p.detach().float().cpu().numpy()
                 for n, p in model.named_parameters()}
        if trainer.state.ema is not None:
            state.update({f"ema/{n}": t.float().cpu().numpy()
                          for n, t in trainer.state.ema.items()})
        np.savez(os.path.join(args.out, "state.npz"), **state)
    mesh.barrier()
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
