"""Where the flagship forward's device time goes, on one GPU.

    python -m dtlr_tpu_torch.eval.profile_forward \
        [--params artifacts/r4ft_params.npz] \
        [--lines dtlr_tpu_torch/assets/smoke_lines.npz] \
        [--compute_dtype bfloat16|float32]

Runs the port's forward over the lines (one batch, in the recipe's
bfloat16 unless told otherwise, TF32 off for float32 matmuls)
under torch.profiler and prints one JSON line: the forward's time from
CUDA events, the device-busy share (kernel time over that time), and per
forward the device time of the top operators (self time) and kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.dino import FLAGSHIP
from .evaluate import forward_lines, load_lines, load_model

REPS, TOP = 3, 15


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("profile the port's forward")
    p.add_argument("--params", default="artifacts/r4ft_params.npz")
    p.add_argument("--lines", default="dtlr_tpu_torch/assets/smoke_lines.npz")
    p.add_argument("--compute_dtype", default=FLAGSHIP.compute_dtype,
                   choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model(args.params, device="cuda", compute_dtype=args.compute_dtype)
    lines = load_lines(args.lines)
    images, valid_hw = lines["images"], lines["valid_hw"]

    def run():
        forward_lines(model, images, valid_hw)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / REPS

    events = prof.key_averages()
    per = lambda us: us / 1e3 / REPS  # microseconds in total -> ms per forward
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    ops = [e for e in events if e.device_type.name == "CPU" and e.self_device_time_total > 0]
    busy_ms = per(sum(e.device_time_total for e in kernels))
    top = lambda evs, attr: [
        {"name": e.key[:90], "ms": per(getattr(e, attr)), "calls": e.count / REPS}
        for e in sorted(evs, key=lambda e: -getattr(e, attr))[:TOP]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    rec = {"compute_dtype": args.compute_dtype,
           "forward_ms": wall_ms, "batch": len(images), "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "box_attn_ms": per(sum(e.device_time_total for e in kernels
                                  if "box_attn" in e.key)),
           "top_ops": top(ops, "self_device_time_total"),
           "top_kernels": top(kernels, "device_time_total"), "card": card}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
