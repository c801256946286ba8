#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dtlr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  device   the card, its power limit, TF32 off for matmuls and convolutions
  build    nvcc of dtlr_tpu_torch/csrc/box_attn.cu for sm_90a (ptxas report)
  kernels  both instantiations of the box-prior attention kernel against
           their plain PyTorch version on the card, at the decoder's shapes,
           in fp32 and bf16; times of the kernel, the plain version, one
           scaled_dot_product_attention call, and the bound
  read     the flagship checkpoint (artifacts/r4ft_params.npz) reads the
           eight committed lines (dtlr_tpu_torch/assets/smoke_lines.npz)
           through the port's entry-point functions; launch counts, outputs
           and strings held against the JAX package's stored reading
Then the line {"kernels": [...]} for every ported kernel, the card's name
and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: exit code not 0.
Needs torch, numpy and the repository; no network and no JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
LINES = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and operations / peak rate
# for the inputs' type
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MEM_BYTES_PER_S = 3.35e12

# decoder geometry of the flagship: B lines of 8 heads x 32, 900 queries;
# keys of the 128x1024 eval bucket (S=2720) and of the 128x1344 bench
# bucket (S=3570)
B, M, Q, D = 8, 8, 900, 32
LEVELS = {2720: ((16, 128), (8, 64), (4, 32), (2, 16)),
          3570: ((16, 168), (8, 84), (4, 42), (2, 21))}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
KERNEL_SOURCE = "dtlr_tpu_torch/csrc/box_attn.cu"
REPLACES = {"mha_box": "dtlr_tpu/ops/flash_attn.py:186",
            "mha": "dtlr_tpu/ops/flash_attn.py:174"}
# agreement with the JAX package's float32 CPU reading of the lines: per
# query on the lines whose two-stage selection is JAX's, slot for slot; a
# selection that differs must come from a near tie of proposal scores
# (see dtlr_tpu_torch/eval/evaluate.py agreement)
MAX_LOGIT_TOL, BOX_TOL, SWAP_GAP_TOL, CER_VS_JAX = 5e-2, 5e-3, 1e-3, 0.01


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` single calls timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def attention_inputs(S, dtype, prior, gen):
    from dtlr_tpu_torch.ops.flash_attn import make_box_prior

    dev = "cuda"
    qh = torch.randn(B, M, Q, D, generator=gen, device=dev).to(dtype)
    kh = torch.randn(B, M, S, D, generator=gen, device=dev).to(dtype)
    vh = torch.randn(B, M, S, D, generator=gen, device=dev).to(dtype)
    pad = torch.rand(B, S, generator=gen, device=dev) < 0.2
    key_bias = torch.zeros(B, S, device=dev).masked_fill(pad, -1e9)
    box = None
    if prior:
        ref = 0.05 + 0.85 * torch.rand(B, Q, 4, 4, generator=gen, device=dev)
        gamma = torch.exp(0.3 * torch.randn(M, generator=gen, device=dev))
        box = make_box_prior(ref, LEVELS[S], gamma)
    return qh, kh, vh, key_bias, box


def bound(qh, kh, vh, key_bias, box):
    """Least time for the work: every input read once and the output
    written once, against the operations 2*B*M*Q*S*(2D + 8 with the prior)."""
    Bq, Mq, Qq, Dq = qh.shape
    S = kh.shape[2]
    flops = 2 * Bq * Mq * Qq * S * (2 * Dq + (8 if box is not None else 0))
    tensors = [qh, kh, vh, key_bias] + (list(box) if box is not None else [])
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + Bq * Mq * Qq * Dq * 4
    t_ops = flops / PEAK_FLOPS[qh.dtype]
    t_bytes = nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(qh, kh, vh, key_bias, box):
    """One scaled_dot_product_attention call with the additive bias
    materialized: the library yardstick, never used by the port."""
    from torch.nn.functional import scaled_dot_product_attention

    bias = key_bias[:, None, None, :].expand(-1, M, qh.shape[2], -1)
    if box is not None:
        lvl = box.level.long()
        dx = (box.px - box.cx[..., lvl]) * box.ihw[..., lvl]
        dy = (box.py - box.cy[..., lvl]) * box.ihh[..., lvl]
        bias = bias - (0.5 * box.gamma)[None, :, None, None] * (dx * dx + dy * dy)[:, None]
    bias = bias.to(qh.dtype).contiguous()
    return lambda: scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)


def phase_kernels(card):
    from dtlr_tpu_torch.ops.flash_attn import dense_reference, flash_mha

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the self-attention's shape (S = Q = 900, no padding) is where the
    # main path runs the no-prior kernel
    configs = [("mha_box", S, dt) for S in (2720, 3570)
               for dt in (torch.float32, torch.bfloat16)]
    configs += [("mha", S, dt) for S in (900, 2720, 3570)
                for dt in (torch.float32, torch.bfloat16)]
    rows = []
    for name, S, dtype in configs:
        prior = name == "mha_box"
        args = attention_inputs(S, dtype, prior, gen)
        if S == Q:  # the self-attention pads no key
            args = args[:3] + (torch.zeros_like(args[3]), None)
        out = flash_mha(*args)
        torch.cuda.synchronize()
        ref = dense_reference(*args)
        err = float((out - ref).abs().max())
        ok = math.isfinite(err) and err <= TOL[dtype]
        bound_ms, bound_by = bound(*args)
        row = {"name": name, "S": S, "dtype": str(dtype).split(".")[1],
               "max_abs_err": err, "tol": TOL[dtype],
               "ms": cuda_ms(lambda: flash_mha(*args)),
               "plain_ms": cuda_ms(lambda: dense_reference(*args)),
               "library_ms": cuda_ms(sdpa_call(*args)),
               "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
        rows.append(row)
        if not ok:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"{name} S={S} {dtype}: max abs err {err} > {TOL[dtype]}")
        del args, out, ref
        torch.cuda.empty_cache()
    return rows


def phase_read(card):
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import (agreement, forward_lines, load_lines,
                                              load_model, read_lines)
    from dtlr_tpu_torch.ops.flash_attn import KERNELS, flash_mha, reset_launches

    t0 = time.perf_counter()
    model = load_model(PARAMS, device="cuda")
    lines = load_lines(LINES)
    th, nms = (float(x) for x in lines["nms_point"])
    load_s = time.perf_counter() - t0
    n_dec = model.cfg.dec_layers

    reset_launches()
    res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    expect = {name: n_dec for name in KERNELS}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect} for one forward")

    agree = agreement(res, lines)
    record = {
        "phase": "read", "params": os.path.relpath(PARAMS, REPO), "lines": len(lines["texts"]),
        "launches_per_forward": launches, **agree,
        "box_tol": BOX_TOL, "logit_tol": MAX_LOGIT_TOL, "swap_gap_tol": SWAP_GAP_TOL,
        "greedy": res["greedy"], "jax_greedy": lines["jax_greedy"],
        "nms": res["nms"], "jax_nms": lines["jax_nms"], "TH": th, "NMS": nms,
        "CER_greedy": metrics.mean_cer(res["greedy"], lines["texts"]),
        "WER_greedy": metrics.mean_wer(res["greedy"], lines["texts"]),
        "CER_nms": metrics.mean_cer(res["nms"], lines["texts"]),
        "WER_nms": metrics.mean_wer(res["nms"], lines["texts"]),
        "load_s": load_s,
    }
    finite = all(np.isfinite(res[k]).all() for k in ("pred_boxes", "max_logit"))
    ok = (finite and agree["lines_compared"] >= 1
          and agree["max_pred_boxes_err"] <= BOX_TOL
          and agree["max_logit_err"] <= MAX_LOGIT_TOL
          and agree["max_swap_score_gap"] <= SWAP_GAP_TOL
          and max(agree["cer_vs_ref"].values()) <= CER_VS_JAX)
    if not ok:
        emit(record)
        raise AssertionError("the port's reading disagrees with the JAX package's")

    images, valid_hw = lines["images"], lines["valid_hw"]
    fwd_ms = cuda_ms(lambda: forward_lines(model, images, valid_hw), reps=10, warmup=2)
    record.update({"forward_ms_per_batch": fwd_ms, "batch": len(images),
                   "lines_per_s": len(images) / (fwd_ms / 1e3), "card": card})
    return record, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dtlr_tpu_torch.ops import flash_attn  # nothing is printed without the port

    t0 = time.perf_counter()
    card = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": False, "tf32_cudnn": False,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    built = flash_attn.build_library()
    flash_attn.load_library()
    emit({"phase": "build", "nvcc_seconds": built["seconds"],
          "ptxas": [l for l in built["ptxas"].splitlines() if "registers" in l],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    rows = phase_kernels(card)
    emit({"phase": "kernels", "rows": rows, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    record, launches = phase_read(card)
    record["seconds"] = time.perf_counter() - t0
    emit(record)

    main_shape = {"mha_box": (2720, "float32"), "mha": (900, "float32")}
    kernels = []
    for name in flash_attn.KERNELS:
        row = next(r for r in rows if (r["name"], r["S"], r["dtype"]) == (name, *main_shape[name]))
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name], "launches": launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
