#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dtlr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  device   the card, its power limit, TF32 off for matmuls and convolutions
  build    one nvcc per CUDA source (dtlr_tpu_torch/csrc/box_attn.cu and
           row_gather.cu), all started together, for sm_90a (ptxas report)
  kernels  both instantiations of the box-prior attention kernel against
           their plain PyTorch version on the card, at the decoder's shapes,
           in fp32 and bf16, and the row gather at the probe's shapes; times
           of each kernel, its plain version, one library call and the bound
  grad     gradients through the attention kernel's autograd Function
           (q, k, v and the prior's cx, cy, ihw, ihh, gamma) against the
           plain version's autograd gradients, at the decoder's shapes
  read     the flagship checkpoint (artifacts/r4ft_params.npz) reads the
           eight committed lines (dtlr_tpu_torch/assets/smoke_lines.npz)
           through the port's entry-point functions twice: in float32, held
           against the JAX package's float32 reading, and in the recipe's
           bfloat16, held against its bf16 reading (smoke_lines_bf16.npz);
           launch counts per forward and lines/s for each
  probe    the row-gather probe entry point (dtlr_tpu_torch.scripts.gather_probe)
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
LINES_BF16 = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines_bf16.npz")

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
# gradients through the kernel path recompute through the plain version:
# only the order of the prior's index-add backward (atomics) differs
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SOURCES = {"mha_box": "dtlr_tpu_torch/csrc/box_attn.cu",
           "mha": "dtlr_tpu_torch/csrc/box_attn.cu",
           "row_gather": "dtlr_tpu_torch/csrc/row_gather.cu"}
REPLACES = {"mha_box": "dtlr_tpu/ops/flash_attn.py:186",
            "mha": "dtlr_tpu/ops/flash_attn.py:174",
            "row_gather": "scripts/pallas_probe.py:22"}
# the probe's gather: val (S, C) float32, idx (Q,) int32
GATHER_S, GATHER_C, GATHER_Q = 1024, 64, 128
# agreement with the JAX package's float32 CPU reading of the lines: per
# query on the lines whose two-stage selection is JAX's, slot for slot; a
# selection that differs must come from a near tie of proposal scores
# (see dtlr_tpu_torch/eval/evaluate.py agreement)
MAX_LOGIT_TOL, BOX_TOL, SWAP_GAP_TOL, CER_VS_JAX = 5e-2, 5e-3, 1e-3, 0.01
# the bf16 reading: bf16 scores tie and near-tie often, so the two-stage
# selection moves most slots and the reading is held by its strings
# (tests/test_torch_smoke_fixture.py::test_port_reads_fixture_like_jax_bf16):
# CER against JAX's bf16 strings, CER against the ground truth at most
# this much above JAX's, and swaps only between scores at most four bf16
# steps (of 2^-4 at 8-16) apart
CER_VS_JAX_BF16, CER_GT_SLACK_BF16, SWAP_GAP_TOL_BF16 = 0.02, 0.01, 0.25


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


def gather_bound(val, idx):
    """Least time for the gather: the Q rows read once, the indices read
    once, the output written once; Q*C multiplies."""
    Qg, Cg = idx.numel(), val.shape[1]
    nbytes = Qg * Cg * 4 + idx.numel() * idx.element_size() + Qg * Cg * 4
    t_ops = Qg * Cg / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_gather(card):
    from dtlr_tpu_torch.ops import gather
    from dtlr_tpu_torch.ops.gather import row_gather, row_gather_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    val = torch.randn(GATHER_S, GATHER_C, generator=gen, device="cuda")
    idx = torch.randint(0, GATHER_S, (GATHER_Q,), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = row_gather(val, idx)
    torch.cuda.synchronize()
    err = float((out - row_gather_reference(val, idx)).abs().max())
    bound_ms, bound_by = gather_bound(val, idx)
    lib, stream = gather.load_library(), torch.cuda.current_stream().cuda_stream

    def launch_only():  # the kernel without the wrapper's checks (not counted)
        out = torch.empty_like(val[:GATHER_Q])
        lib.dtlr_row_gather(val.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            GATHER_S, GATHER_C, GATHER_Q, stream)

    row = {"name": "row_gather", "S": GATHER_S, "C": GATHER_C, "Q": GATHER_Q,
           "dtype": "float32", "max_abs_err": err, "tol": 0.0,
           "ms": cuda_ms(lambda: row_gather(val, idx)),
           # the wrapper checks the indices on the host (a device sync)
           "launch_only_ms": cuda_ms(launch_only),
           "plain_ms": cuda_ms(lambda: row_gather_reference(val, idx)),
           # the library yardstick: index_select and the multiply, two launches
           "library_ms": cuda_ms(lambda: torch.index_select(val, 0, idx) * 2),
           "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
    if err != 0.0:
        emit({"phase": "kernels", "failed": row})
        raise AssertionError(f"row_gather: max abs err {err}, the gather is exact")
    return row


def phase_grad(card):
    """Gradients through flash_mha's CUDA path (RecomputeGrad) against
    dense_reference's autograd gradients, at the decoder's shapes."""
    from dtlr_tpu_torch.ops.flash_attn import BoxPrior, dense_reference, flash_mha

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, S, dtype in [(n, S, dt) for n, S in (("mha_box", 2720), ("mha", 900))
                           for dt in (torch.float32, torch.bfloat16)]:
        prior = name == "mha_box"
        qh, kh, vh, key_bias, box = attention_inputs(S, dtype, prior, gen)
        if S == Q:
            key_bias = torch.zeros_like(key_bias)
        w = torch.randn(B, M, Q, D, generator=gen, device="cuda")

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
            fields = ([t.clone().requires_grad_(t.is_floating_point()) for t in box]
                      if prior else [])
            out = fn(*leaves, key_bias, BoxPrior(*fields) if prior else None)
            (out * w).sum().backward()
            return [t.grad for t in leaves + fields[:4] + fields[7:]]  # cx..ihh, gamma

        before = flash_mha.launches[name]
        got = grads(flash_mha)
        torch.cuda.synchronize()
        launched = flash_mha.launches[name] - before
        want = grads(dense_reference)
        names = ("q", "k", "v", "cx", "cy", "ihw", "ihh", "gamma")[:len(want)]
        errs = {n: float((g.float() - r.float()).abs().max()) / max(1.0, float(r.abs().max()))
                for n, g, r in zip(names, got, want)}
        row = {"name": name, "S": S, "dtype": str(dtype).split(".")[1], "launches": launched,
               "max_rel_err": errs, "tol": GRAD_TOL[dtype], "card": card}
        rows.append(row)
        if launched != 1 or not all(math.isfinite(e) and e <= GRAD_TOL[dtype]
                                    for e in errs.values()):
            emit({"phase": "grad", "failed": row})
            raise AssertionError(f"{name} S={S} {dtype}: kernel-path gradients disagree")
        del qh, kh, vh, box, got, want
        torch.cuda.empty_cache()
    return rows


def read_once(card, compute_dtype, ref_path):
    """One reading of the fixture lines at ``compute_dtype``: launches of
    each kernel in one forward, the reading's agreement with the JAX
    package's reading at the same dtype, and lines/s."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import (agreement, forward_lines, load_lines,
                                              load_model, read_lines)
    from dtlr_tpu_torch.ops.flash_attn import KERNELS, flash_mha, reset_launches

    t0 = time.perf_counter()
    model = load_model(PARAMS, device="cuda", compute_dtype=compute_dtype)
    lines = load_lines(LINES)
    ref = load_lines(ref_path)
    th, nms = (float(x) for x in lines["nms_point"])
    load_s = time.perf_counter() - t0
    n_dec = model.cfg.dec_layers

    reset_launches()
    res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    expect = {name: n_dec for name in KERNELS}
    if launches != expect:
        raise AssertionError(f"{compute_dtype}: kernel launches {launches} != {expect} "
                             "for one forward")

    agree = agreement(res, ref)
    cer = {k: metrics.mean_cer(res[k], lines["texts"]) for k in ("greedy", "nms")}
    record = {
        "phase": "read", "compute_dtype": compute_dtype,
        "params": os.path.relpath(PARAMS, REPO), "reference": os.path.relpath(ref_path, REPO),
        "lines": len(lines["texts"]), "launches_per_forward": launches, **agree,
        "greedy": res["greedy"], "jax_greedy": ref["jax_greedy"],
        "nms": res["nms"], "jax_nms": ref["jax_nms"], "TH": th, "NMS": nms,
        "CER_greedy": cer["greedy"], "CER_nms": cer["nms"],
        "WER_greedy": metrics.mean_wer(res["greedy"], lines["texts"]),
        "WER_nms": metrics.mean_wer(res["nms"], lines["texts"]),
        "jax_CER": {k: metrics.mean_cer(ref[f"jax_{k}"], lines["texts"])
                    for k in ("greedy", "nms")},
        "load_s": load_s,
    }
    finite = all(np.isfinite(res[k]).all() for k in ("pred_boxes", "max_logit"))
    if compute_dtype == "float32":
        record.update(box_tol=BOX_TOL, logit_tol=MAX_LOGIT_TOL, swap_gap_tol=SWAP_GAP_TOL)
        ok = (finite and agree["lines_compared"] >= 1
              and agree["max_pred_boxes_err"] <= BOX_TOL
              and agree["max_logit_err"] <= MAX_LOGIT_TOL
              and agree["max_swap_score_gap"] <= SWAP_GAP_TOL
              and max(agree["cer_vs_ref"].values()) <= CER_VS_JAX)
    else:
        record.update(cer_vs_jax_tol=CER_VS_JAX_BF16, cer_gt_slack=CER_GT_SLACK_BF16,
                      swap_gap_tol=SWAP_GAP_TOL_BF16)
        ok = (finite and max(agree["cer_vs_ref"].values()) <= CER_VS_JAX_BF16
              and agree["max_swap_score_gap"] <= SWAP_GAP_TOL_BF16
              and all(cer[k] <= record["jax_CER"][k] + CER_GT_SLACK_BF16 for k in cer))
    if not ok:
        emit(record)
        raise AssertionError(f"the port's {compute_dtype} reading disagrees with the "
                             "JAX package's")

    images, valid_hw = lines["images"], lines["valid_hw"]
    fwd_ms = cuda_ms(lambda: forward_lines(model, images, valid_hw), reps=10, warmup=2)
    record.update({"forward_ms_per_batch": fwd_ms, "batch": len(images),
                   "lines_per_s": len(images) / (fwd_ms / 1e3), "card": card})
    del model
    torch.cuda.empty_cache()
    return record, launches


def phase_probe():
    """The probe entry point, in this process: its return code and the
    gather's launches during it."""
    from dtlr_tpu_torch.ops.gather import reset_launches, row_gather
    from dtlr_tpu_torch.scripts import gather_probe

    reset_launches()
    rc = gather_probe.main([])
    torch.cuda.synchronize()
    launches = dict(row_gather.launches)
    if rc != 0 or launches["row_gather"] < 1:
        raise AssertionError(f"gather probe returned {rc} with launches {launches}")
    return rc, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # nothing is printed without the port
    from dtlr_tpu_torch.ops import _build, flash_attn, gather

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
    built = _build.build([flash_attn.SOURCE, gather.SOURCE])
    flash_attn.load_library()
    gather.load_library()
    emit({"phase": "build",
          "nvcc_seconds": {os.path.basename(b["source"]): b["seconds"] for b in built},
          "ptxas": [l for b in built for l in b["ptxas"].splitlines() if "registers" in l],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    rows = phase_kernels(card) + [phase_gather(card)]
    emit({"phase": "kernels", "rows": rows, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    grad_rows = phase_grad(card)
    emit({"phase": "grad", "rows": grad_rows, "seconds": time.perf_counter() - t0})

    launches = {}
    for compute_dtype, ref in (("float32", LINES), ("bfloat16", LINES_BF16)):
        t0 = time.perf_counter()
        record, launches[compute_dtype] = read_once(card, compute_dtype, ref)
        record["seconds"] = time.perf_counter() - t0
        emit(record)

    t0 = time.perf_counter()
    rc, probe_launches = phase_probe()
    emit({"phase": "probe", "rc": rc, "launches": probe_launches,
          "seconds": time.perf_counter() - t0})

    # each kernel at its main path's shape and dtype: the attention in the
    # recipe's bfloat16 reading, the gather in the probe
    main_shape = {"mha_box": (2720, "bfloat16"), "mha": (900, "bfloat16"),
                  "row_gather": (GATHER_S, "float32")}
    main_launches = {**launches["bfloat16"], **probe_launches}
    kernels = []
    for name in (*flash_attn.KERNELS, *gather.KERNELS):
        row = next(r for r in rows if (r["name"], r["S"], r["dtype"]) == (name, *main_shape[name]))
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": main_launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
