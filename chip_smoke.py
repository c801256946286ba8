#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dtlr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  device   the card, its power limit, TF32 off for matmuls and convolutions
  build    one nvcc per CUDA source (dtlr_tpu_torch/csrc/box_attn.cu and
           row_gather.cu), all started together, for sm_90a (ptxas report:
           registers, shared memory, spills), and the count of tensor-core
           instructions (HMMA, HGMMA) in each attention kernel's SASS
  kernels  the instantiations of the box-prior attention kernel against
           their plain PyTorch version on the card, at the decoder's shapes,
           in fp32 and bf16, on contiguous heads and on strided views built
           as the decoder builds them, the detection step's shapes (1028
           queries; the masked self-attention at Q = S = 1028 with the CDN
           group mask, whose matching rows find two key tiles blocked
           whole, against SDPA with the boolean mask), a fully masked row (uniform and
           finite), and the row gather at the probe's shapes (an index out
           of range trips its device-side assert, checked in a child
           process); times of each kernel, its plain version and one
           library call (``ms``: events around 20 back-to-back calls, which
           the host's per-call work bounds where it exceeds the card's;
           ``graph_ms``: the same calls replayed from a CUDA graph, the card
           alone) and the bound
  grad     gradients through the attention kernel's autograd Function
           (q, k, v and the prior's cx, cy, ihw, ihh, gamma) against the
           plain version's autograd gradients, at the decoder's shapes
  read     the flagship checkpoint (artifacts/r4ft_params.npz) reads the
           eight committed lines (dtlr_tpu_torch/assets/smoke_lines.npz)
           through the port's entry-point functions twice: in float32, held
           against the JAX package's float32 reading, and in the recipe's
           bfloat16, held against its bf16 reading (smoke_lines_bf16.npz);
           launch counts per forward and lines/s for each
  train    CTC finetuning with the recipe's trainer (dtlr_tpu_torch.train.engine,
           full-model optimizer) from the flagship checkpoint on the eight
           lines: the first step in float32 and in bfloat16 against the JAX
           package's first step (dtlr_tpu_torch/assets/smoke_train.npz: the
           loss and gradient norms, per line and for the batch), 6 launches
           of each attention instantiation and 12 recomputing backwards per
           step, ca_box_gamma's gradient in every decoder layer; then in
           bfloat16 2 warm-up and 10 timed steps (finite losses, none
           skipped, the weights move), ms per step, lines/s, peak memory,
           the step split into forward, backward and update, one profiled
           step's top operators; and the trained weights through an npz
           into a fresh model that reads the lines to the same strings
  detect   the detection training step with contrastive denoising, the
           matcher and the DINO loss (dtlr_tpu_torch.train.engine in
           detection mode) from the pretraining trunk
           (artifacts/r4run_params.npz) on the eight lines with character
           boxes of dtlr_tpu_torch/assets/smoke_detect.npz: the first step
           in float32 and bfloat16 with the CDN noise at zero against the
           JAX package's first step (smoke_detect_ref.npz: the loss, every
           term, the gradient norms, and the seven matchings per line,
           a differing one with its cost gap), 6 launches of the
           cross-attention and 6 of the masked self-attention and 12
           recomputing backwards per step; then 2 warm-up and 10 timed
           bf16 steps of the recipe with its noise (finite, none skipped,
           ms per step, lines/s, peak memory, the split into forward,
           matching, loss, backward and update, the matcher's rounds and
           host reads, one profiled step), and two steps of the entry
           point python -m dtlr_tpu_torch.train.pretrain
  probe    the row-gather probe entry point (dtlr_tpu_torch.scripts.gather_probe)
Then the line {"kernels": [...]} for every ported kernel, the card's name
and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: exit code not 0.
Needs torch, numpy and the repository; no network and no JAX.
"""

import dataclasses
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
# the attention's per-score floor at D=32: besides its two products each
# score costs fp32 instructions on the CUDA cores (scale and bias, the
# prior's five, max, exponent argument, row sum: 9 with the prior, 4
# without) at 128 lanes x 132 SMs x 1.98 GHz, and one ex2 on the SFUs at
# 16 per SM per clock; the floor is the larger of the two (published
# rates, no measurement)
LANE_OPS_PER_S = 128 * 132 * 1.98e9
SFU_PER_S = 16 * 132 * 1.98e9
OPS_PER_SCORE = {True: 9, False: 4}

# decoder geometry of the flagship: B lines of 8 heads x 32, 900 queries;
# keys of the 128x1024 eval bucket (S=2720) and of the 128x1344 bench
# bucket (S=3570)
B, M, Q, D = 8, 8, 900, 32
# the detection step's CDN: dn_number 100 over 64 target slots is one group
# of 2 x 64 denoising queries before the 900, so the decoder runs 1028
DN_NUMBER, MAX_TARGETS = 100, 64
Q_DETECT = Q + 2 * MAX_TARGETS
LEVELS = {2720: ((16, 128), (8, 64), (4, 32), (2, 16)),
          3570: ((16, 168), (8, 84), (4, 42), (2, 21))}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# gradients through the kernel path recompute through the plain version:
# only the order of the prior's index-add backward (atomics) differs
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SOURCES = {"mha_box": "dtlr_tpu_torch/csrc/box_attn.cu",
           "mha": "dtlr_tpu_torch/csrc/box_attn.cu",
           "mha_masked": "dtlr_tpu_torch/csrc/box_attn.cu",
           "row_gather": "dtlr_tpu_torch/csrc/row_gather.cu"}
REPLACES = {"mha_box": "dtlr_tpu/ops/flash_attn.py:186",
            "mha": "dtlr_tpu/ops/flash_attn.py:174",
            "row_gather": "scripts/pallas_probe.py:22"}
# the probe's gather: val (S, C) float32, idx (Q,) int32
GATHER_S, GATHER_C, GATHER_Q = 1024, 64, 128
# the train phase: JAX's first CTC step on the fixture lines (written on the
# CPU by tests/test_torch_smoke_train.py), the leaves whose gradient norms
# are compared (JAX name: port name), and the steps timed after warm-up
SMOKE_TRAIN = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_train.npz")
TRAIN_LEAVES = {"params/class_embed/fc/kernel": "class_embed.fc.weight",
                "params/transformer/decoder_layer_0/ca_box_gamma":
                    "transformer.decoder_layer_0.ca_box_gamma",
                "params/backbone_net/conv1/kernel": "backbone_net.conv1.weight"}
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# float32, relative: the batch's loss within 1e-3 and its gradient's global
# norm within 1e-2; the named leaves' norms within 3e-2, since near-tied
# proposals swap a few slots on some lines (the read phase's fp32 swaps) and
# a swapped line's gradient moves with its selection (the first chip runs
# of the phase measured 1.6e-2 on a swapped line's ca_box_gamma, 1.0e-2 on
# the batch's). Per line alone, on every line whose selection is JAX's
# slot for slot, the gradient norms within 1e-2 and the loss within 3e-3:
# at about 0.013 per line a float32 CTC over 1800 frames rounds to about
# 2e-5, 2e-3 of a three-character line's loss (measured 1.8e-3 on one).
TRAIN_TOL_FP32 = {"line_loss": 3e-3, "line_grad": 1e-2, "loss": 1e-3, "grad_norm": 1e-2,
                  "leaf": 3e-2}
# bfloat16: two bf16 computations round at different places and bf16
# proposal scores tie, so the port's bf16 step and JAX's differ by about
# as much as each differs from float32; each quantity is held within
# BF16_SPREAD times JAX's own float32-to-bfloat16 difference of it, and
# never tighter than BF16_FLOOR relative (the bound of the bf16 step at
# the tiny geometry, tests/test_torch_train_step.py). Set after the first
# chip run of the phase, which measured the port's bf16 gradient norm of
# class_embed 3.6e-2 from JAX's, where JAX's own spread is 0.8e-2.
BF16_SPREAD, BF16_FLOOR = 4.0, 5e-2
# the detect phase: JAX's first detection step (tests/test_torch_smoke_detect.py)
# on the detection fixture's eight lines with the pretraining trunk, and the
# leaves whose gradient norms are compared (JAX name: port name)
DETECT_PARAMS = os.path.join(REPO, "artifacts", "r4run_params.npz")
DETECT_LINES = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_detect.npz")
DETECT_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_detect_ref.npz")
DETECT_LEAVES = {"params/label_enc": "label_enc",
                 "params/class_embed/fc/kernel": "class_embed.fc.weight",
                 "params/backbone_net/conv1/kernel": "backbone_net.conv1.weight",
                 "params/transformer/decoder_layer_0/ca_box_gamma":
                     "transformer.decoder_layer_0.ca_box_gamma",
                 "params/transformer/decoder_layer_0/self_attn/q_proj/kernel":
                     "transformer.decoder_layer_0.self_attn.q_proj.weight"}
# float32, relative: the gradient's global norm 1e-2 and the leaves' norms
# 3e-2, as the train phase holds CTC (TRAIN_TOL_FP32); each loss term 1e-2,
# since a near tie can move a target of a line to another query; the
# batch's loss 3e-3. Near-tied proposals swap slots of the two-stage
# selection on some lines (the read phase's fp32 swaps), and a swapped
# line's loss moves with its selection: on an H100 (700 W) the batch's loss
# measured 1.94e-3 from JAX's (its DN class terms 8e-3) with every matching
# equal to JAX's, one line with 4 swapped slots carrying it. Each line alone
# is held tighter where its selection is JAX's (DETECT_LINE_TOL_FP32).
DETECT_TOL_FP32 = {"loss": 3e-3, "grad_norm": 1e-2, "leaf": 3e-2, "term": 1e-2}
# each line alone, on the lines whose two-stage selection is JAX's slot for
# slot (anchors within ANCHOR_TOL): the loss and its DN class term 1e-3,
# the gradient norms as the batch's
DETECT_LINE_TOL_FP32 = {"loss": 1e-3, "loss_ce_dn": 1e-3, "grad_norm": 1e-2, "leaf": 3e-2}
ANCHOR_TOL = 1e-6
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


def cuda_ms(fn, calls=20, runs=5, warmup=3):
    """Milliseconds per call: one CUDA event pair around ``calls``
    back-to-back calls, divided by ``calls``; the median of ``runs`` such
    timings after ``warmup`` calls. Back to back, the host's work for one
    call (checks, allocation, the launch itself) overlaps the device's
    work for the one before, as it does on the forward path; around a
    single call the device would wait for all of it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(fn, calls=20, runs=5):
    """The card's milliseconds per call alone: ``calls`` calls captured in
    one CUDA graph, replayed between one event pair, median of ``runs``
    replays. The host's per-call work runs once, at capture; what is left
    is the device's time and the graph's launch gaps. Where that work
    exceeds the device's, ``cuda_ms`` reads the host and this the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def host_us(fn, calls=200, runs=3):
    """Host microseconds per call: ``calls`` calls enqueued without a sync,
    timed on the host clock, median of ``runs``. Where this exceeds the
    card's time per call, back-to-back event timing reads it."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def attention_inputs(S, dtype, prior, gen, strided=False, nq=Q):
    """Heads (B, M, L, D) of ``nq`` queries and S keys, contiguous or, with
    ``strided``, as the decoder builds them: (B, L, M*D) projections viewed
    as (B, L, M, D) and transposed, so rows are M*D elements apart and
    heads D."""
    from dtlr_tpu_torch.ops.flash_attn import make_box_prior

    dev = "cuda"
    if strided:
        heads = lambda n: (torch.randn(B, n, M * D, generator=gen, device=dev).to(dtype)
                           .view(B, n, M, D).transpose(1, 2))
    else:
        heads = lambda n: torch.randn(B, M, n, D, generator=gen, device=dev).to(dtype)
    qh, kh, vh = heads(nq), heads(S), heads(S)
    pad = torch.rand(B, S, generator=gen, device=dev) < 0.2
    key_bias = torch.zeros(B, S, device=dev).masked_fill(pad, -1e9)
    box = None
    if prior:
        ref = 0.05 + 0.85 * torch.rand(B, nq, 4, 4, generator=gen, device=dev)
        gamma = torch.exp(0.3 * torch.randn(M, generator=gen, device=dev))
        box = make_box_prior(ref, LEVELS[S], gamma)
    return qh, kh, vh, key_bias, box


def open_pairs(qh, kh, group=None):
    """The (query, key) pairs the attention computes: Q*S, or under the
    CDN group mask the pairs it does not block (this run's layout)."""
    if group is None:
        return qh.shape[2] * kh.shape[2]
    from dtlr_tpu_torch.ops.flash_attn import group_blocked

    return int((~group_blocked(group)).sum())


def bound(qh, kh, vh, key_bias, box, group=None):
    """Least time for the work: every input read once and the output
    written once, against the operations 2*B*M*(open pairs)*(2D + 8 with
    the prior); a pair the mask blocks needs no work."""
    Bq, Mq, Qq, Dq = qh.shape
    flops = 2 * Bq * Mq * open_pairs(qh, kh, group) * (2 * Dq + (8 if box is not None else 0))
    tensors = ([qh, kh, vh, key_bias] + (list(box) if box is not None else [])
               + ([group] if group is not None else []))
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + Bq * Mq * Qq * Dq * 4
    t_ops = flops / PEAK_FLOPS[qh.dtype]
    t_bytes = nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def score_floor(qh, kh, box, group=None):
    """Least time for the per-score work outside the products (see
    OPS_PER_SCORE): the CUDA cores' share against the SFUs' share."""
    scores = qh.shape[0] * qh.shape[1] * open_pairs(qh, kh, group)
    return 1e3 * max(scores * OPS_PER_SCORE[box is not None] / LANE_OPS_PER_S,
                     scores / SFU_PER_S)


def sdpa_call(qh, kh, vh, key_bias, box, group=None):
    """One scaled_dot_product_attention call with the additive bias
    materialized, or under the CDN mask with the (Q, Q) boolean mask: the
    library yardstick, never used by the port."""
    from torch.nn.functional import scaled_dot_product_attention

    if group is not None:
        from dtlr_tpu_torch.ops.flash_attn import group_blocked

        allowed = ~group_blocked(group)
        return lambda: scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed)
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
    # main path runs the no-prior kernel; S = 3570's levels start at keys
    # 0, 2688, 3360 and 3528, so two of its 64-key tiles mix levels; the
    # strided rows take the decoder's projection views (its layout)
    # strided; the detection step's shapes: the cross-attention at 1028
    # queries and the masked self-attention at Q = S = 1028 with the
    # fixture's CDN layout, whose 900 matching rows find the first two key
    # tiles (the denoising prefix) blocked whole
    configs = [("mha_box", S, Q, dt, False) for S in (2720, 3570)
               for dt in (torch.float32, torch.bfloat16)]
    configs += [("mha", S, Q, dt, False) for S in (900, 2720, 3570)
                for dt in (torch.float32, torch.bfloat16)]
    configs += [(name, S, Q, dt, True) for name, S in (("mha_box", 2720), ("mha", 900))
                for dt in (torch.float32, torch.bfloat16)]
    configs += [("mha_box", 2720, Q_DETECT, torch.bfloat16, True)]
    configs += [("mha_masked", Q_DETECT, Q_DETECT, dt, True)
                for dt in (torch.float32, torch.bfloat16)]
    rows = []
    for name, S, nq, dtype, strided in configs:
        prior = name == "mha_box"
        args = attention_inputs(S, dtype, prior, gen, strided, nq)
        if S == nq:  # the self-attention pads no key
            args = args[:3] + (torch.zeros_like(args[3]), None)
        if name == "mha_masked":
            args = args + (detect_groups(),)
        out = flash_mha(*args)
        torch.cuda.synchronize()
        ref = dense_reference(*args)
        err = float((out - ref).abs().max())
        ok = math.isfinite(err) and err <= TOL[dtype]
        bound_ms, bound_by = bound(*args)
        row = {"name": name, "S": S, "Q": nq, "dtype": str(dtype).split(".")[1],
               "layout": "strided" if strided else "contiguous",
               "max_abs_err": err, "tol": TOL[dtype],
               "ms": cuda_ms(lambda: flash_mha(*args)),
               "plain_ms": cuda_ms(lambda: dense_reference(*args)),
               "library_ms": cuda_ms(sdpa_call(*args)),
               "graph_ms": graph_ms(lambda: flash_mha(*args)),
               "host_us": host_us(lambda: flash_mha(*args)),
               "plain_graph_ms": graph_ms(lambda: dense_reference(*args)),
               "library_graph_ms": graph_ms(sdpa_call(*args)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "score_floor_ms": score_floor(args[0], args[1], args[4], *args[5:]),
               "card": card}
        if name == "mha_masked":
            row["blocks_with_whole_tiles_blocked"] = whole_tiles_blocked(args[5])
        rows.append(row)
        if not ok:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"{name} S={S} {dtype}: max abs err {err} > {TOL[dtype]}")
        del args, out, ref
        torch.cuda.empty_cache()
    return rows


def detect_groups():
    """The (Q_DETECT,) CDN groups of the detection step: one group of 2 x 64
    denoising queries, then the 900 matching queries."""
    from dtlr_tpu_torch.models.cdn import CdnMeta, cdn_num_groups, cdn_query_groups

    G = cdn_num_groups(DN_NUMBER, MAX_TARGETS)
    return cdn_query_groups(Q, CdnMeta(G * 2 * MAX_TARGETS, G, MAX_TARGETS), "cuda")


def whole_tiles_blocked(group, rows=128, keys=64):
    """(128-query block, 64-key tile) pairs of the bf16 kernel in which
    every score is blocked, and the pairs in all."""
    from dtlr_tpu_torch.ops.flash_attn import group_blocked

    blocked = group_blocked(group)
    n = blocked.shape[0]
    nr, nk = -(-n // rows), -(-n // keys)
    pad = torch.ones(nr * rows, nk * keys, dtype=torch.bool, device=blocked.device)
    pad[:n, :n] = blocked
    whole = pad.view(nr, rows, nk, keys).all(3).all(1)
    return {"whole": int(whole.sum()), "pairs": nr * nk}


def masked_rows():
    """Every key of line 0 carries -1e9: its softmax is uniform, so each of
    its outputs is the mean of the values, finite, in both
    instantiations and dtypes (the prior with gamma 0, which keeps it
    uniform), at S = 2720 on the decoder's strided views."""
    from dtlr_tpu_torch.ops.flash_attn import dense_reference, flash_mha

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, dtype in [(n, dt) for n in ("mha_box", "mha")
                        for dt in (torch.float32, torch.bfloat16)]:
        qh, kh, vh, key_bias, box = attention_inputs(2720, dtype, name == "mha_box", gen,
                                                     strided=True)
        key_bias[0] = -1e9
        if box is not None:
            box = box._replace(gamma=torch.zeros_like(box.gamma))
        out = flash_mha(qh, kh, vh, key_bias, box)
        torch.cuda.synchronize()
        mean = vh[0].float().mean(1, keepdim=True).expand(M, Q, D)
        row = {"name": name, "dtype": str(dtype).split(".")[1], "S": 2720,
               "finite": bool(torch.isfinite(out).all()),
               "uniform_err": float((out[0] - mean).abs().max()),
               "max_abs_err": float((out - dense_reference(qh, kh, vh, key_bias, box))
                                    .abs().max()),
               "tol": TOL[dtype]}
        rows.append(row)
        if not (row["finite"] and row["uniform_err"] <= TOL[dtype]
                and row["max_abs_err"] <= TOL[dtype]):
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"{name} {dtype}: a fully masked row is not uniform")
        del qh, kh, vh, out
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
    lib = gather.load_library()

    def launch_only():  # the kernel without the wrapper's checks (not counted)
        out = torch.empty_like(val[:GATHER_Q])
        lib.dtlr_row_gather(val.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            GATHER_S, GATHER_C, GATHER_Q, torch.cuda.current_stream().cuda_stream)

    row = {"name": "row_gather", "S": GATHER_S, "C": GATHER_C, "Q": GATHER_Q,
           "dtype": "float32", "max_abs_err": err, "tol": 0.0,
           # the wrapper: its index check is the kernel's device-side assert,
           # so it never waits for the card and a CUDA graph captures it
           "ms": cuda_ms(lambda: row_gather(val, idx)),
           "graph_ms": graph_ms(lambda: row_gather(val, idx)),
           "host_us": host_us(lambda: row_gather(val, idx)),
           "launch_only_ms": cuda_ms(launch_only),
           "launch_only_graph_ms": graph_ms(launch_only),
           "plain_ms": cuda_ms(lambda: row_gather_reference(val, idx)),
           "plain_graph_ms": graph_ms(lambda: row_gather_reference(val, idx)),
           # the library yardstick: index_select and the multiply, two launches
           "library_ms": cuda_ms(lambda: torch.index_select(val, 0, idx) * 2),
           "library_graph_ms": graph_ms(lambda: torch.index_select(val, 0, idx) * 2),
           "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
    row["out_of_range"] = gather_out_of_range()
    if err != 0.0 or not row["out_of_range"]["refused"]:
        emit({"phase": "kernels", "failed": row})
        raise AssertionError(f"row_gather: max abs err {err} (the gather is exact), "
                             f"out of range {row['out_of_range']}")
    return row


def gather_out_of_range():
    """An index outside [0, S) trips the kernel's device-side assert: in a
    child process (the assert leaves the CUDA context unusable), the call
    returns without waiting and the synchronize after it raises."""
    code = ("import sys, torch; sys.path.insert(0, %r)\n"
            "from dtlr_tpu_torch.ops import gather\n"
            "val = torch.zeros(16, 4, device='cuda')\n"
            "gather.row_gather(val, torch.tensor([3, 16], dtype=torch.int32, device='cuda'))\n"
            "print('returned', flush=True)\n"
            "torch.cuda.synchronize()\n"
            "print('synchronized', flush=True)\n") % REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    return {"rc": proc.returncode, "returned": "returned" in proc.stdout,
            "refused": (proc.returncode != 0 and "returned" in proc.stdout
                        and "synchronized" not in proc.stdout
                        and "device-side assert" in out)}


def phase_grad(card):
    """Gradients through flash_mha's CUDA path (RecomputeGrad) against
    dense_reference's autograd gradients, at the decoder's shapes."""
    from dtlr_tpu_torch.ops.flash_attn import BoxPrior, dense_reference, flash_mha

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, S, dtype in [(n, S, dt) for n, S in (("mha_box", 2720), ("mha", 900),
                                                   ("mha_masked", Q_DETECT))
                           for dt in (torch.float32, torch.bfloat16)]:
        prior = name == "mha_box"
        nq = Q_DETECT if name == "mha_masked" else Q
        qh, kh, vh, key_bias, box = attention_inputs(S, dtype, prior, gen, nq=nq)
        if S == nq:
            key_bias = torch.zeros_like(key_bias)
        group = (detect_groups(),) if name == "mha_masked" else ()
        w = torch.randn(B, M, nq, D, generator=gen, device="cuda")

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
            fields = ([t.clone().requires_grad_(t.is_floating_point()) for t in box]
                      if prior else [])
            out = fn(*leaves, key_bias, BoxPrior(*fields) if prior else None, *group)
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
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

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
    expect = {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0}
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
    fwd_ms = cuda_ms(lambda: forward_lines(model, images, valid_hw), calls=1, runs=10,
                     warmup=2)
    record.update({"forward_ms_per_batch": fwd_ms, "batch": len(images),
                   "lines_per_s": len(images) / (fwd_ms / 1e3), "card": card})
    del model
    torch.cuda.empty_cache()
    return record, launches


def train_reference():
    """JAX's first step on the fixture lines (smoke_train.npz): per dtype
    the loss (of JAX's outputs, the CTC in float64: see
    tests/test_torch_smoke_train.py), the gradient's global norm and
    TRAIN_LEAVES' norms."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    ref = load_lines(SMOKE_TRAIN)
    return ref, {dt: {"loss": float(ref[f"loss_f64_{dt}"]),
                      "grad_norm": float(ref[f"grad_norm_{dt}"]),
                      **{leaf: float(v) for leaf, v in zip(ref["leaves"],
                                                           ref[f"leaf_grad_norm_{dt}"])}}
                 for dt in ("float32", "bfloat16")}


def train_tolerances(jax_ref):
    """Relative tolerance per quantity and dtype (see TRAIN_TOL_FP32 and
    BF16_SPREAD)."""
    tol = {"float32": {k: TRAIN_TOL_FP32[k if k in ("loss", "grad_norm") else "leaf"]
                       for k in jax_ref["float32"]}}
    tol["bfloat16"] = {k: max(BF16_FLOOR, BF16_SPREAD * abs(jax_ref["bfloat16"][k] - v) / abs(v))
                       for k, v in jax_ref["float32"].items()}
    return tol


def first_step(card, compute_dtype, lines, ref, jax_ref, tol, workdir):
    """The recipe's trainer (full-model optimizer) from the flagship
    checkpoint, one step on the eight lines: its loss and gradient norms
    against JAX's first step, its launches, and the gradient of every
    decoder layer's ca_box_gamma. Returns the record and the trainer."""
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.ops.flash_attn import RecomputeGrad, flash_mha, reset_launches
    from dtlr_tpu_torch.train.checkpoints import load_params_npz
    from dtlr_tpu_torch.train.config import RECIPE
    from dtlr_tpu_torch.train.engine import Trainer, collate

    t0 = time.perf_counter()
    trainer = Trainer(RECIPE, dataclasses.replace(FLAGSHIP, compute_dtype=compute_dtype),
                      os.path.join(workdir, compute_dtype), device="cuda")
    trainer.build(load_params_npz(PARAMS), head_only=False)
    batch = collate(lines, range(len(lines["texts"])), lines["charset"], RECIPE.max_targets)
    if not (np.array_equal(batch["labels"], ref["labels"])
            and np.array_equal(batch["valid"], ref["valid"])):
        raise AssertionError("the fixture's labels are not those of smoke_train.npz")
    build_s = time.perf_counter() - t0
    per_line = line_steps(trainer, batch, lines, ref, compute_dtype)
    reset_launches()
    m = trainer.step(batch)
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    backwards = RecomputeGrad.backwards
    model = trainer.state.model
    params = dict(model.named_parameters())
    got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           **{leaf: float(params[name].grad.float().norm()) for leaf, name in TRAIN_LEAVES.items()}}
    rel = {k: abs(got[k] - jax_ref[compute_dtype][k]) / abs(jax_ref[compute_dtype][k])
           for k in got}
    gammas = [params[f"transformer.decoder_layer_{i}.ca_box_gamma"].grad
              for i in range(model.cfg.dec_layers)]
    gamma_ok = all(g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                   for g in gammas)
    n_dec = model.cfg.dec_layers
    record = {"phase": "train", "step": 0, "compute_dtype": compute_dtype,
              "params": os.path.relpath(PARAMS, REPO), "lines": len(lines["texts"]),
              "port": got, "jax": jax_ref[compute_dtype], "rel_err": rel,
              "tol": tol[compute_dtype], "per_line": per_line, "skipped": float(m["skipped"]),
              "launches_per_step": launches, "recompute_backwards_per_step": backwards,
              "ca_box_gamma_grad_abs_max": [float(g.abs().max()) for g in gammas],
              "build_s": build_s, "card": card}
    record["ok"] = (all(rel[k] <= tol[compute_dtype][k] for k in rel)
                    and record["skipped"] == 0.0 and per_line["ok"]
                    and launches == {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0}
                    and backwards == 2 * n_dec and gamma_ok)
    return record, trainer, batch


def line_steps(trainer, batch, lines, ref, compute_dtype):
    """Each line's loss and gradient norms alone (B=1, the batch's frame),
    before the first update, against JAX's per-line values. In float32
    the lines whose two-stage selection is JAX's (the fixture's
    ``jax_anchors``, slot for slot) are held to TRAIN_TOL_FP32; a line
    whose selection differs is reported with its count of swapped slots.
    In bfloat16 every line is reported."""
    from dtlr_tpu_torch.ops.ctc import ctc_loss
    from dtlr_tpu_torch.ops.pixels import prep_images

    model = trainer.state.model
    model.train()
    dev = trainer.device
    dt = compute_dtype
    rows, ok = [], True
    for i in range(len(lines["texts"])):
        for p in model.parameters():
            p.grad = None
        b = {k: torch.from_numpy(np.asarray(batch[k][i:i + 1])).to(dev)
             for k in ("images", "valid_hw", "labels", "valid")}
        out = model(prep_images(b["images"], b["valid_hw"]), b["valid_hw"])
        loss, _ = ctc_loss(out["pred_logits"], out["pred_boxes"], b["labels"], b["valid"],
                           eps=trainer.cfg.ctc_eps)
        loss.backward()
        params = dict(model.named_parameters())
        grads = [p.grad for p in params.values() if p.grad is not None]
        got = [float(loss.detach()), float(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))]
        got += [float(params[name].grad.norm()) for name in TRAIN_LEAVES.values()]
        want = [float(ref[f"line_loss_f64_{dt}"][i]), float(ref[f"line_grad_norm_{dt}"][i])]
        want += [float(v) for v in ref[f"line_leaf_grad_norm_{dt}"][i]]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        anchors = out["interm_outputs_for_matching_pre"]["pred_boxes"][0].detach().float().cpu()
        same = np.abs(anchors.numpy() - lines["jax_anchors"][i]).max(-1) < 1e-6
        row = {"line": i, "selection_is_jax": bool(same.all()), "slots_swapped": int((~same).sum()),
               "loss": got[0], "jax_loss": want[0], "rel_err": dict(zip(
                   ("loss", "grad_norm", *TRAIN_LEAVES), rel))}
        if dt == "float32" and row["selection_is_jax"]:
            row["held"] = True
            ok = ok and rel[0] <= TRAIN_TOL_FP32["line_loss"] and all(
                r <= TRAIN_TOL_FP32["line_grad"] for r in rel[1:])
        rows.append(row)
    for p in model.parameters():
        p.grad = None
    held = sum(1 for r in rows if r.get("held"))
    return {"lines": rows, "lines_held": held, "ok": ok and (dt != "float32" or held >= 1)}


def profile_step(trainer, batch):
    """One step under torch.profiler (as eval/profile_forward.py reads a
    forward): the step's time from CUDA events, the kernels' device time
    and its share of that time, the 10 operators with the most self
    device time, the 5 busiest kernels, and the CTC kernels that ran."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        trainer.step(batch)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    ops = [e for e in events if e.device_type.name == "CPU" and e.self_device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = lambda evs, attr, n: [{"name": e.key[:90], "ms": getattr(e, attr) / 1e3,
                                 "calls": e.count}
                                for e in sorted(evs, key=lambda e: -getattr(e, attr))[:n]]
    return {"step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_ops": top(ops, "self_device_time_total", 10),
            "top_kernels": top(kernels, "device_time_total", 5),
            "ctc_kernels": sorted(e.key for e in kernels if "ctc" in e.key.lower())}


def step_split(trainer, batch):
    """One step taken in its three parts between CUDA events: the forward
    and the loss, the backward, the optimizer's update (as the step takes
    them, without EMA, which the recipe leaves off). Milliseconds each."""
    from dtlr_tpu_torch.train.engine import to_device

    state = trainer.state
    model = state.model
    b = to_device(batch, trainer.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.train()
    for p in model.parameters():
        p.grad = None
    ev[0].record()
    total, _ = trainer.step_fn.loss_fn(model, b)
    ev[1].record()
    total.backward()
    ev[2].record()
    state.optimizer.step({n: p.grad for n, p in model.named_parameters()},
                         torch.isfinite(total.detach()))
    ev[3].record()
    state.step += 1
    ev[3].synchronize()
    return {"forward_loss_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "update_ms": ev[2].elapsed_time(ev[3])}


def phase_train(card):
    """CTC finetuning on the card (see the module docstring)."""
    import tempfile

    from dtlr_tpu_torch.eval.evaluate import load_lines, load_model, read_lines
    from dtlr_tpu_torch.ops.flash_attn import RecomputeGrad, flash_mha, reset_launches
    from dtlr_tpu_torch.train.checkpoints import export_params_npz

    lines = load_lines(LINES)
    ref, jax_ref = train_reference()
    tol = train_tolerances(jax_ref)
    records = []
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        record, trainer, _ = first_step(card, "float32", lines, ref, jax_ref, tol, workdir)
        record["seconds"] = time.perf_counter() - t0
        records.append(record)
        emit(record)
        del trainer
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        record, trainer, batch = first_step(card, "bfloat16", lines, ref, jax_ref, tol, workdir)
        record["seconds"] = time.perf_counter() - t0
        records.append(record)
        emit(record)
        t0 = time.perf_counter()

        # the main path: 2 warm-up and 10 timed steps, counts from 0
        model = trainer.state.model
        watch = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n in ("class_embed.fc.weight", "transformer.decoder_layer_5.linear1.weight")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, skipped, step_ms = [], [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = trainer.step(batch)
            end.record()
            end.synchronize()
            losses.append(float(m["loss"]))
            skipped.append(float(m["skipped"]))
            if i >= TRAIN_WARMUP:
                step_ms.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        launches = dict(flash_mha.launches)
        backwards = RecomputeGrad.backwards
        peak = torch.cuda.max_memory_allocated()
        changed = {n: float((p.detach() - watch[n]).abs().max())
                   for n, p in model.named_parameters() if n in watch}
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        ms = float(np.median(step_ms))
        split = step_split(trainer, batch)
        prof = profile_step(trainer, batch)

        # round trip: the trained weights through an npz into a fresh model
        path = os.path.join(workdir, "trained.npz")
        export_params_npz(model, path, dtype=None)
        th, nms = (float(x) for x in lines["nms_point"])
        model.eval()
        trained = read_lines(model, lines, th, nms, batch_size=len(lines["texts"]))
        fresh = read_lines(load_model(path, device="cuda", compute_dtype="bfloat16"), lines, th,
                           nms, batch_size=len(lines["texts"]))
        record = {"phase": "train", "compute_dtype": "bfloat16", "steps": n_steps,
                  "warmup": TRAIN_WARMUP, "losses": losses, "skipped": skipped,
                  "ms_per_step_median": ms, "ms_per_step": step_ms,
                  "lines_per_s": len(lines["texts"]) / (ms / 1e3),
                  "peak_memory_bytes": peak, "launches": launches,
                  "recompute_backwards": backwards, "param_change_abs_max": changed,
                  "split_ms": split, "profiled_step": prof,
                  "round_trip": {"greedy_trained": trained["greedy"],
                                 "greedy_reloaded": fresh["greedy"],
                                 "same": trained["greedy"] == fresh["greedy"]},
                  "seconds": time.perf_counter() - t0, "card": card}
        records.append(record)
        record["ok"] = (all(math.isfinite(x) for x in losses) and not any(skipped)
                        and all(v > 0 for v in changed.values()) and len(changed) == 2
                        and launches == {"mha_box": 6 * n_steps, "mha": 6 * n_steps,
                                         "mha_masked": 0}
                        and backwards == 12 * n_steps and record["round_trip"]["same"])
        emit(record)
        del trainer, model
        torch.cuda.empty_cache()
    failed = [(r["compute_dtype"], r.get("step", "timed")) for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"train phase checks failed: {failed} (steps: 0 is the first "
                             "against JAX's, 'timed' the 12 steps after it)")
    return records, launches


def detect_reference():
    """JAX's first detection step on the detection fixture
    (smoke_detect_ref.npz, written on the CPU by
    tests/test_torch_smoke_detect.py): per dtype the batch's loss, every
    term, the gradient's global norm and DETECT_LEAVES' norms, and each
    line's seven assignments."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    ref = load_lines(DETECT_REF)
    values = {}
    for dt in ("float32", "bfloat16"):
        values[dt] = {"loss": float(ref[f"loss_{dt}"]), "grad_norm": float(ref[f"grad_norm_{dt}"]),
                      **{f"term:{k}": float(v) for k, v in zip(ref["terms"], ref[f"terms_{dt}"])},
                      **{f"leaf:{k}": float(v) for k, v in zip(ref["leaves"],
                                                              ref[f"leaf_grad_norm_{dt}"])}}
    return ref, values


def detect_tolerances(jax_ref):
    """Relative tolerance per quantity and dtype: DETECT_TOL_FP32 in float32;
    in bfloat16 BF16_SPREAD times JAX's own float32-to-bfloat16 difference
    of the quantity, never tighter than BF16_FLOOR."""
    kind = lambda k: k.split(":")[0] if ":" in k else k
    tol = {"float32": {k: DETECT_TOL_FP32[kind(k)] for k in jax_ref["float32"]}}
    tol["bfloat16"] = {k: max(BF16_FLOOR, BF16_SPREAD * abs(jax_ref["bfloat16"][k] - v)
                              / max(abs(v), 1e-12))
                       for k, v in jax_ref["float32"].items()}
    return tol


def detect_trainer(compute_dtype, workdir, noise):
    """The recipe's detection trainer from the pretraining trunk; with
    ``noise`` False the CDN queries carry no noise (the first step against
    JAX's)."""
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.train.checkpoints import load_params_npz
    from dtlr_tpu_torch.train.config import RECIPE_DETECTION
    from dtlr_tpu_torch.train.engine import Trainer

    model_cfg = dataclasses.replace(FLAGSHIP, compute_dtype=compute_dtype)
    if not noise:
        model_cfg = dataclasses.replace(model_cfg, dn_label_noise_ratio=0.0,
                                        dn_box_noise_scale=0.0)
    trainer = Trainer(RECIPE_DETECTION, model_cfg, os.path.join(workdir, compute_dtype),
                      device="cuda", mode="detection")
    trainer.build(load_params_npz(DETECT_PARAMS))
    return trainer


def assignment_record(trainer, arrays, ref, compute_dtype):
    """The port's two-stage selection and seven matchings of the batch
    before the step (a forward in train mode without gradients, the step's
    own inputs), against JAX's. A line's selection is JAX's when every
    selected proposal's anchor is JAX's, slot for slot (near-tied
    proposal scores swap slots, see the read phase). Per matched output:
    the lines whose assignment is JAX's query for query, and those whose
    every target is matched to JAX's proposal (the anchor of its query),
    which is what a swap of slots leaves unchanged. For a line that
    differs: the targets matched to another proposal, and how near a tie:
    the port's cost of the queries holding JAX's proposals over the cost
    of its own, relative, under the port's costs (when the port selected
    all of JAX's proposals). Held: in float32 a line with JAX's selection
    keeps JAX's assignment query for query; in bfloat16 a line matched to
    other proposals must be one where JAX's own float32 and bfloat16
    steps match to different proposals too (a tie at bf16's resolution:
    on an H100 one target of line 3 moved, which JAX's own
    float32-to-bfloat16 change moves as well)."""
    from dtlr_tpu_torch.ops.matcher import match_cost, match_outputs
    from dtlr_tpu_torch.ops.pixels import prep_images

    model = trainer.state.model
    model.train()
    targets = {k: arrays[k] for k in ("labels", "boxes", "valid")}
    with torch.no_grad():
        out = model(prep_images(arrays["images"], arrays["valid_hw"]), arrays["valid_hw"],
                    targets, train=True)
        matched = [out] + list(out["aux_outputs"]) + [out["interm_outputs"]]
        assign = match_outputs(matched, targets["labels"], targets["boxes"].float(),
                               targets["valid"])
    cfg = trainer.cfg
    anchors = out["interm_outputs_for_matching_pre"]["pred_boxes"].float().cpu().numpy()
    jax_anchors = ref[f"anchors_{compute_dtype}"]
    same_slot = np.abs(anchors - jax_anchors).max(-1) <= ANCHOR_TOL  # (B, nq)
    selection = [{"line": i, "selection_is_jax": bool(same_slot[i].all()),
                  "slots_swapped": int((~same_slot[i]).sum())} for i in range(len(anchors))]
    jax_assign = ref[f"assign_{compute_dtype}"]  # (lines, outputs, N)
    valid = arrays["valid"].cpu().numpy()
    jax_moves = jax_own_moves(ref, valid)
    record = {}
    for o, (name, a) in enumerate(zip(ref["matched"], assign)):
        a = a.cpu().numpy()
        by_query, by_proposal, differ = 0, 0, []
        for i in range(a.shape[0]):
            cols = np.flatnonzero(valid[i])
            ja = jax_assign[i, o, cols]
            by_query += int(np.array_equal(a[i, cols], ja))
            moved = np.abs(anchors[i, a[i, cols]] - jax_anchors[i, ja]).max(-1) > ANCHOR_TOL
            if not moved.any():
                by_proposal += 1
                continue
            # the port's query holding each of JAX's proposals, if it selected it
            hits = np.abs(anchors[i][None, :, :] - jax_anchors[i, ja][:, None, :]).max(-1)
            holder = np.where((hits <= ANCHOR_TOL).any(1), hits.argmin(1), -1)
            row = {"line": i, "targets_moved": int(moved.sum()),
                   "jax_proposals_selected": int((holder >= 0).sum()), "targets": len(cols)}
            if (holder >= 0).all():
                cost = match_cost(matched[o]["pred_logits"][i], matched[o]["pred_boxes"][i].float(),
                                  targets["labels"][i], targets["boxes"][i].float(),
                                  cfg.set_cost_class, cfg.set_cost_bbox, cfg.set_cost_giou,
                                  cfg.focal_alpha).cpu().numpy()
                own = float(cost[a[i, cols], cols].sum())
                theirs = float(cost[holder, cols].sum())
                row.update(cost_own=own, cost_jax_proposals=theirs,
                           rel_gap=(theirs - own) / max(abs(own), 1e-12))
            differ.append(row)
        record[name] = {"lines_equal_by_query": by_query, "lines_equal_by_proposal": by_proposal,
                        "lines": int(a.shape[0]), "differ": differ,
                        "jax_own_fp32_bf16_moves": sorted(jax_moves[name])}
        # float32: a line with JAX's selection keeps JAX's assignment; bfloat16:
        # a line matched to other proposals is one whose matched proposals
        # also move between JAX's own float32 and bfloat16 steps
        moved_lines = {row["line"] for row in differ}
        if compute_dtype == "float32":
            record[name]["ok"] = not any(
                selection[i]["selection_is_jax"] and not np.array_equal(
                    a[i, valid[i]], jax_assign[i, o, valid[i]]) for i in range(a.shape[0]))
        else:
            record[name]["ok"] = moved_lines <= jax_moves[name]
    return record, selection


def jax_own_moves(ref, valid):
    """Per matched output, the lines on which JAX's own float32 and
    bfloat16 first steps match some target to different proposals."""
    af, ab = ref["anchors_float32"], ref["anchors_bfloat16"]
    moves = {}
    for o, name in enumerate(ref["matched"]):
        moves[name] = set()
        for i in range(len(valid)):
            cols = np.flatnonzero(valid[i])
            pa = af[i, ref["assign_float32"][i, o, cols]]
            pb = ab[i, ref["assign_bfloat16"][i, o, cols]]
            if (np.abs(pa - pb).max(-1) > ANCHOR_TOL).any():
                moves[name].add(i)
    return moves


def detect_line_steps(trainer, batch, ref, compute_dtype, selection):
    """Each line's loss, DN class loss and gradient norms alone (B=1, the
    batch's frame), before the step, against JAX's per-line values. In
    float32 the lines whose selection is JAX's are held to
    DETECT_LINE_TOL_FP32; the others are reported with their swapped
    slots."""
    from dtlr_tpu_torch.train.engine import to_device

    model = trainer.state.model
    model.train()
    terms = list(ref["terms"])
    rows, ok = [], True
    for i in range(len(batch["texts"])):
        for p in model.parameters():
            p.grad = None
        b = to_device({k: np.asarray(batch[k][i:i + 1]) for k in
                       ("images", "valid_hw", "labels", "valid", "boxes")}, trainer.device)
        total, losses = trainer.step_fn.loss_fn(model, b)
        total.backward()
        params = dict(model.named_parameters())
        grads = [p.grad for p in params.values() if p.grad is not None]
        got = {"loss": float(total.detach()), "loss_ce_dn": float(losses["loss_ce_dn"]),
               "grad_norm": float(torch.linalg.vector_norm(torch.stack(
                   torch._foreach_norm(grads))))}
        got.update({f"leaf:{k}": float(params[DETECT_LEAVES[k]].grad.float().norm())
                    for k in ref["leaves"]})
        want = {"loss": float(ref[f"line_loss_{compute_dtype}"][i]),
                "loss_ce_dn": float(ref[f"line_terms_{compute_dtype}"][i][
                    terms.index("loss_ce_dn")]),
                "grad_norm": float(ref[f"line_grad_norm_{compute_dtype}"][i])}
        want.update({f"leaf:{k}": float(v) for k, v in
                     zip(ref["leaves"], ref[f"line_leaf_grad_norm_{compute_dtype}"][i])})
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in got}
        row = {"line": i, **selection[i], "rel_err": rel}
        if compute_dtype == "float32" and selection[i]["selection_is_jax"]:
            row["held"] = True
            kind = lambda k: k.split(":")[0] if ":" in k else k
            ok = ok and all(rel[k] <= DETECT_LINE_TOL_FP32[kind(k)] for k in rel)
        rows.append(row)
    for p in model.parameters():
        p.grad = None
    held = sum(1 for r in rows if r.get("held"))
    return {"lines": rows, "lines_held": held,
            "ok": ok and (compute_dtype != "float32" or held >= 1)}


def detect_first_step(card, compute_dtype, lines, ref, jax_ref, tol, workdir):
    """One step of the recipe's detection trainer (zero CDN noise) on the
    eight lines: its loss, terms and gradient norms against JAX's first
    step, the matchings against JAX's, and its launches."""
    from dtlr_tpu_torch.ops import matcher
    from dtlr_tpu_torch.ops.flash_attn import RecomputeGrad, flash_mha, reset_launches
    from dtlr_tpu_torch.train.engine import collate, to_device

    t0 = time.perf_counter()
    trainer = detect_trainer(compute_dtype, workdir, noise=False)
    batch = collate(lines, range(len(lines["texts"])), lines["charset"], MAX_TARGETS)
    build_s = time.perf_counter() - t0
    assignments, selection = assignment_record(trainer, to_device(batch, trainer.device), ref,
                                               compute_dtype)
    per_line = detect_line_steps(trainer, batch, ref, compute_dtype, selection)
    reset_launches()
    matcher.reset_stats()
    m = trainer.step(batch)
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    backwards = RecomputeGrad.backwards
    params = dict(trainer.state.model.named_parameters())
    got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    got.update({f"term:{k}": float(m[k]) for k in ref["terms"]})
    got.update({f"leaf:{k}": float(params[DETECT_LEAVES[k]].grad.float().norm())
                for k in ref["leaves"]})
    want = jax_ref[compute_dtype]
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in got}
    n_dec = trainer.model_cfg.dec_layers
    worst = sorted(rel, key=lambda k: -rel[k] / tol[compute_dtype][k])[:8]
    label_rows = (params["label_enc"].grad.abs().sum(-1) > 0).nonzero().flatten().tolist()
    used = sorted(set(batch["labels"][batch["valid"]].tolist()))
    record = {"phase": "detect", "step": 0, "compute_dtype": compute_dtype,
              "params": os.path.relpath(DETECT_PARAMS, REPO), "lines": len(lines["texts"]),
              "port": {k: got[k] for k in ("loss", "grad_norm")},
              "jax": {k: want[k] for k in ("loss", "grad_norm")},
              "rel_err": rel, "tol": tol[compute_dtype],
              "worst_by_tolerance": [(k, rel[k], tol[compute_dtype][k]) for k in worst],
              "skipped": float(m["skipped"]), "per_line": per_line,
              "assignments": assignments,
              "launches_per_step": launches, "recompute_backwards_per_step": backwards,
              "matcher": dict(matcher.auction_assign.stats),
              "label_enc_rows_with_gradient_are_the_labels": label_rows == used,
              "build_s": build_s, "card": card}
    record["ok"] = (all(rel[k] <= tol[compute_dtype][k] for k in rel)
                    and record["skipped"] == 0.0 and label_rows == used and per_line["ok"]
                    and all(a["ok"] for a in assignments.values())
                    and launches == {"mha_box": n_dec, "mha": 0, "mha_masked": n_dec}
                    and backwards == 2 * n_dec)
    return record, trainer, batch


def detect_split(trainer, batch):
    """One detection step (``Trainer.step``) in its parts between CUDA
    events that the step records as each phase ends: the forward, the
    matching (seven outputs, one auction), the loss, the backward and the
    optimizer's update with EMA. Milliseconds each."""
    events = [torch.cuda.Event(enable_timing=True)]
    phases = []

    def mark(phase):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        phases.append(phase)

    events[0].record()
    trainer.step(batch, mark=mark)
    events[-1].synchronize()
    return {f"{p}_ms": events[i].elapsed_time(events[i + 1]) for i, p in enumerate(phases)}


def phase_detect(card):
    """The detection training step on the card (see the module docstring)."""
    import tempfile

    from dtlr_tpu_torch.eval.evaluate import load_lines
    from dtlr_tpu_torch.ops import matcher
    from dtlr_tpu_torch.ops.flash_attn import RecomputeGrad, flash_mha, reset_launches
    from dtlr_tpu_torch.train import pretrain

    lines = load_lines(DETECT_LINES)
    ref, jax_ref = detect_reference()
    tol = detect_tolerances(jax_ref)
    records = []
    with tempfile.TemporaryDirectory() as workdir:
        for compute_dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            record, trainer, batch = detect_first_step(card, compute_dtype, lines, ref, jax_ref,
                                                       tol, workdir)
            record["seconds"] = time.perf_counter() - t0
            records.append(record)
            emit(record)
            del trainer
            torch.cuda.empty_cache()

        # the main path: the recipe with its CDN noise, 2 warm-up and 10
        # timed bf16 steps, counts from 0
        t0 = time.perf_counter()
        trainer = detect_trainer("bfloat16", workdir, noise=True)
        model = trainer.state.model
        watch = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n in ("class_embed.fc.weight", "label_enc")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        matcher.reset_stats()
        losses, skipped, step_ms, terms = [], [], [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = trainer.step(batch)
            end.record()
            end.synchronize()
            losses.append(float(m["loss"]))
            skipped.append(float(m["skipped"]))
            terms.append({k: float(m[k]) for k in ("loss_ce", "loss_bbox", "loss_giou",
                                                   "loss_ce_dn", "loss_bbox_dn")})
            if i >= TRAIN_WARMUP:
                step_ms.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        launches = dict(flash_mha.launches)
        backwards = RecomputeGrad.backwards
        match_stats = dict(matcher.auction_assign.stats)
        peak = torch.cuda.max_memory_allocated()
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        changed = {n: float((p.detach() - watch[n]).abs().max())
                   for n, p in model.named_parameters() if n in watch}
        ms = float(np.median(step_ms))
        split = detect_split(trainer, batch)
        prof = profile_step(trainer, batch)
        record = {"phase": "detect", "compute_dtype": "bfloat16", "cdn_noise": True,
                  "steps": n_steps, "warmup": TRAIN_WARMUP, "losses": losses,
                  "terms": terms, "skipped": skipped, "ms_per_step_median": ms,
                  "ms_per_step": step_ms, "lines_per_s": len(lines["texts"]) / (ms / 1e3),
                  "peak_memory_bytes": peak, "launches": launches,
                  "recompute_backwards": backwards,
                  "matcher_per_step": {k: v / n_steps for k, v in match_stats.items()},
                  "param_change_abs_max": changed, "split_ms": split, "profiled_step": prof,
                  "card": card}
        n_dec = model.cfg.dec_layers
        record["ok"] = (all(math.isfinite(x) for x in losses) and not any(skipped)
                        and all(v > 0 for v in changed.values()) and len(changed) == 2
                        and launches == {"mha_box": n_dec * n_steps, "mha": 0,
                                         "mha_masked": n_dec * n_steps}
                        and backwards == 2 * n_dec * n_steps)
        records.append(record)
        del trainer, model
        torch.cuda.empty_cache()

        # the entry point a user runs: two steps, a save and the detection eval
        reset_launches()
        cli = pretrain.main(["--params", DETECT_PARAMS, "--lines", DETECT_LINES,
                             "--output_dir", os.path.join(workdir, "cli"), "--steps", "2"])
        torch.cuda.synchronize()
        record["entry_point"] = {
            "train": cli["train"], "eval": cli["eval"], "launches": dict(flash_mha.launches),
            "weights_saved": os.path.exists(cli["params"])}
        record["ok"] = (record["ok"] and record["entry_point"]["weights_saved"]
                        and math.isfinite(cli["eval"]["loss"])
                        and flash_mha.launches["mha_masked"] == 2 * n_dec)
        record["seconds"] = time.perf_counter() - t0
        emit(record)
        torch.cuda.empty_cache()
    failed = [(r["compute_dtype"], r.get("step", "timed")) for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"detect phase checks failed: {failed} (steps: 0 is the first "
                             "against JAX's, 'timed' the 12 recipe steps and the entry point)")
    return records, launches


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
    attn_lib = flash_attn.load_library()
    gather.load_library()
    # tensor-core instructions per attention kernel: the bf16 one must have some
    sass = {fn: n for fn, n in _build.sass_counts(built[0]["path"]).items() if "box_attn" in fn}
    emit({"phase": "build",
          "nvcc_seconds": {os.path.basename(b["source"]): b["seconds"] for b in built},
          "ptxas": [l.strip() for b in built for l in b["ptxas"].splitlines()
                    if "entry function" in l or "registers" in l or "spill" in l],
          # the bf16 kernel's shared memory is dynamic, outside ptxas's report
          "bf16_dynamic_smem_bytes": {
              f"mha_box, L={len(LEVELS[2720])}": attn_lib.dtlr_box_attn_bf16_smem(
                  1, len(LEVELS[2720]), 0),
              "mha": attn_lib.dtlr_box_attn_bf16_smem(0, 1, 0),
              "mha_masked": attn_lib.dtlr_box_attn_bf16_smem(0, 1, 1)},
          "sass_tensor_core_instructions": sass,
          "seconds": time.perf_counter() - t0})
    # three bf16 instantiations: with the prior, without it, and masked
    bf16_kernels = [n for fn, n in sass.items() if "bf16" in fn]
    if len(bf16_kernels) != 3 or not all(n["HMMA"] + n["HGMMA"] > 0 for n in bf16_kernels):
        raise AssertionError(f"the bf16 attention kernels do not run on the tensor cores: {sass}")

    t0 = time.perf_counter()
    rows = phase_kernels(card) + [phase_gather(card)]
    emit({"phase": "kernels", "rows": rows, "masked_rows": masked_rows(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    grad_rows = phase_grad(card)
    emit({"phase": "grad", "rows": grad_rows, "seconds": time.perf_counter() - t0})

    launches = {}
    for compute_dtype, ref in (("float32", LINES), ("bfloat16", LINES_BF16)):
        t0 = time.perf_counter()
        record, launches[compute_dtype] = read_once(card, compute_dtype, ref)
        record["seconds"] = time.perf_counter() - t0
        emit(record)

    train_records, train_launches = phase_train(card)

    detect_records, detect_launches = phase_detect(card)

    t0 = time.perf_counter()
    rc, probe_launches = phase_probe()
    emit({"phase": "probe", "rc": rc, "launches": probe_launches,
          "seconds": time.perf_counter() - t0})

    # each kernel at its main path's shape, dtype and layout: the attention
    # in the recipe's bfloat16 on the decoder's strided views, the gather
    # in the probe. This slice's path is the detection step (the cross-
    # attention at 1028 queries, the masked self-attention); the unmasked
    # self-attention runs on the read and CTC paths (its launches: the 12
    # CTC steps), the gather in the probe. Every path's counts beside them.
    main_shape = {"mha_box": (2720, Q_DETECT, "bfloat16", "strided"),
                  "mha": (900, Q, "bfloat16", "strided"),
                  "mha_masked": (Q_DETECT, Q_DETECT, "bfloat16", "strided"),
                  "row_gather": (GATHER_S, GATHER_Q, "float32", None)}
    main_launches = {"mha_box": detect_launches["mha_box"], "mha": train_launches["mha"],
                     "mha_masked": detect_launches["mha_masked"], **probe_launches}
    paths = {"read_bf16_forward": launches["bfloat16"], "read_fp32_forward": launches["float32"],
             "ctc_train_bf16_12_steps": train_launches,
             "detect_bf16_12_steps": detect_launches}
    by_path = {name: {path: counts[name] for path, counts in paths.items()}
               for name in flash_attn.KERNELS}
    by_path["row_gather"] = {"probe": probe_launches["row_gather"]}
    replaces = {**REPLACES, "mha_masked": REPLACES["mha"]}
    kernels = []
    for name in (*flash_attn.KERNELS, *gather.KERNELS):
        row = next(r for r in rows if (r["name"], r["S"], r.get("Q"), r["dtype"], r.get("layout"))
                   == (name, *main_shape[name]))
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": replaces[name], "launches": main_launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")},
                        "launches_by_path": by_path[name]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
