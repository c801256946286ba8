#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dtlr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  device   the card, its power limit, TF32 off for matmuls and convolutions
  native   csrc/native.cpp built with this host's C++ compiler (the port's
           native host runtime: the data path's upscale and normalize, the
           metrics, the image decoders), its seconds
  data     the recipes' batchers (dtlr_tpu_torch.data.batching): the first 4
           training batches of the finetune recipe over the fixture lines
           and of the pretraining recipe (reuse pool, character boxes) over
           the detection fixture, against the JAX package's committed ones
           (dtlr_tpu_torch/assets/smoke_data.npz: sha256 of the uint8
           images, labels, validity, valid sizes, boxes), numpy's version
           on both sides, ms per batch on the host; and the pretraining
           recipe's first 4 batches with half the lines rotated by 10
           degrees (PIL's rotation and bicubic resize, ported) against
           JAX's (assets/smoke_rotate_data.npz)
  build    one nvcc per CUDA source (dtlr_tpu_torch/csrc/box_attn.cu and
           row_gather.cu), all started together, for sm_90a (ptxas report:
           registers, shared memory, spills; each attention block's dynamic
           shared memory), and the count of tensor-core instructions (HMMA,
           HGMMA) in each attention kernel's SASS: all six instantiations,
           bf16 and fp32 (3xTF32), must have some
  kernels  the instantiations of the box-prior attention kernel against
           their plain PyTorch version on the card, at the decoder's shapes,
           in fp32 and bf16, on contiguous heads and on strided views built
           as the decoder builds them (the box prior over 4 levels at
           S = 2720 and 3570, and over 5 at S = 2728), the detection
           step's shapes (1028 queries; the masked self-attention at
           Q = S = 1028 with the CDN group mask, whose matching rows find
           two key tiles blocked whole, against SDPA with the boolean
           mask), V rows that ramp over
           the key index at S = 3570 in fp32 (the kernel's key order in P.V;
           the row also shows how far swapping each key pair would move the
           plain version), a fully masked row (uniform and
           finite), and the row gather at the probe's shapes (an index out
           of range trips its device-side assert, checked in a child
           process); times of each kernel, its plain version and one
           library call (``ms``: events around 20 back-to-back calls, which
           the host's per-call work bounds where it exceeds the card's;
           ``graph_ms``: the same calls replayed from a CUDA graph, the card
           alone; ``host_us``: the wrapper's host time per call) and the
           bound (fp32: the 3xTF32 products at the TF32 peak, the per-score
           floor or the bytes, with the CUDA-core bound of the earlier fp32
           kernel beside it)
  grad     gradients through the attention kernel's autograd Function
           (q, k, v and the prior's cx, cy, ihw, ihh, gamma) against the
           plain version's autograd gradients, at the decoder's shapes
  read     the flagship checkpoint (artifacts/r4ft_params.npz) reads the
           eight committed lines (dtlr_tpu_torch/assets/smoke_lines.npz)
           through the port's entry-point functions twice: in float32, held
           against the JAX package's float32 reading, and in the recipe's
           bfloat16, held against its bf16 reading (smoke_lines_bf16.npz);
           launch counts per forward and lines/s for each
  sweep    python -m dtlr_tpu_torch.eval.evaluate --sweep over the fixture
           lines with the flagship checkpoint, in float32 and bfloat16:
           the 10 x 9 TH x NMS grid decoded from one forward per batch
           (6 launches of each attention instantiation per batch, not 90
           times that), every point's CER against the JAX package's
           committed grid (dtlr_tpu_torch/assets/smoke_sweep.json), the
           best point, the files written; forward ms per batch, NMS ms
           per NMS value and batch, decode ms per point, lines/s; each
           dtype twice (the first call cold, then the same again)
  datasets the real datasets' loaders on dtlr_tpu_torch/assets/smoke_datasets/
           (a RIMES layout of JPEG lines, an HWDB layout of PNG lines, written
           by tests/test_torch_datasets_fixture.py): (a) every file decoded
           to the sha256 of PIL's pixels (the native decoders, and two files
           per format through the numpy versions; ms per line per format),
           Levenshtein and the edit operations on the sweep fixture's string
           pairs, the upscale and the normalize on the decoded lines equal
           to their plain versions (ms per call); (b) python -m
           dtlr_tpu_torch.eval.evaluate --dataset RIMES and --dataset HWDB
           with the flagship in fp32 and bf16: the strings within CER 0.01 /
           0.02 of the JAX package's evaluate (smoke_datasets_ref.json), 6
           launches of mha_box and of mha per forward, lines/s; (c) two
           steps of python -m dtlr_tpu_torch.train.finetune --dataset_file
           RIMES from the flagship, each batch's images the JAX package's
           (its hashes in the reference), finite losses, ms per step, the
           decode's share of the host's batch time; (d) the sweep's decode
           of the fixture lines' fp32 forward with the native metrics and
           with the plain ones: the same records, ms per point; (e) the
           other image forms (dtlr_tpu_torch/assets/smoke_forms/, written by
           tests/test_torch_forms_fixture.py): a Borg layout of eight TIFF
           lines (LZW with and without the predictor, Deflate, PackBits,
           uncompressed strips; gray, RGB, RGBA, palette) and progressive
           JPEG, Adam7 and 16-bit PNG, big-endian and bilevel TIFF files,
           each decoded native and plain to PIL's hash (ms per line per
           form), and python -m dtlr_tpu_torch.eval.evaluate --dataset borg
           in fp32 and bf16 against the JAX package's strings (CER 0.01 /
           0.02, 6 + 6 launches a forward)
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
           into a fresh model that reads the lines to the same strings;
           then two steps of the entry point python -m
           dtlr_tpu_torch.train.finetune through the recipe's batcher
           (finite losses, each step's batch the data phase's)
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
           point python -m dtlr_tpu_torch.train.pretrain through the
           recipe's batcher with the reuse pool (each step's batch the
           data phase's)
  pretrain the training entry points from config files, as the repository's
           scripts ran the JAX package's: (a) python -m
           dtlr_tpu_torch.train.pretrain -c configs/Latin_TPU.py from a fresh
           initialization on the detection fixture's lines with
           scripts/round4_chain.sh's options, 2 epochs of 2 steps, each
           evaluated with the raw and the EMA weights (finite losses; CER,
           NMS CER and the decode's diagnostics in every evaluation), then a
           warm start of the same recipe from artifacts/r4run_params.npz
           (474 leaves copied, 0 fresh, 0 unused) and its --eval; (b)
           -c configs/Chinese_TPU.py on the HWDB_synth stream of the committed
           GNT bank (dtlr_tpu_torch/assets/smoke_hwdb.gnt) warm-started from
           the same npz as scripts/hwdb_real.sh does (the fresh leaves
           exactly the class heads and the label encoder), 3 steps whose
           batches hash to the JAX package's (assets/smoke_hwdb_ref.json),
           evaluated raw and EMA; then the same command with --epochs 2,
           which must resume at epoch 1, step 3 with the saved parameters,
           optimizer state and EMA exactly, and finish its epoch; then
           python -m dtlr_tpu_torch.eval.evaluate --config <run>/config_cfg.py
           on 8 HWDB lines (AR and CR); (c) python -m
           dtlr_tpu_torch.train.finetune -c configs/HWDB_full_TPU.py from
           (b)'s run directory (finite CTC losses). Each sub-run's
           attention launches against the count its steps and evaluations
           must make, its ms per step (host clock around each step, the
           card synchronized) and its peak memory
  deform   the reference-faithful path, configs/Latin.py's model (deformable
           encoder and cross-attention, FrozenBN ResNet-50) at full width
           with weights drawn by ``deform_weights`` from a frozen numpy
           stream: (a) it reads the eight fixture lines in fp32, in the
           recipe's bf16 and in fp32 with deform_shared_offsets, each against
           the JAX package's reading of the same weights
           (dtlr_tpu_torch/assets/smoke_deform_ref.npz, written by
           tests/test_torch_deform_fixture.py): per query boxes and max
           logits where the two-stage selection is JAX's, a swapped slot
           only between scores within SWAP_GAP_TOL, the strings on the
           lines whose selection is JAX's (fp32), the strings within twice
           JAX's own bf16-to-fp32 spread (bf16); 6 ``mha`` launches and no
           other per forward; lines/s, peak memory and the sampling core's
           ms per encoder and decoder layer beside its bytes bound; (b) the
           weights through a reference-named .pth (torch_import) into a
           fresh model, which must read the lines bit for bit alike; (c)
           python -m dtlr_tpu_torch.train.pretrain -c configs/Latin.py from
           scratch on the detection fixture with round4_chain.sh's data
           options, 2 epochs of 2 steps with CDN (finite losses, none
           skipped, ``mha_masked`` per step and ``mha`` per evaluation, every
           FrozenBN leaf of the parameters and the EMA its fresh value bit
           for bit); (d) train.finetune -c configs/Latin_CTC.py from (c)'s
           run with --new_class_embedding --smart_mapping, 2 steps, and
           eval.evaluate --config configs/Latin_CTC.py --NMS 0.5 --TH 0.3 on
           its weights (scripts/finetuning/IAM.sh, scripts/evaluating/IAM.sh);
           (e) train.pretrain -c configs/Chinese.py on the committed HWDB
           bank, 2 steps without CDN (scripts/pretraining/Synthetic_chinese.sh)
  ddp      data parallelism over torch.distributed (dtlr_tpu_torch.parallel):
           (a) python -m dtlr_tpu_torch.train.pretrain (two bf16 recipe steps
           at B=8 on the detection fixture, a save, the evaluations) under
           torchrun --nproc_per_node 1 over NCCL and the same command without
           torchrun, each a child process: the saved train state and the
           exported weights bit for bit alike, info.txt, log.txt and the
           checkpoint written once; (b) the detection step (recipe CDN noise
           drawn for the global batch, the auction) and the CTC step in fp32,
           3 steps each on the eight fixture lines (global B=8), through
           python -m dtlr_tpu_torch.scripts.ddp_check: in this process, over
           two gloo ranks both on cuda:0 (4 lines each; the gradients' sum
           staged through the host), and the detection step over NCCL at
           world size 1: the ranks' parameters, optimizer state and EMA bit
           for bit alike; the first step's global loss, terms and gradient
           within DDP_REL (of the gradient's norm) of their reference, one
           process's steps on each rank's four lines combined (world size
           1: one process on all eight); that reference against one process
           on all eight within SHAPE_LOSS_REL and SHAPE_GRAD_REL, with the
           leaf that moves most, how the two-stage selection moves between
           the halves and the whole batch, and how far one process moves
           when every weight moves one float32 ulp; every rank's attention
           launches as counted (6 + 6 a step); ms per step per rank, the
           all-reduce's own ms, peak memory per rank; (c) the port's dry run
           (dtlr_tpu_torch.scripts.dryrun_multichip) over two gloo ranks on
           the card, run beside (a)'s two children; and the windowed
           encoder's resize backward, CUDA's atomic one against
           _MatrixResize's (the encoder's, which lets (a) repeat bit for
           bit), ms per layer
  ngram    the n-gram rescoring of the read: python -m dtlr_tpu_torch.ngram.rescore
           with the flagship checkpoint on the 16 lines of
           dtlr_tpu_torch/assets/smoke_words.npz (a 6-gram stupid-backoff LM
           fit on artifacts/corpus_words_train.txt, weight 0.75, beam 16,
           the YAML's gating), four children in parallel: fp32, bf16, the
           lexicon arm in fp32 and a two-point --sweep_lm in fp32; meanwhile
           in this process (a) the port's decoder on the JAX package's
           committed fp32 posteriors (dtlr_tpu_torch/assets/smoke_words_ref.npz)
           gives JAX's n-gram and lexicon strings exactly; each child (b) its
           greedy and n-gram strings within CER 0.01 (fp32) / 0.02 (bf16) of
           JAX's, the lines that differ, (c) 6 mha_box and 6 mha launches
           per forward batch, (d) ngram_preds/preds_ngram.txt written (none
           by the sweep); forward ms per batch, the LM's fit seconds, decode
           ms per line per arm, CER against the ground truth, lines/s; then
           the LM rescorer (models/lm_rescorer.py, d_model 256, 8 heads, 4
           layers, seeded) over the decoder's last features of 8 of the
           lines: shape, finite, ms
  backbones configs/Latin_TPU.py's model at full width from deform_weights'
           seeded stream with the Swin and ConvNeXt backbones:
           swin_T_224_1k and convnext_tiny read the eight fixture lines in
           fp32, held against the JAX package's reading of the same weights
           (dtlr_tpu_torch/assets/smoke_backbones_ref.npz, written by
           tests/test_torch_backbones_fixture.py) as the deform phase holds
           its own, and in bf16 (the backbone's Dense layers in bf16, finite
           outputs); swin_L_224_22k and convnext_xlarge_22k read in bf16;
           every reading 6 + 6 attention launches, ms, lines/s, peak
           memory; then for swin_T and convnext_tiny one pretraining step
           of python -m dtlr_tpu_torch.train.pretrain -c configs/Latin_TPU.py
           --options backbone=... (B=8, CDN) with its evaluation, and for the
           large two three recipe steps through Trainer (its first batch):
           finite losses, ms, peak memory, launches as counted; the step's
           weights the recipe's fresh init, Swin's backbone deform_weights'
           (a fresh Swin overflows its gradient on zero padding, JAX alike)
  arch     the architecture settings the JAX package takes beyond the
           recipes' (configs/Latin_TPU.py at full width with ARCH_OPTIONS:
           five feature levels, S = 2728 keys at 128x1024, the decoder's
           cross-attention first, the y temperature 10000; deform_weights'
           seeded stream): (a) the eight fixture lines read in fp32, held
           against the JAX package's reading of the same weights
           (assets/smoke_arch_ref.npz, tests/test_torch_arch_fixture.py):
           its own selection's swaps only between near-tied scores (every
           line has some with these weights), then with JAX's selection
           forced, per query and by its strings on every line as the
           backbones phase holds its own; and in bf16 (held as the
           deform phase holds its bf16 reading: the strings against JAX's
           fp32 ones within twice JAX's own bf16-to-fp32 spread, and
           beside them against JAX's bf16 strings); 6 mha_box launches
           over the 5 levels and 6 mha a forward, each kernel on a call
           captured from the forward against its plain version; the model
           at dropout 0.1 read in eval mode bit for bit the rate-0 reading;
           (b) the train-mode forward at dropout 1.0 (no denoising) held
           against JAX's as the fp32 read; three CTC steps of the model
           and three detection steps of configs/Latin.py (deformable
           encoder and cross-attention, CDN, B=8) at dropout 0.1: finite losses, ms per step, peak
           memory, every site's kept share within 5 sigma of 0.9 and what
           it keeps scaled by 1/0.9 exactly, the launches as counted, mha,
           mha_box and mha_masked on captured calls against their plain
           versions; (e) evaluate_ctc of the stepped model writes its
           snapshot (snapshots/snapshot_epoch0000.png), and save_snapshot
           on committed arrays gives the JAX package's pixels
           (assets/smoke_snapshot.npz, tests/test_torch_visualizer.py)
  probe    the row-gather probe entry point (dtlr_tpu_torch.scripts.gather_probe)
Then the line {"kernels": [...]} for every ported kernel (the attention
in bf16 and, as ``*_fp32``, in fp32, at each dtype's path), the card's name
and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: exit code not 0.
Needs torch, numpy and the repository; no network and no JAX.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
LINES = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
LINES_BF16 = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines_bf16.npz")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and operations / peak rate
# for the inputs' type; fp32 attention runs its products on the tensor
# cores in 3xTF32 (three TF32 products each), the gather on the CUDA cores
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 495e12
MEM_BYTES_PER_S = 3.35e12
# the attention's per-score floor at D=32: besides its two products each
# score costs fp32 instructions on the CUDA cores at 128 lanes x 132 SMs x
# 1.98 GHz, and one ex2 on the SFUs at 16 per SM per clock; the floor is
# the larger of the two (published rates, no measurement). bf16: scale and
# bias, the prior's five, max, exponent argument, row sum: 9 with the
# prior, 4 without. fp32 adds the prior's two subtractions (its exact
# offsets), p's split (3), the split of K and V shared by the block's
# 8 warps (1.5 a score) and the tile's FMA into O (0.5): 16 and 9.
LANE_OPS_PER_S = 128 * 132 * 1.98e9
SFU_PER_S = 16 * 132 * 1.98e9
OPS_PER_SCORE = {(True, torch.bfloat16): 9, (False, torch.bfloat16): 4,
                 (True, torch.float32): 16, (False, torch.float32): 9}

# decoder geometry of the flagship: B lines of 8 heads x 32, 900 queries;
# keys of the 128x1024 eval bucket (S=2720) and of the 128x1344 bench
# bucket (S=3570)
B, M, Q, D = 8, 8, 900, 32
# the detection step's CDN: dn_number 100 over 64 target slots is one group
# of 2 x 64 denoising queries before the 900, so the decoder runs 1028
DN_NUMBER, MAX_TARGETS = 100, 64
Q_DETECT = Q + 2 * MAX_TARGETS
LEVELS = {2720: ((16, 128), (8, 64), (4, 32), (2, 16)),
          3570: ((16, 168), (8, 84), (4, 42), (2, 21)),
          # the arch phase's five levels at 128x1024
          2728: ((16, 128), (8, 64), (4, 32), (2, 16), (1, 8))}
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
# the data phase: JAX's first batches of both recipes' batchers (written on
# the CPU by tests/test_torch_smoke_data.py), their seed (the entry points'
# default --seed) and count
DATA_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_data.npz")
DATA_SEED, DATA_BATCHES = 42, 4
DATA_FIELDS = ("labels", "valid", "valid_hw", "boxes")
# the sweep phase: JAX's evaluate --sweep on the fixture lines (the same
# test file), and each point's CER tolerance per dtype (the read phase's)
SWEEP_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_sweep.json")
SWEEP_TOL = {"float32": 0.01, "bfloat16": 0.02}
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


# the ddp phase: steps of each train step over two gloo ranks on the card
# and in one process; the reference of the two ranks is one process's
# steps on each rank's rows, combined as the global normalizers weight
# them: the first step's global loss and terms within DDP_REL relative,
# and its global gradient within DDP_REL of its norm (only the summation
# order differs); each child's time limit
DDP_STEPS, DDP_REL, DDP_CHILD_TIMEOUT = 3, 1e-5, 300
# that reference against one process on the whole batch: the loss within
# SHAPE_LOSS_REL relative and the gradient within SHAPE_GRAD_REL of its
# norm, about four times the largest distance read on an H100 (loss 9.5e-6
# detection, 3.3e-6 CTC; gradient 3.2e-5 and 5.5e-4 of the norm): the
# card's kernels sum 4 lines and 8 in other orders, and the step magnifies
# a rounding (the phase prints, beside it, how far one process moves when
# every weight moves one float32 ulp, and the two-stage selection's moves)
SHAPE_LOSS_REL, SHAPE_GRAD_REL = 1e-4, 2e-3
# the windowed encoder's resize backward, timed both ways
RESIZE_REPS = 20

# the pretrain phase: the config files and the scripts' options, the HWDB
# glyph bank and JAX's first batches on it (tests/test_torch_hwdb_synth.py),
# the leaves whose shape follows the class count
CONFIGS = os.path.join(REPO, "dtlr_tpu_torch", "configs")
HWDB_BANK = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_hwdb.gnt")
HWDB_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_hwdb_ref.json")
# scripts/round4_chain.sh:51-56, less its corpus files (the port reads the
# fixture's rendered lines) and its RSS limit (a TPU host's workaround)
ROUND4_OPTIONS = ["batch_size=8", "use_ema=True", "warmup_steps=200", "max_targets=64",
                  "data_aug_scales=[128]", "data_aug_max_size=1024", "image_w_max=1024",
                  "image_h_max=192", "synthetic_max_words=5", "eval_set_size=200",
                  "save_checkpoint_interval=20", "lr_drop=50000", "batch_norm_type=group",
                  "lr_backbone=1e-4", "dense_box_bias=True"]
CLASS_LEAVES = ["params/class_embed/fc/bias", "params/class_embed/fc/kernel",
                "params/enc_out_class_embed/fc/bias", "params/enc_out_class_embed/fc/kernel",
                "params/label_enc"]
EVAL_KEYS = {"cer", "nms_cer", "loss_CTC", "max_conf", "mean_max_conf", "nq@0.05", "nq@0.1",
             "nq@0.2", "nq@0.3", "p_gt_matched"}


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
        ref = 0.05 + 0.85 * torch.rand(B, nq, len(LEVELS[S]), 4, generator=gen, device=dev)
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


def attention_bytes(qh, kh, vh, key_bias, box, group=None):
    """Every input read once and the output written once."""
    tensors = ([qh, kh, vh, key_bias] + (list(box) if box is not None else [])
               + ([group] if group is not None else []))
    return (sum(t.numel() * t.element_size() for t in tensors)
            + qh.shape[0] * qh.shape[1] * qh.shape[2] * qh.shape[3] * 4)


def peak_bound(qh, kh, vh, key_bias, box, group=None):
    """The bytes against 2*B*M*(open pairs)*(2D + 8 with the prior)
    operations at the inputs' peak (``PEAK_FLOPS``: bf16 on the tensor
    cores, fp32 on the CUDA cores, the bound of the earlier fp32 kernel);
    a pair the mask blocks needs no work."""
    Bq, Mq, Qq, Dq = qh.shape
    flops = 2 * Bq * Mq * open_pairs(qh, kh, group) * (2 * Dq + (8 if box is not None else 0))
    t_ops = flops / PEAK_FLOPS[qh.dtype]
    t_bytes = attention_bytes(qh, kh, vh, key_bias, box, group) / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound(qh, kh, vh, key_bias, box, group=None):
    """Least time for the work. bf16: ``peak_bound``. fp32, whose
    accuracy the kernel keeps in 3xTF32: the largest of the three TF32
    products of both matrix products, 3 * 2*B*M*(open pairs)*2D at 495
    TFLOP/s, the per-score floor (``score_floor``) and the bytes."""
    if qh.dtype != torch.float32:
        return peak_bound(qh, kh, vh, key_bias, box, group)
    Bq, Mq, Qq, Dq = qh.shape
    t_ops = max(3 * 2 * Bq * Mq * open_pairs(qh, kh, group) * 2 * Dq / TF32_FLOPS,
                score_floor(qh, kh, box, group) / 1e3)
    t_bytes = attention_bytes(qh, kh, vh, key_bias, box, group) / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def score_floor(qh, kh, box, group=None):
    """Least time for the per-score work outside the products (see
    OPS_PER_SCORE): the CUDA cores' share against the SFUs' share."""
    scores = qh.shape[0] * qh.shape[1] * open_pairs(qh, kh, group)
    return 1e3 * max(scores * OPS_PER_SCORE[box is not None, qh.dtype] / LANE_OPS_PER_S,
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
    configs += [(name, S, Q, dt, True) for name, S in (("mha_box", 2720), ("mha", 900),
                                                       ("mha_box", 2728))
                for dt in (torch.float32, torch.bfloat16)]
    configs += [("mha_box", 2720, Q_DETECT, torch.bfloat16, True)]
    configs += [("mha_masked", Q_DETECT, Q_DETECT, dt, True)
                for dt in (torch.float32, torch.bfloat16)]
    # the fp32 kernel's key order: V rows that ramp over the key index
    # under peaked attention (see ramp_values), at S = 3570
    configs += [("mha_box", 3570, Q, torch.float32, "ramp")]
    rows = []
    for name, S, nq, dtype, strided in configs:
        prior = name == "mha_box"
        args = attention_inputs(S, dtype, prior, gen, bool(strided), nq)
        if S == nq:  # the self-attention pads no key
            args = args[:3] + (torch.zeros_like(args[3]), None)
        if name == "mha_masked":
            args = args + (detect_groups(),)
        if strided == "ramp":
            args = (args[0] * 4, args[1], ramp_values(args[2])) + args[3:]
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
        if dtype == torch.float32:
            row["cuda_core_bound_ms"] = peak_bound(*args)[0]
        if strided == "ramp":
            # what swapping each key pair's values does to the plain
            # version: the error a wrong pairing in P.V would show
            swapped = args[2].unflatten(2, (-1, 2)).flip(3).flatten(2, 3)
            row["values"] = "ramp"
            row["pair_swap_err"] = float((dense_reference(args[0], args[1], swapped, *args[3:])
                                          - ref).abs().max())
            ok = ok and row["pair_swap_err"] > 10 * TOL[dtype]
        if name == "mha_masked":
            row["blocks_with_whole_tiles_blocked"] = whole_tiles_blocked(args[5])
        rows.append(row)
        if not ok:
            emit({"phase": "kernels", "failed": row})
            raise AssertionError(f"{name} S={S} {dtype}: max abs err {err} > {TOL[dtype]}")
        del args, out, ref
        torch.cuda.empty_cache()
    return rows


def ramp_values(vh):
    """V rows that ramp over the key index, 0 to 1 across each 64-key tile,
    plus d/32 over the head dims (contiguous): the fp32 kernel reads V's
    rows in the order of the score fragment's key pairs, and a key or dim
    it paired with another's probability would move the output."""
    s = torch.arange(vh.shape[2], device=vh.device, dtype=torch.float32) % 64 / 63
    d = torch.arange(D, device=vh.device, dtype=torch.float32) / 32
    return (s[:, None] + d).expand(vh.shape).to(vh.dtype).contiguous()


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


def phase_train(card, data_hashes):
    """CTC finetuning on the card (see the module docstring)."""
    import tempfile

    from dtlr_tpu_torch.train import finetune

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
        del trainer, model
        torch.cuda.empty_cache()

        # the entry point a user runs: two steps through the recipe's
        # batcher, the save and the evaluation
        t1 = time.perf_counter()
        seen, unspy = spy_step_batches()
        try:
            cli = finetune.main(["--lines", LINES, "--pretrain_dir", PARAMS, "--full_model",
                                 "--output_dir", os.path.join(workdir, "cli"), "--epochs", "1",
                                 "--options", "max_iterations=2"])
        finally:
            unspy()
        torch.cuda.synchronize()
        record["entry_point"] = {
            "train": cli["train"], "eval": cli["eval"], "batch_sha256": seen,
            "batches_are_the_data_phase's": seen == data_hashes["finetune"][:len(seen)],
            "seconds": time.perf_counter() - t1}
        record["ok"] = (record["ok"] and len(seen) == 2
                        and record["entry_point"]["batches_are_the_data_phase's"]
                        and math.isfinite(cli["train"]["loss"]) and cli["train"]["skipped"] == 0
                        and math.isfinite(cli["eval"]["cer"]))
        emit(record)
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


def phase_detect(card, data_hashes):
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
        seen, unspy = spy_step_batches()
        try:
            cli = pretrain.main(["--params", DETECT_PARAMS, "--lines", DETECT_LINES,
                                 "--output_dir", os.path.join(workdir, "cli"), "--epochs", "1",
                                 "--steps_per_epoch", "2"])
        finally:
            unspy()
        torch.cuda.synchronize()
        record["entry_point"] = {
            "train": cli["train"], "eval": cli["eval"], "launches": dict(flash_mha.launches),
            "weights_saved": os.path.exists(cli["params"]), "batch_sha256": seen,
            "batches_are_the_data_phase's": seen == data_hashes["pretrain"][:len(seen)]}
        record["ok"] = (record["ok"] and record["entry_point"]["weights_saved"]
                        and math.isfinite(cli["eval"]["loss"])
                        and math.isfinite(cli["train"]["loss"]) and len(seen) == 2
                        and record["entry_point"]["batches_are_the_data_phase's"]
                        and flash_mha.launches["mha_masked"] == 2 * n_dec)
        record["seconds"] = time.perf_counter() - t0
        emit(record)
        torch.cuda.empty_cache()
    failed = [(r["compute_dtype"], r.get("step", "timed")) for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"detect phase checks failed: {failed} (steps: 0 is the first "
                             "against JAX's, 'timed' the 12 recipe steps and the entry point)")
    return records, launches


def batch_field_hashes(batch) -> dict:
    """sha256 of each array of a batch, as tests/test_torch_hwdb_synth.py
    hashes JAX's, and its texts."""
    import hashlib

    from dtlr_tpu_torch.train import engine

    a = engine.batch_to_arrays(batch)
    h = lambda x: hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
    return {"images": h(np.asarray(a["images"], np.uint8)), "labels": h(a["labels"]),
            "valid": h(a["valid"]), "valid_hw": h(a["valid_hw"]),
            "boxes": h(np.asarray(a["boxes"], np.float32)), "texts": list(a["texts"])}


def spy_timed_steps():
    """Wrap ``Trainer.step`` to time each step on the host clock with the
    card synchronized before and after, and to hash its batch; returns the
    list of records and the function that unwraps it."""
    from dtlr_tpu_torch.train import engine

    steps, orig = [], engine.Trainer.step

    def step(self, batch, mark=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = orig(self, batch, mark)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "batch": batch_field_hashes(batch)})
        return m

    engine.Trainer.step = step
    return steps, lambda: setattr(engine.Trainer, "step", orig)


def same_state(a, b) -> bool:
    """Equal exactly: tensors (on any device) bit for bit, containers key
    for key."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_state(a[k], b[k]) for k in a)
    return a == b


def sub_run(name, fn, expect):
    """One entry point's run: the attention launches it made (counts from
    0) against ``expect(result)``, its steps' ms, its peak memory."""
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps, unspy = spy_timed_steps()
    t0 = time.perf_counter()
    try:
        result = fn()
    finally:
        unspy()
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    want = expect(result, len(steps))
    ms = [s["ms"] for s in steps]
    record = {"phase": "pretrain", "run": name, "seconds": time.perf_counter() - t0,
              "steps": len(steps), "ms_per_step": ms,
              "ms_per_step_median": float(np.median(ms)) if ms else None,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "launches_expected": want, "ok": launches == want}
    return result, steps, record


def eval_forwards(result):
    """The eval forwards of a pretraining run: each evaluation of the
    held-out set, and the detection loss's at the end."""
    return sum(len(e["evals"]) for e in result["epochs"]) + ("eval" in result)


def phase_pretrain(card):
    """The training entry points from config files (see the module
    docstring)."""
    import shutil
    import tempfile

    from dtlr_tpu_torch.eval import evaluate
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.train import checkpoints as ckpt_lib
    from dtlr_tpu_torch.train import engine, finetune, pretrain

    n_dec = FLAGSHIP.dec_layers
    with open(HWDB_REF) as fh:
        hwdb_ref = json.load(fh)
    records = []
    with tempfile.TemporaryDirectory() as workdir:
        # (a) Latin from scratch, as scripts/round4_chain.sh ran it
        latin = ["-c", os.path.join(CONFIGS, "Latin_TPU.py"), "--lines", DETECT_LINES,
                 "--seed", "0", "--options", *ROUND4_OPTIONS]
        a_dir = os.path.join(workdir, "latin")
        eval_batches = 1  # the fixture's 8 lines, batch 8

        def latin_launches(res, steps):
            n_eval = eval_forwards(res) * eval_batches
            return {"mha_box": n_dec * (steps + n_eval), "mha": n_dec * n_eval,
                    "mha_masked": n_dec * steps}

        res, _, rec = sub_run("latin_scratch", lambda: pretrain.main(
            [*latin, "--output_dir", a_dir, "--epochs", "2", "--steps_per_epoch", "2",
             "--eval_every", "1"]), latin_launches)
        evals = [e for ep in res["epochs"] for e in ep["evals"]]
        losses = [ep["train"]["loss"] for ep in res["epochs"]] + [res["eval"]["loss"]]
        rec.update(train=[ep["train"] for ep in res["epochs"]], evals=evals,
                   detection_eval=res["eval"], card=card)
        rec["ok"] = (rec["ok"] and rec["steps"] == 4 and res["warm_start"] is None
                     and all(math.isfinite(x) for x in losses)
                     and [e["tag"] for e in evals] == ["eval", "eval_ema"] * 2
                     and all(EVAL_KEYS <= set(e) and "wer" in e for e in evals))
        records.append(rec)
        emit(rec)

        res, _, rec = sub_run("latin_warm_start_eval", lambda: pretrain.main(
            [*latin, "--output_dir", os.path.join(workdir, "latin_warm"), "--eval",
             "--warm_start_npz", DETECT_PARAMS]),
            lambda res, steps: {"mha_box": n_dec * eval_batches, "mha": n_dec * eval_batches,
                                "mha_masked": 0})
        rec.update(warm_start=res["warm_start"], evals=res["evals"], card=card)
        counts = {k: res["warm_start"][k] for k in ("copied", "fresh", "unused")}
        rec["ok"] = (rec["ok"] and counts == {"copied": 474, "fresh": 0, "unused": 0}
                     and EVAL_KEYS <= set(res["evals"][0]))
        records.append(rec)
        emit(rec)

        # (b) HWDB warm-started from the Latin trunk, as scripts/hwdb_real.sh
        root = os.path.join(workdir, "hwdb")
        os.makedirs(os.path.join(root, "HWDB_gnt"))
        shutil.copy(HWDB_BANK, os.path.join(root, "HWDB_gnt", "smoke_hwdb.gnt"))
        b_dir = os.path.join(workdir, "hwdb_run")
        hwdb = ["-c", os.path.join(CONFIGS, "Chinese_TPU.py"), "--dataset_file", "HWDB_synth",
                "--data_root", root, "--output_dir", b_dir, "--warm_start_npz", DETECT_PARAMS,
                "--steps_per_epoch", "3", "--eval_every", "1", "--seed", str(hwdb_ref["seed"]),
                "--options", *hwdb_ref["options"]]
        eval_batches = 2  # eval_set_size 8, batch 4

        def hwdb_launches(res, steps):
            n_eval = eval_forwards(res) * eval_batches
            return {"mha_box": n_dec * (steps + n_eval), "mha": n_dec * n_eval,
                    "mha_masked": n_dec * steps}

        res, steps, rec = sub_run("hwdb_warm_start", lambda: pretrain.main(
            [*hwdb, "--epochs", "1"]), hwdb_launches)
        seen = [s["batch"] for s in steps]
        evals = [e for ep in res["epochs"] for e in ep["evals"]]
        rec.update(warm_start=res["warm_start"], num_classes=res["num_classes"],
                   dn_labelbook_size=res["dn_labelbook_size"], evals=evals,
                   train=res["train"], detection_eval=res["eval"],
                   batches_equal_jax=[b == r for b, r in zip(seen, hwdb_ref["batches"])],
                   card=card)
        n = res["num_classes"]
        rec["ok"] = (rec["ok"] and rec["steps"] == 3
                     and res["warm_start"]["fresh_leaves"] == CLASS_LEAVES
                     and (res["warm_start"]["copied"], res["warm_start"]["fresh"]) == (469, 5)
                     and res["dn_labelbook_size"] == n and len(seen) == 3
                     and all(rec["batches_equal_jax"])
                     and math.isfinite(res["train"]["loss"]) and math.isfinite(res["eval"]["loss"])
                     and [e["tag"] for e in evals] == ["eval", "eval_ema"]
                     and all(EVAL_KEYS | {"ar", "cr"} <= set(e) for e in evals))
        records.append(rec)
        emit(rec)

        # the same command with a second epoch: it resumes the saved state
        saved = ckpt_lib.restore_checkpoint(os.path.join(b_dir, "checkpoint"))
        resumed = {}
        orig = engine.Trainer.try_resume

        def try_resume(self, name="checkpoint"):
            ok = orig(self, name)
            resumed["equal"] = all(same_state(v, saved[k])
                                   for k, v in self.checkpoint_state().items())
            return ok

        engine.Trainer.try_resume = try_resume
        try:
            res, _, rec = sub_run("hwdb_resume", lambda: pretrain.main(
                [*hwdb, "--epochs", "2"]), hwdb_launches)
        finally:
            engine.Trainer.try_resume = orig
        after = ckpt_lib.restore_checkpoint(os.path.join(b_dir, "checkpoint"))
        rec.update(resumed=res["resumed"], state_equal_saved=resumed.get("equal"),
                   epochs=[ep["epoch"] for ep in res["epochs"]], step_after=after["step"],
                   train=res["train"], card=card)
        rec["ok"] = (rec["ok"] and resumed.get("equal") is True
                     and (res["resumed"]["epoch"], res["resumed"]["step"]) == (1, 3)
                     and rec["epochs"] == [1] and after["step"] == 6 and after["epoch"] == 2
                     and math.isfinite(res["train"]["loss"]))
        records.append(rec)
        emit(rec)

        res, _, rec = sub_run("evaluate_hwdb", lambda: evaluate.main(
            ["--config", os.path.join(b_dir, "config_cfg.py"), "--ckpt_dir", b_dir,
             "--dataset", "HWDB_synth", "--mode", "val", "--data_root", root,
             "--metrics", "chinese", "--TH", "0.2", "--NMS", "0.5", "--max_images", "8"]),
            lambda res, steps: {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0})
        best = res["best"]["record"]
        rec.update(best=best, lines=res["lines"], lines_per_s=res["lines_per_s"], card=card)
        rec["ok"] = (rec["ok"] and res["lines"] == 8
                     and all(math.isfinite(best[k]) for k in ("AR", "CR")))
        records.append(rec)
        emit(rec)

        # (c) HWDB CTC finetune from (b)'s run, as scripts/round5_chain.sh
        def finetune_launches(res, steps):
            n_eval = 1 + eval_batches  # the first step's training CER, the held-out set
            return {"mha_box": n_dec * (steps + n_eval), "mha": n_dec * (steps + n_eval),
                    "mha_masked": 0}

        res, _, rec = sub_run("hwdb_finetune", lambda: finetune.main(
            ["-c", os.path.join(CONFIGS, "HWDB_full_TPU.py"), "--dataset_file", "HWDB_synth",
             "--data_root", root, "--pretrain_dir", b_dir,
             "--output_dir", os.path.join(workdir, "hwdb_ft"), "--epochs", "1", "--seed", "11",
             "--options", "max_iterations=2", "eval_epoch=1", *hwdb_ref["options"]]),
            finetune_launches)
        rec.update(train=res["train"], eval=res["eval"], card=card)
        rec["ok"] = (rec["ok"] and rec["steps"] == 2 and math.isfinite(res["train"]["loss_CTC"])
                     and math.isfinite(res["eval"]["loss_CTC"]) and "cer" in res["train"])
        records.append(rec)
        emit(rec)
    failed = [r["run"] for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"pretrain phase checks failed: {failed}")
    return records


# the deform phase: the reference's architecture (configs/Latin.py) from
# weights drawn by ``deform_weights``, held against the JAX package's
# reading of the fixture lines with the same weights
# (tests/test_torch_deform_fixture.py writes DEFORM_REF)
DEFORM_CONFIG = os.path.join(CONFIGS, "Latin.py")
DEFORM_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_deform_ref.npz")
DEFORM_SEED = 2024
#: the readings held against DEFORM_REF: (prefix, compute dtype, shared offsets)
DEFORM_VARIANTS = (("fp32", "float32", False), ("bf16", "bfloat16", False),
                   ("shared_fp32", "float32", True))
# round4_chain.sh's data options (ROUND4_OPTIONS less the architecture's)
DEFORM_DATA_OPTIONS = ["batch_size=8", "use_ema=True", "max_targets=64",
                       "data_aug_scales=[128]", "data_aug_max_size=1024", "image_w_max=1024",
                       "image_h_max=192", "eval_set_size=200"]


FLAGSHIP_CONFIG = os.path.join(REPO, "outputs", "finetune_r4b", "config_cfg.py")
WORDS = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_words.npz")
WORDS_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_words_ref.npz")
LM_CORPUS = os.path.join(REPO, "artifacts", "corpus_words_train.txt")
#: dtlr_tpu/ngram/synthetic_r4_words.yaml's settings (the committed train
#: corpus in place of its absent bigger one); the lexicon arm adds
#: synthetic_r4_words_lex.yaml's
NGRAM_SETTINGS = {"lm_corpus": LM_CORPUS, "lm_order": 6, "lm_smoothing": "stupid",
                  "lm_weight": 0.75, "logits_multiplier": 2.0, "beam": 16,
                  "skip_gated_words": True, "batch_size": 8}
NGRAM_LEXICON = {"lexicon_from_corpus": True, "lexicon_margin": 5.0}
NGRAM_SWEEP = "lm_weight=0.5,0.75"
#: the read gates of PERF.md section 2, on the strings against JAX's
NGRAM_TOL = {"float32": 0.01, "bfloat16": 0.02}
#: the datasets phase: a RIMES (JPEG) and an HWDB (PNG) layout of the
#: WORDS lines and the JAX package's readings of them, written by
#: tests/test_torch_datasets_fixture.py
DATASETS_ROOT = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_datasets")
DATASETS_REF = os.path.join(DATASETS_ROOT, "smoke_datasets_ref.json")
BACKBONES_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_backbones_ref.npz")
BACKBONES_CONFIG = os.path.join(CONFIGS, "Latin_TPU.py")
#: the datasets phase's other image forms: a Borg layout of TIFF lines and
#: progressive JPEG, Adam7 and 16-bit PNG, big-endian and bilevel TIFF
#: files, with PIL's pixel hashes and the JAX package's Borg strings,
#: written by tests/test_torch_forms_fixture.py
FORMS_ROOT = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_forms")
FORMS_REF = os.path.join(FORMS_ROOT, "smoke_forms_ref.json")
#: the arch phase: configs/Latin_TPU.py with the four architecture settings
#: changed (five feature levels, the decoder's cross-attention first, the
#: sine encodings' y temperature 10000), deform_weights' seeded stream;
#: the JAX package's fp32 readings of the fixture lines (eval, and train
#: mode at dropout 1.0), written by tests/test_torch_arch_fixture.py
ARCH_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_arch_ref.npz")
ARCH_OPTIONS = ["num_feature_levels=5", "decoder_module_seq=['ca','sa','ffn']",
                "pe_temperatureH=10000", "pe_temperatureW=20"]
#: the train-mode dropout of the arch phase's steps, and the 5-sigma bound
#: on each site's kept share
ARCH_DROPOUT, ARCH_STEPS = 0.1, 3
#: the data phase's rotated batches: the pretraining recipe's batcher over
#: the detection fixture with half the lines rotated by 10 degrees, and
#: JAX's first batches of it (tests/test_torch_rotate_fixture.py)
ROTATE_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_rotate_data.npz")
ROTATE_P, ROTATE_ANGLE = 0.5, 10.0
#: the snapshot: JAX's save_snapshot of committed arrays
#: (tests/test_torch_visualizer.py)
SNAPSHOT_REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_snapshot.npz")
#: the backbones held against JAX's reading, and the reference's own
#: large ones (dtlr_tpu/models/convnext.py:1-2), read and stepped only
BACKBONES_HELD = ("swin_T_224_1k", "convnext_tiny")
BACKBONES_LARGE = ("swin_L_224_22k", "convnext_xlarge_22k")


def backbone_config(backbone, compute_dtype="float32"):
    """configs/Latin_TPU.py's model (the flagship's windowed encoder and
    dense cross-attention with the box prior, hidden 256, 8 heads, 6 + 6
    layers, 900 queries) with ``backbone``, at ``compute_dtype``."""
    from dtlr_tpu_torch.train.config import load_settings

    _, cfg, _, _ = load_settings(BACKBONES_CONFIG, [f"backbone={backbone}"], "pretrain")
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def arch_config(compute_dtype="float32", dropout=0.0):
    """configs/Latin_TPU.py's model with ``ARCH_OPTIONS`` (five levels, the
    cross-attention first, the y temperature 10000) and ``dropout``, at
    ``compute_dtype``."""
    from dtlr_tpu_torch.train.config import load_settings

    _, cfg, _, _ = load_settings(BACKBONES_CONFIG, [*ARCH_OPTIONS, f"dropout={dropout}"],
                                 "pretrain")
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def deform_config(compute_dtype="float32", shared_offsets=False):
    """configs/Latin.py's model (hidden 256, 8 heads, 6 + 6 layers, 900
    queries, 4 levels x 4 points, deformable encoder and cross-attention,
    FrozenBN ResNet-50) at ``compute_dtype``."""
    from dtlr_tpu_torch.train.config import load_settings

    _, cfg, _, _ = load_settings(DEFORM_CONFIG, [], "pretrain")
    return dataclasses.replace(cfg, compute_dtype=compute_dtype, shared_offsets=shared_offsets)


def deform_weights(model_cfg, num_classes, seed=DEFORM_SEED):
    """Weights of ``model_cfg``'s model with ``num_classes`` classes (label
    book num_classes + 1) from one frozen numpy stream
    (``np.random.RandomState(seed)``), leaf by leaf in sorted key order,
    as a flat ``params/...`` tree in flax layouts. No leaf is zero:
    kernels normal(0, 1 / sqrt(fan_in)) (the class heads' 4 times that,
    so that their logits seldom tie), norm scales 1 + normal(0, 0.1),
    biases normal(0, 0.02), the sampling offsets' bias normal(0, 2)
    pixels, the embeddings, Swin's position bias tables and ConvNeXt's
    layer scales normal(0, 1), and FrozenBN statistics that are not the
    identity (scale 1 + normal(0, 0.1), bias and mean normal(0, 0.1), var
    uniform(0.5, 1.5))."""
    from dtlr_tpu_torch.train.torch_import import template

    cfg = dataclasses.replace(model_cfg, dn_labelbook_size=num_classes + 1)
    shapes = {k: v.shape for k, v in template(cfg, num_classes).items()}
    rng = np.random.RandomState(seed)
    tree = {}
    for key in sorted(shapes):
        shape, leaf = shapes[key], key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = (shape[0] if len(shape) == 3 and "/out_proj/" not in key
                      else int(np.prod(shape[:-1])))
            x = rng.normal(0.0, (4.0 if "class_embed" in key else 1.0) / math.sqrt(fan_in),
                           shape)
        elif "FrozenBatchNorm" in key:
            x = (rng.uniform(0.5, 1.5, shape) if leaf == "var"
                 else (leaf == "scale") + rng.normal(0.0, 0.1, shape))
        elif leaf == "scale":
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        elif leaf == "bias":
            x = rng.normal(0.0, 2.0 if "sampling_offsets" in key else 0.02, shape)
        else:  # level_embed, tgt_embed, label_enc, the tables, gamma
            x = rng.normal(0.0, 1.0, shape)
        tree[key] = x.astype(np.float32)
    return tree


def tree_sha256(tree) -> str:
    """sha256 over a flat tree's sorted keys, shapes and float32 bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(str(np.shape(tree[k])).encode())
        h.update(np.ascontiguousarray(tree[k], np.float32).tobytes())
    return h.hexdigest()


def deform_reference(ref, prefix):
    """One of DEFORM_REF's readings in ``agreement``'s ``jax_*`` names."""
    out = {}
    for k in ("greedy", "nms", "pred_boxes", "max_logit", "anchors", "interm_max_logit"):
        v = ref[f"{prefix}_{k}"]
        out[f"jax_{k}"] = [str(s) for s in v] if v.dtype.kind == "U" else v
    return out


def capture_sampler_inputs(model, images, valid_hw):
    """The sampling core's function and inputs at its first encoder call
    and its first decoder call of one forward (copies on the card)."""
    from dtlr_tpu_torch.eval.evaluate import forward_lines
    from dtlr_tpu_torch.models import layers

    seen, orig = {}, {n: getattr(layers, n) for n in ("deform_attn", "deform_attn_shared")}

    def spy(name):
        def core(value, shapes, loc, attn, *rest):
            where = "encoder" if loc.shape[1] == value.shape[1] else "decoder"
            seen.setdefault(where, (orig[name], (value.detach().clone(), shapes,
                                                 loc.detach().clone(), attn.detach().clone(),
                                                 *rest)))
            return orig[name](value, shapes, loc, attn, *rest)
        return core

    for name in orig:
        setattr(layers, name, spy(name))
    try:
        forward_lines(model, images, valid_hw)
    finally:
        for name, fn in orig.items():
            setattr(layers, name, fn)
    return seen


def sampler_bytes(value, loc, attn):
    """The bytes the core must move: each input read once, the float32
    (B, Lq, C) output written once."""
    out = loc.shape[0] * loc.shape[1] * value[0, 0].numel() * 4
    return sum(t.numel() * t.element_size() for t in (value, loc, attn)) + out


def deform_read(card, variant, compute_dtype, shared, lines, ref, num_classes):
    """One reading of the fixture lines by Latin.py's model (see the
    module docstring): agreement with JAX's reading ``variant`` of
    DEFORM_REF, the launches per forward, lines/s, peak memory and the
    sampling core's ms per layer."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import (agreement, forward_lines, model_from_tree,
                                              read_lines)
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    cfg = deform_config(compute_dtype, shared)
    tree = deform_weights(cfg, num_classes)
    digest = tree_sha256(tree)
    if digest != str(ref[f"{variant}_weights_sha256"]):
        raise AssertionError(f"{variant}: the seeded weights hash {digest}, the reference "
                             f"was read with {ref[f'{variant}_weights_sha256']}")
    model = model_from_tree(tree, cfg, "cuda")
    th, nms = (float(x) for x in lines["nms_point"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    peak = torch.cuda.max_memory_allocated()
    n_dec = cfg.dec_layers
    jax_ref = deform_reference(ref, variant)
    agree = agreement(res, jax_ref)
    record = {"phase": "deform", "part": "read", "variant": variant,
              "compute_dtype": compute_dtype, "shared_offsets": shared,
              "launches_per_forward": launches, **agree,
              "greedy_lengths": [len(s) for s in res["greedy"]],
              "jax_greedy_lengths": [len(s) for s in jax_ref["jax_greedy"]],
              "nms_lengths": [len(s) for s in res["nms"]],
              "finite": all(np.isfinite(res[k]).all() for k in ("pred_boxes", "max_logit"))}
    if compute_dtype == "float32":
        # random weights read every query as a character (900-character
        # greedy strings) from near-tied logits, so a swapped proposal
        # moves its line's strings by more than a trained model's: the
        # strings are held on the lines whose selection is JAX's, the
        # swapped lines by their score gap
        same = (np.abs(res["anchors"] - jax_ref["jax_anchors"]).max(-1) < 1e-6).all(-1)
        cer_same = {k: metrics.mean_cer([s for s, m in zip(res[k], same) if m],
                                        [s for s, m in zip(jax_ref[f"jax_{k}"], same) if m])
                    for k in ("greedy", "nms")} if same.any() else None
        record.update(box_tol=BOX_TOL, logit_tol=MAX_LOGIT_TOL, swap_gap_tol=SWAP_GAP_TOL,
                      cer_tol=CER_VS_JAX, cer_vs_ref_same_selection=cer_same)
        ok = (agree["lines_compared"] >= 1 and agree["max_pred_boxes_err"] <= BOX_TOL
              and agree["max_logit_err"] <= MAX_LOGIT_TOL
              and agree["max_swap_score_gap"] <= SWAP_GAP_TOL
              and max(cer_same.values()) <= CER_VS_JAX)
    else:
        # JAX's own fp32-to-bf16 spread of these strings, from DEFORM_REF
        spread = {k: float(ref[f"jax_bf16_vs_fp32_cer_{k}"]) for k in ("greedy", "nms")}
        tol = {k: max(CER_VS_JAX_BF16, 2 * spread[k]) for k in spread}
        record.update(jax_bf16_vs_fp32_cer=spread, cer_tol=tol,
                      swap_gap_tol=SWAP_GAP_TOL_BF16)
        ok = (all(agree["cer_vs_ref"][k] <= tol[k] for k in tol)
              and agree["max_swap_score_gap"] <= SWAP_GAP_TOL_BF16)
    ok = ok and record["finite"] and launches == {"mha_box": 0, "mha": n_dec, "mha_masked": 0}
    if not ok:
        emit({**record, "failed": True})
        raise AssertionError(f"deform {variant}: the port's reading disagrees with the JAX "
                             "package's, or launched other kernels")

    images, valid_hw = lines["images"], lines["valid_hw"]
    fwd_ms = cuda_ms(lambda: forward_lines(model, images, valid_hw), calls=1, runs=5,
                     warmup=2)
    sampler = {}
    for where, (core, args) in capture_sampler_inputs(model, images, valid_hw).items():
        value, _, loc, attn = args[:4]
        ms = cuda_ms(lambda: core(*args), calls=5, runs=5, warmup=1)
        sampler[where] = {"ms_per_layer": ms, "Lq": loc.shape[1], "S": value.shape[1],
                          "bytes_bound_ms": sampler_bytes(value, loc, attn) / MEM_BYTES_PER_S
                          * 1e3}
    record.update(forward_ms_per_batch=fwd_ms, batch=len(images),
                  lines_per_s=len(images) / (fwd_ms / 1e3), peak_memory_bytes=peak,
                  sampler=sampler, card=card)
    return record, res, tree, model


def frozen_equal_to_fresh(state: dict) -> bool:
    """Every FrozenBN leaf of a train state's parameters and EMA is its
    fresh value, bit for bit: scale and var one, bias and mean zero."""
    ok = True
    for key in ("params", "ema_params"):
        for name, t in (state.get(key) or {}).items():
            if "FrozenBatchNorm" in name:
                want = 1.0 if name.endswith((".weight", ".var")) else 0.0
                ok = ok and bool(torch.equal(t.cpu(), torch.full_like(t.cpu(), want)))
    return ok and state.get("ema_params") is not None


def phase_deform(card):
    """The reference-faithful path (see the module docstring)."""
    import shutil
    import tempfile

    from dtlr_tpu_torch.eval import evaluate
    from dtlr_tpu_torch.eval.evaluate import load_lines, model_from_tree, read_lines
    from dtlr_tpu_torch.train import checkpoints as ckpt_lib
    from dtlr_tpu_torch.train import finetune, pretrain
    from dtlr_tpu_torch.train.config import load_settings
    from dtlr_tpu_torch.train.torch_import import load_params_file, save_torch_checkpoint

    lines = load_lines(LINES)
    num_classes = len(lines["charset"])
    n_dec = deform_config().dec_layers
    records, launches = [], {}
    with np.load(DEFORM_REF) as npz:
        ref = {k: npz[k] for k in npz.files}

    # (a) the forward against JAX's reading, fp32, bf16 and shared offsets
    for variant, compute_dtype, shared in DEFORM_VARIANTS:
        t0 = time.perf_counter()
        record, res, tree, model = deform_read(card, variant, compute_dtype, shared, lines,
                                               ref, num_classes)
        launches[variant] = record["launches_per_forward"]
        record["seconds"] = time.perf_counter() - t0
        emit(record)
        records.append(record)
        if variant == "fp32":
            fp32 = (res, tree)
        del model
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        # (b) the weights through a reference-named .pth into a fresh model
        t0 = time.perf_counter()
        res, tree = fp32
        pth = os.path.join(workdir, "reference.pth")
        cfg = deform_config("float32")
        save_torch_checkpoint(tree, pth, cfg.nheads)
        loaded = load_params_file(pth, cfg)
        model = model_from_tree(loaded, cfg, "cuda")
        th, nms = (float(x) for x in lines["nms_point"])
        again = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
        record = {"phase": "deform", "part": "pth_round_trip", "bytes": os.path.getsize(pth),
                  "tree_equal": set(loaded) == set(tree)
                  and all(np.array_equal(loaded[k], tree[k]) for k in tree),
                  "outputs_equal": all(np.array_equal(again[k], res[k]) for k in
                                       ("pred_boxes", "max_logit", "anchors"))
                  and again["greedy"] == res["greedy"] and again["nms"] == res["nms"],
                  "seconds": time.perf_counter() - t0}
        emit(record)
        records.append(record)
        del model
        torch.cuda.empty_cache()
        if not (record["tree_equal"] and record["outputs_equal"]):
            raise AssertionError("deform: the .pth round trip does not read the lines alike")

        # (c) pretraining Latin.py from scratch, with CDN
        c_dir = os.path.join(workdir, "latin")

        def pretrain_launches(res, steps):
            n_eval = eval_forwards(res)  # the fixture's 8 lines, batch 8
            return {"mha_box": 0, "mha": n_dec * n_eval, "mha_masked": n_dec * steps}

        res, _, rec = sub_run("deform_latin_scratch", lambda: pretrain.main(
            ["-c", DEFORM_CONFIG, "--lines", DETECT_LINES, "--seed", "0", "--output_dir", c_dir,
             "--epochs", "2", "--steps_per_epoch", "2", "--eval_every", "1",
             "--options", *DEFORM_DATA_OPTIONS]), pretrain_launches)
        state = ckpt_lib.restore_checkpoint(os.path.join(c_dir, "checkpoint"))
        losses = [ep["train"]["loss"] for ep in res["epochs"]] + [res["eval"]["loss"]]
        rec.update(phase="deform", train=[ep["train"] for ep in res["epochs"]],
                   detection_eval=res["eval"], frozen_unchanged=frozen_equal_to_fresh(state),
                   card=card)
        rec["ok"] = (rec["ok"] and rec["steps"] == 4 and all(math.isfinite(x) for x in losses)
                     and all(ep["train"].get("skipped", 0) == 0 for ep in res["epochs"])
                     and rec["frozen_unchanged"] and state["step"] == 4)
        records.append(rec)
        emit(rec)

        # (d) the CTC finetune from (c)'s run and evaluate, as
        # scripts/finetuning/IAM.sh and scripts/evaluating/IAM.sh
        ctc_cfg = os.path.join(CONFIGS, "Latin_CTC.py")
        batch = load_settings(ctc_cfg, [], "ctc")[0].batch_size
        eval_batches = -(-len(lines["images"]) // batch)
        d_dir = os.path.join(workdir, "latin_ctc")

        def finetune_launches(res, steps):
            n_eval = 1 + eval_batches  # the first step's training CER, the held-out set
            return {"mha_box": 0, "mha": n_dec * (steps + n_eval), "mha_masked": 0}

        res, _, rec = sub_run("deform_ctc_finetune", lambda: finetune.main(
            ["-c", ctc_cfg, "--lines", LINES, "--pretrain_dir", c_dir, "--new_class_embedding",
             "--smart_mapping", "--output_dir", d_dir, "--epochs", "1", "--seed", "11",
             "--options", "max_iterations=2", "eval_epoch=1"]), finetune_launches)
        rec.update(phase="deform", train=res["train"], eval=res["eval"], card=card)
        rec["ok"] = (rec["ok"] and rec["steps"] == 2 and math.isfinite(res["train"]["loss_CTC"])
                     and math.isfinite(res["eval"]["loss_CTC"]))
        records.append(rec)
        emit(rec)

        res, _, rec = sub_run("deform_evaluate", lambda: evaluate.main(
            ["--config", ctc_cfg, "--ckpt_dir", d_dir, "--lines", LINES, "--NMS", "0.5",
             "--TH", "0.3"]), lambda res, steps: {"mha_box": 0, "mha": n_dec, "mha_masked": 0})
        best = res["best"]["record"]
        rec.update(phase="deform", best=best, lines=res["lines"],
                   lines_per_s=res["lines_per_s"], card=card)
        rec["ok"] = rec["ok"] and res["lines"] == 8 and math.isfinite(best["CER"])
        records.append(rec)
        emit(rec)

        # (e) Chinese.py on the HWDB stream of the committed bank, as
        # scripts/pretraining/Synthetic_chinese.sh (no CDN)
        with open(HWDB_REF) as fh:
            hwdb_ref = json.load(fh)
        root = os.path.join(workdir, "hwdb")
        os.makedirs(os.path.join(root, "HWDB_gnt"))
        shutil.copy(HWDB_BANK, os.path.join(root, "HWDB_gnt", "smoke_hwdb.gnt"))
        res, _, rec = sub_run("deform_hwdb_pretrain", lambda: pretrain.main(
            ["-c", os.path.join(CONFIGS, "Chinese.py"), "--dataset_file", "HWDB_synth",
             "--data_root", root, "--output_dir", os.path.join(workdir, "hwdb_run"),
             "--epochs", "1", "--steps_per_epoch", "2", "--eval_every", "100",
             "--seed", str(hwdb_ref["seed"]), "--options", *hwdb_ref["options"]]),
            lambda res, steps: {"mha_box": 0, "mha": n_dec * (steps + 2 * ("eval" in res)),
                                "mha_masked": 0})
        rec.update(phase="deform", train=res["train"], detection_eval=res["eval"],
                   num_classes=res["num_classes"], card=card)
        rec["ok"] = (rec["ok"] and rec["steps"] == 2 and math.isfinite(res["train"]["loss"])
                     and res["train"].get("skipped", 0) == 0)
        records.append(rec)
        emit(rec)
    failed = [r.get("run", r.get("variant", r.get("part"))) for r in records
              if r.get("ok") is False]
    if failed:
        raise AssertionError(f"deform phase checks failed: {failed}")
    for r in records:
        if "run" in r:
            launches[r["run"]] = r["launches"]
    return records, launches


def image_sha256(images) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(images, np.uint8).tobytes()).hexdigest()


def recipe_batcher(recipe):
    """The batcher an entry point builds for ``recipe`` ("finetune" or
    "pretrain") over its fixture lines, with the entry points' seed."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import NpzLines, dataset_iter
    from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION

    cfg, path = (RECIPE, LINES) if recipe == "finetune" else (RECIPE_DETECTION, DETECT_LINES)
    ds = NpzLines(path)
    return make_batcher(cfg, dataset_iter(ds), True, DATA_SEED, ds.charset.index(" "),
                        reuse=cfg.reuse, erasing=cfg.truly_random_erasing)


def rotate_batcher_kwargs(charset):
    """The pretraining recipe's batcher settings (make_batcher's, reuse
    pool included) with ROTATE_P of the lines rotated by ROTATE_ANGLE."""
    from dtlr_tpu_torch.train.config import RECIPE_DETECTION as cfg

    return dict(batch_size=cfg.batch_size, scales=list(cfg.data_aug_scales),
                max_size=cfg.data_aug_max_size, max_targets=cfg.max_targets,
                w_max=cfg.image_w_max, h_quant=cfg.h_quant, h_max=cfg.image_h_max, train=True,
                space_label=charset.index(" "), seed=DATA_SEED,
                transfer_uint8=cfg.transfer_uint8, reuse=cfg.reuse, rotate_p=ROTATE_P,
                rotate_angle=ROTATE_ANGLE)


def phase_data():
    """The recipes' first batches made on this host against JAX's
    committed ones (see the module docstring); the image hashes per recipe
    for the entry points' checks."""
    t0 = time.perf_counter()
    ref = np.load(DATA_REF)
    record = {"phase": "data", "numpy": np.__version__,
              "numpy_of_reference": str(ref["numpy_version"][0]), "recipes": {}}
    hashes = {}
    for recipe in ("finetune", "pretrain"):
        batcher = recipe_batcher(recipe)
        batches, ms = [], []
        for _ in range(DATA_BATCHES):  # the worker's own call, in this thread
            t1 = time.perf_counter()
            batches.append(batcher._make_batch())
            ms.append((time.perf_counter() - t1) * 1e3)
        got = [image_sha256(b.images) for b in batches]
        want = [str(h) for h in ref[f"{recipe}_images_sha256"]]
        fields = {f: bool(np.array_equal(np.stack([getattr(b, f) for b in batches]),
                                         ref[f"{recipe}_{f}"])) for f in DATA_FIELDS}
        record["recipes"][recipe] = {
            "images_equal": [g == w for g, w in zip(got, want)], "fields_equal": fields,
            "shapes": [list(b.images.shape) for b in batches], "dtype": str(batches[0].images.dtype),
            "ms_per_batch": ms, "lines_per_s": len(batches[0].texts) / (np.median(ms) / 1e3)}
        hashes[recipe] = got
    # the pretraining recipe with the rotation on, against ROTATE_REF
    from dtlr_tpu_torch.data.batching import BucketBatcher
    from dtlr_tpu_torch.data.loaders import NpzLines, dataset_iter

    ds = NpzLines(DETECT_LINES)
    batcher = BucketBatcher(dataset_iter(ds), **rotate_batcher_kwargs(ds.charset))
    batches, ms = [], []
    for _ in range(DATA_BATCHES):
        t1 = time.perf_counter()
        batches.append(batcher._make_batch())
        ms.append((time.perf_counter() - t1) * 1e3)
    with np.load(ROTATE_REF) as rot:
        record["recipes"]["pretrain_rotate"] = {
            "rotate_p": ROTATE_P, "rotate_angle": ROTATE_ANGLE,
            "images_equal": [image_sha256(b.images) == str(w)
                             for b, w in zip(batches, rot["images_sha256"])],
            "fields_equal": {f: bool(np.array_equal(np.stack([getattr(b, f) for b in batches]),
                                                    rot[f])) for f in DATA_FIELDS},
            "shapes": [list(b.images.shape) for b in batches], "ms_per_batch": ms,
            "lines_per_s": len(batches[0].texts) / (np.median(ms) / 1e3)}
    record["ok"] = all(all(r["images_equal"]) and all(r["fields_equal"].values())
                       for r in record["recipes"].values())
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    if not record["ok"]:
        raise AssertionError("the port's batches differ from the JAX package's committed ones "
                             f"(numpy {np.__version__} here, {record['numpy_of_reference']} there)")
    return hashes


def spy_step_batches():
    """Wrap ``Trainer.step`` to record the sha256 of each batch's images;
    returns the list and the function that unwraps it."""
    from dtlr_tpu_torch.train import engine

    seen, orig = [], engine.Trainer.step

    def step(self, batch, mark=None):
        seen.append(image_sha256(engine.batch_to_arrays(batch)["images"]))
        return orig(self, batch, mark)

    engine.Trainer.step = step
    return seen, lambda: setattr(engine.Trainer, "step", orig)


def sweep_timings(res):
    """The forward's ms per batch, the NMS masks' ms per NMS value and
    batch, the decode's ms per grid point, and lines/s of one sweep."""
    t = res["timings"]
    stat = lambda v: {"median": float(np.median(v)), "max": float(np.max(v)), "count": len(v)}
    return {"forward_ms_per_batch": t["forward_ms"], "nms_ms_per_value_and_batch": stat(t["nms_ms"]),
            "decode_ms_per_point": stat(t["decode_ms"]), "sweep_seconds": res["seconds"],
            "lines_per_s": res["lines_per_s"]}


def phase_sweep(card):
    """The evaluate entry point's sweep in float32 and bfloat16 against
    JAX's committed grid (see the module docstring), each run twice: the
    first call builds the model and meets the card cold, the second is the
    same command again."""
    import tempfile

    from dtlr_tpu_torch.eval import evaluate
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    with open(SWEEP_REF) as fh:
        ref = json.load(fh)
    records, launches = [], {}
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        want = {(r["TH"], r["NMS"]): r for r in ref[dt]["records"]}
        record = {"phase": "sweep", "compute_dtype": dt, "jax_points": len(want),
                  "jax_skipped": len(ref[dt]["skipped"]), "jax_empty_th": ref[dt]["empty_th"],
                  "jax_best": ref[dt]["best"], "tol": SWEEP_TOL[dt], "runs": [], "card": card}
        ok = True
        for _ in range(2):
            with tempfile.TemporaryDirectory() as out_dir:
                reset_launches()
                res = evaluate.main(["--params", PARAMS, "--lines", LINES, "--sweep",
                                     "--compute_dtype", dt, "--out_dir", out_dir])
                torch.cuda.synchronize()
                launches[dt] = dict(flash_mha.launches)
                files = sorted(os.listdir(out_dir))
            got = {(r["TH"], r["NMS"]): r for r in res["records"]}
            common = sorted(set(want) & set(got))
            err = max(abs(got[k]["CER"] - want[k]["CER"]) for k in common)
            best_err = abs(res["best"]["record"]["CER"] - ref[dt]["best"]["CER"])
            n_batches = len(res["timings"]["forward_ms"])
            run = {"lines": res["lines"], "batches": n_batches, "points": len(got),
                   "skipped": len(res["skipped"]), "empty_th": res["empty_th"],
                   "max_cer_err": err, "best": res["best"]["record"], "best_cer_err": best_err,
                   "files": files, "launches": launches[dt], **sweep_timings(res)}
            n_dec = FLAGSHIP.dec_layers
            ok = (ok and len(common) == len(want) == len(got) and err <= SWEEP_TOL[dt]
                  and best_err <= SWEEP_TOL[dt]
                  and {"preds.txt", "gts.txt", "char_cer_impact.txt", "stats.json"} <= set(files)
                  and launches[dt] == {"mha_box": n_dec * n_batches, "mha": n_dec * n_batches,
                                       "mha_masked": 0})
            record["runs"].append(run)
        record["ok"] = ok
        record["seconds"] = time.perf_counter() - t0
        records.append(record)
        emit(record)
        torch.cuda.empty_cache()
    failed = [r["compute_dtype"] for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"sweep phase checks failed: {failed}")
    return records, launches


#: the datasets phase's read gates on the strings against JAX's (PERF.md
#: section 2, as the ngram phase's)
DATASETS_TOL = {"float32": 0.01, "bfloat16": 0.02}
#: fixture lines timed through the plain decoders, per format
PLAIN_DECODES = 2


def build_native():
    """csrc/native.cpp built with this host's compiler (the data phase's
    batchers already load it): seconds and the compiler's version."""
    from dtlr_tpu_torch.ops import _build
    from dtlr_tpu_torch.runtime import native

    built = _build.build_host(native.SOURCE)
    version = subprocess.run([_build.host_compiler(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    return {"seconds": built["seconds"], "compiler": version, "flags": list(_build.HOST_FLAGS)}


def fixture_formats(ref):
    """The fixture's files by format: RIMES lines 0-7 RGB 4:2:0 JPEG, 8-15
    gray JPEG; HWDB lines 0-7 gray PNG, 8-15 RGB PNG."""
    formats = {}
    for rel in ref["pixels_sha256"]:
        k = int(os.path.splitext(os.path.basename(rel))[0].removeprefix("line"))
        fmt = (("jpeg_rgb_420" if k < 8 else "jpeg_gray") if rel.endswith(".jpg")
               else ("png_gray" if k < 8 else "png_rgb"))
        formats.setdefault(fmt, []).append(rel)
    return formats


def stat_ms(values):
    return {"median": float(np.median(values)), "max": float(np.max(values)),
            "count": len(values)} if values else None


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def string_pairs():
    """The sweep fixture's strings paired: each JAX reading of
    smoke_lines.npz (greedy, NMS) with its text, and every text with
    every other, as characters and as words."""
    with np.load(LINES) as z:
        texts = [str(t) for t in z["texts"]]
        readings = [str(t) for k in ("jax_greedy", "jax_nms") for t in z[k]]
    pairs = list(zip(readings, texts + texts)) + [(a, b) for a in texts for b in texts]
    return [(list(a), list(b)) for a, b in pairs] + [(a.split(" "), b.split(" "))
                                                     for a, b in pairs]


def datasets_host(ref, native_build):
    """(a): the decoders against PIL's hashes, the native functions against
    their plain versions, each one's ms."""
    from dtlr_tpu_torch.data import images
    from dtlr_tpu_torch.data.batching import normalize_plain
    from dtlr_tpu_torch.data.transforms import _upscale
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.runtime import native

    bad, decode, lines = [], {}, []
    for fmt, rels in fixture_formats(ref).items():
        nat, plain = [], []
        for j, rel in enumerate(rels):
            with open(os.path.join(DATASETS_ROOT, rel), "rb") as fh:
                data = fh.read()
            rgb, ms = timed(images.decode_image, data)
            nat.append(ms)
            if image_sha256(rgb) != ref["pixels_sha256"][rel]:
                bad.append(rel)
            if j < PLAIN_DECODES:
                slow, ms = timed(images.decode_image, data, False)
                plain.append(ms)
                if not np.array_equal(slow, rgb):
                    bad.append(f"{rel} (plain)")
            lines.append(rgb.astype(np.float32) / 255.0)
        decode[fmt] = {"lines": len(rels), "native_ms_per_line": stat_ms(nat),
                       "plain_ms_per_line": stat_ms(plain)}
    pairs = string_pairs()
    funcs = {"levenshtein": (native.levenshtein, metrics.levenshtein_plain),
             "edit_operations": (native.edit_ops, metrics.edit_operations_plain)}
    per_call, unequal = {}, []
    for name, (fast, slow) in funcs.items():
        t_fast, t_slow = [], []
        for a, b in pairs:
            x, ms_fast = timed(fast, a, b)
            y, ms_slow = timed(slow, a, b)
            t_fast.append(ms_fast * 1e3)
            t_slow.append(ms_slow * 1e3)
            if x != y:
                unequal.append((name, "".join(a), "".join(b)))
        per_call[name] = {"native_us": stat_ms(t_fast), "plain_us": stat_ms(t_slow)}
    up_fast, up_slow, norm_fast, norm_slow, pixels = [], [], [], [], 0
    for img in lines:
        h, w = img.shape[:2]
        oh, ow = 128, round(w * 128 / h)
        x, ms_fast = timed(native.resize_bilinear, img, oh, ow)
        y, ms_slow = timed(_upscale, img, oh, ow)
        up_fast.append(ms_fast)
        up_slow.append(ms_slow)
        dst = np.zeros((128, 1024, 3), np.float32)
        _, ms_fast = timed(native.normalize_into, x[:, :1024], dst)
        z, ms_slow = timed(normalize_plain, x[:, :1024])
        norm_fast.append(ms_fast)
        norm_slow.append(ms_slow)
        pixels += int((x != y).sum()) + int((dst[:, :z.shape[1]] != z).sum())
    rec = {"phase": "datasets", "part": "host", "native_build": native_build,
           "pixels_sha256_mismatched": bad, "decode": decode,
           "string_pairs": len(pairs), "unequal_to_plain": unequal[:5], "per_call": per_call,
           "upscale_ms": {"native": stat_ms(up_fast), "plain": stat_ms(up_slow)},
           "normalize_ms": {"native": stat_ms(norm_fast), "plain": stat_ms(norm_slow)},
           "resize_and_normalize_pixels_differing": pixels}
    rec["ok"] = not bad and not unequal and pixels == 0
    return rec


def datasets_evaluate(card, ref, names=("RIMES", "HWDB"), root=DATASETS_ROOT):
    """(b): the evaluate entry point on each layout's test split in fp32
    and bf16 against JAX's strings; launches per forward."""
    import tempfile

    from dtlr_tpu_torch.eval import evaluate, metrics
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    records, launches = [], {}
    for name in names:
        want = ref["evaluate"][name]
        for dt in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            reset_launches()
            with tempfile.TemporaryDirectory() as out_dir:
                res = evaluate.main(["--params", PARAMS, "--config", FLAGSHIP_CONFIG,
                                     "--dataset", name, "--data_root", root,
                                     "--mode", "test", "--compute_dtype", dt,
                                     "--out_dir", out_dir])
            torch.cuda.synchronize()
            got = dict(flash_mha.launches)
            launches[f"datasets_{name}_{dt}"] = got
            n_batches = len(res["timings"]["forward_ms"])
            n = FLAGSHIP.dec_layers * n_batches
            preds, jax_preds = res["best"]["preds"], want[dt]["strings"]
            cer = metrics.mean_cer(preds, jax_preds) if len(preds) == len(jax_preds) else 1.0
            rec = {"phase": "datasets", "part": "evaluate", "dataset": name,
                   "compute_dtype": dt, "lines": res["lines"], "batches": n_batches,
                   "cer_vs_jax": cer, "tol": DATASETS_TOL[dt],
                   "lines_differing": sum(a != b for a, b in zip(preds, jax_preds)),
                   "cer_vs_texts": metrics.corpus_cer(preds, want["texts"]),
                   "jax_cer_vs_texts": want[dt]["cer_vs_texts"], "launches": got,
                   "forward_ms_per_batch": res["timings"]["forward_ms"],
                   "lines_per_s": res["lines_per_s"], "seconds": time.perf_counter() - t0,
                   "card": card}
            rec["ok"] = (res["best"]["gts"] == want["texts"] and cer <= DATASETS_TOL[dt]
                         and got == {"mha_box": n, "mha": n, "mha_masked": 0})
            records.append(rec)
            emit(rec)
    return records, launches


def datasets_finetune(card, ref, workdir):
    """(c): two CTC steps of the finetune entry point on the RIMES layout
    from the flagship, the batches JAX's; the decode's share of the
    host's batch time."""
    from dtlr_tpu_torch.data import batching, loaders
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches
    from dtlr_tpu_torch.train import finetune

    decode_ms, batch_ms = [], []
    load_image, make_batch = loaders.load_image, batching.BucketBatcher._make_batch

    def timed_load(path):
        out, ms = timed(load_image, path)
        decode_ms.append(ms)
        return out

    def timed_batch(self):
        out, ms = timed(make_batch, self)
        batch_ms.append(ms)
        return out

    loaders.load_image, batching.BucketBatcher._make_batch = timed_load, timed_batch
    steps, unspy = spy_timed_steps()
    reset_launches()
    t0 = time.perf_counter()
    try:
        cli = finetune.main(["--dataset_file", "RIMES", "--data_root", DATASETS_ROOT,
                             "--pretrain_dir", PARAMS, "--full_model", "--output_dir",
                             os.path.join(workdir, "rimes_ft"), "--epochs", "1",
                             "--options", "max_iterations=2"])
    finally:
        unspy()
        loaders.load_image, batching.BucketBatcher._make_batch = load_image, make_batch
    torch.cuda.synchronize()
    got = dict(flash_mha.launches)
    hashes = [s["batch"]["images"] for s in steps]
    # the steps, the first step's training CER and the val split's one batch
    n = FLAGSHIP.dec_layers * (len(steps) + 2)
    rec = {"phase": "datasets", "part": "finetune", "train": cli["train"], "eval": cli["eval"],
           "batch_sha256": hashes,
           "batches_are_jaxs": hashes == ref["finetune_batches_sha256"],
           "ms_per_step": [s["ms"] for s in steps], "launches": got,
           "decode_ms": sum(decode_ms), "host_batch_ms": sum(batch_ms),
           "batches_made": len(batch_ms), "lines_decoded": len(decode_ms),
           "decode_share_of_host_batch_time": sum(decode_ms) / max(sum(batch_ms), 1e-9),
           "seconds": time.perf_counter() - t0, "card": card}
    rec["ok"] = (len(steps) == 2 and rec["batches_are_jaxs"]
                 and math.isfinite(cli["train"]["loss"]) and cli["train"]["skipped"] == 0
                 and math.isfinite(cli["eval"]["cer"])
                 and got == {"mha_box": n, "mha": n, "mha_masked": 0})
    emit(rec)
    return rec, got


def datasets_sweep_decode(card):
    """(d): the sweep's decode of the fixture lines' fp32 forward with the
    native metrics and with the plain ones: the same records, ms a point."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import NpzLines, eval_iter
    from dtlr_tpu_torch.eval import evaluate, metrics
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches
    from dtlr_tpu_torch.train.config import RECIPE

    model = evaluate.load_model(PARAMS, "cuda", "float32")
    ds = NpzLines(LINES)
    reset_launches()
    batches = make_batcher(RECIPE, eval_iter(ds), False, 0)
    try:
        outputs = evaluate.forward_batches(model, iter(batches))
    finally:
        batches.stop()
    torch.cuda.synchronize()
    got = dict(flash_mha.launches)
    grid = evaluate.sweep_grid(True)
    quiet = lambda msg: None
    native_run = evaluate.sweep(outputs, ds.charset, grid, log=quiet)
    fast = metrics.levenshtein, metrics.edit_operations
    metrics.levenshtein, metrics.edit_operations = (metrics.levenshtein_plain,
                                                    metrics.edit_operations_plain)
    try:
        plain_run = evaluate.sweep(outputs, ds.charset, grid, log=quiet)
    finally:
        metrics.levenshtein, metrics.edit_operations = fast
    rec = {"phase": "datasets", "part": "sweep_decode", "points": len(native_run["records"]),
           "decode_ms_per_point": {"native": stat_ms(native_run["timings"]["decode_ms"]),
                                   "plain": stat_ms(plain_run["timings"]["decode_ms"])},
           "records_equal": native_run["records"] == plain_run["records"],
           "launches": got, "card": card}
    rec["ok"] = rec["records_equal"] and len(native_run["records"]) > 0
    emit(rec)
    del model
    return rec, got


def forms_decode():
    """(e): every file of FORMS_ROOT decoded to PIL's hash, through the
    native decoders and the numpy versions; ms per line per form."""
    from dtlr_tpu_torch.data import images

    with open(FORMS_REF) as fh:
        ref = json.load(fh)
    bad, decode = [], {}
    for rel, want in ref["pixels_sha256"].items():
        with open(os.path.join(FORMS_ROOT, rel), "rb") as fh:
            data = fh.read()
        rgb, nat_ms = timed(images.decode_image, data)
        slow, plain_ms = timed(images.decode_image, data, False)
        if image_sha256(rgb) != want:
            bad.append(rel)
        if not np.array_equal(slow, rgb):
            bad.append(f"{rel} (plain)")
        form = os.path.basename(rel) if rel.startswith("forms/") else "borg_tiff"
        d = decode.setdefault(form, {"lines": 0, "native_ms": [], "plain_ms": [],
                                     "shape": list(rgb.shape)})
        d["lines"] += 1
        d["native_ms"].append(nat_ms)
        d["plain_ms"].append(plain_ms)
    decode = {k: {"lines": v["lines"], "shape": v["shape"],
                  "native_ms_per_line": stat_ms(v["native_ms"]),
                  "plain_ms_per_line": stat_ms(v["plain_ms"])} for k, v in decode.items()}
    rec = {"phase": "datasets", "part": "forms", "files": len(ref["pixels_sha256"]),
           "pixels_sha256_mismatched": bad, "decode": decode}
    rec["ok"] = not bad
    return rec, ref


def phase_datasets(card, native_build):
    """The real datasets' loaders (see the module docstring): (a) the host
    runtime, (b) evaluate, (c) finetune, (d) the sweep's decode, (e) the
    other image forms and the Borg layout's evaluate."""
    import tempfile

    with open(DATASETS_REF) as fh:
        ref = json.load(fh)
    host = datasets_host(ref, native_build)
    emit(host)
    t0 = time.perf_counter()
    forms, forms_ref = forms_decode()
    forms["seconds"] = time.perf_counter() - t0
    emit(forms)
    records, launches = datasets_evaluate(card, ref)
    borg_records, borg_launches = datasets_evaluate(card, forms_ref, ("borg",), FORMS_ROOT)
    records += [forms, *borg_records]
    launches.update(borg_launches)
    with tempfile.TemporaryDirectory() as workdir:
        ft, launches["datasets_finetune_bf16"] = datasets_finetune(card, ref, workdir)
    torch.cuda.empty_cache()
    sweep_rec, launches["datasets_sweep_fp32"] = datasets_sweep_decode(card)
    records = [host, *records, ft, sweep_rec]
    failed = [r.get("dataset", r["part"]) + " " + r.get("compute_dtype", "")
              for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"datasets phase checks failed: {failed}")
    return records, launches


# the ngram phase: python -m dtlr_tpu_torch.ngram.rescore on the 16 lines
# of WORDS with the flagship, held against the JAX package's rescoring of
# them (tests/test_torch_smoke_words.py writes WORDS and WORDS_REF)
NGRAM_CHILD = """
import json, sys, time
import torch
from dtlr_tpu_torch.ngram import rescore
from dtlr_tpu_torch.ops.flash_attn import flash_mha
t0 = time.perf_counter()
res = rescore.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"child": {"launches": dict(flash_mha.launches),
                            "seconds": time.perf_counter() - t0,
                            **{k: v for k, v in res.items() if k != "posteriors"}}}))
"""
NGRAM_CHILD_TIMEOUT = 600


def ngram_yaml(path, out_dir, lexicon=False):
    """A rescore YAML for the phase: WORDS with the flagship and
    NGRAM_SETTINGS (and NGRAM_LEXICON), writing under ``out_dir``."""
    keys = {"lines": WORDS, "model_config": FLAGSHIP_CONFIG, "params": PARAMS,
            "ckpt_dir": out_dir, **NGRAM_SETTINGS, **(NGRAM_LEXICON if lexicon else {})}
    with open(path, "w") as fh:
        fh.write("".join(f"{k}: {v}\n" for k, v in keys.items()))
    return path


def start_ngram_child(args):
    """The rescore entry point as a child process (its own attention counts,
    from 0) with ``args``; returns the Popen."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", NGRAM_CHILD, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def finish_child(name, proc):
    """The child's last-line record and its printed JSON lines; kills it
    at NGRAM_CHILD_TIMEOUT; raises if it failed."""
    try:
        out, err = proc.communicate(timeout=NGRAM_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise AssertionError(f"ngram {name}: no result in {NGRAM_CHILD_TIMEOUT} s:\n{err[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"ngram {name} failed ({proc.returncode}):\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    printed = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    return printed[-1]["child"], printed[:-1]


def host_decode(ref, charset):
    """Gate (a): the port's LM, lexicon and ``rescore_line`` in this process
    on JAX's committed fp32 posteriors, with the LM's fit seconds and the
    decode's ms per line for each arm."""
    from dtlr_tpu_torch.ngram.lm_decode import CharNgramLM, LexiconTrie, rescore_line

    s = NGRAM_SETTINGS
    t0 = time.perf_counter()
    cs = set(charset)
    with open(LM_CORPUS) as fh:
        text = fh.readlines()
    lm = CharNgramLM(order=s["lm_order"], smoothing=s["lm_smoothing"]).fit(
        [t for t in ("".join(c for c in l if c in cs) for l in text) if t])
    fit_s = time.perf_counter() - t0
    lexicon = LexiconTrie(w for w in {"".join(c for c in w if c in cs)
                                      for l in text for w in l.split()} if w)
    gate = s["skip_gated_words"]
    greedy = [str(g) for g in ref["greedy_fp32"]]
    out = {"lm_fit_s": fit_s}
    for arm, lex in (("ngram", None), ("lexicon", lexicon)):
        t0 = time.perf_counter()
        got = [rescore_line(p, g, charset, lm, lm_weight=s["lm_weight"], beam=s["beam"],
                            no_uppercase_words=gate, no_digits=False, no_dash=gate,
                            lexicon=lex, lexicon_margin=NGRAM_LEXICON["lexicon_margin"])
               for p, g in zip(ref["probs_fp32"], greedy)]
        want = [str(x) for x in ref[f"{arm}_fp32"]]
        out[arm] = {"equal": got == want, "lines_differ": sum(a != b for a, b in zip(got, want)),
                    "decode_ms_per_line": (time.perf_counter() - t0) * 1e3 / len(got)}
    return out


def rescorer_forward(card, charset):
    """The LM rescorer (models/lm_rescorer.py) at its default width over the
    flagship decoder's last features of the phase's lines (fp32): shape,
    finite, ms."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import NpzLines, eval_iter
    from dtlr_tpu_torch.eval.evaluate import forward_lines, load_model
    from dtlr_tpu_torch.models.lm_rescorer import SelfAttentionRescorer
    from dtlr_tpu_torch.train.config import load_settings

    model = load_model(PARAMS, device="cuda", compute_dtype="float32")
    data_cfg, _, _, _ = load_settings(FLAGSHIP_CONFIG, None, "ctc")
    batcher = make_batcher(data_cfg, eval_iter(NpzLines(WORDS)), False, 0)
    try:
        batch = next(iter(batcher))
    finally:
        batcher.stop()
    seen = {}

    def keep_hs(module, inputs, outputs):  # returns None: the output stays
        seen["hs"] = outputs[0]

    hook = model.transformer.register_forward_hook(keep_hs)
    with torch.no_grad():
        out = forward_lines(model, batch.images, batch.valid_hw)
    hook.remove()
    feats, xc = seen["hs"][-1].float(), out["pred_boxes"][..., 0]
    torch.manual_seed(0)
    rescorer = SelfAttentionRescorer(feats.shape[-1], len(charset)).cuda().eval()
    with torch.no_grad():
        logits = rescorer(feats, xc)
        ms = cuda_ms(lambda: rescorer(feats, xc), calls=5, runs=5, warmup=2)
    record = {"part": "lm_rescorer", "features": list(feats.shape), "shape": list(logits.shape),
              "finite": bool(torch.isfinite(logits).all()), "ms": ms,
              "d_model": rescorer.d_model, "layers": rescorer.n_layers, "card": card}
    del model, rescorer
    torch.cuda.empty_cache()
    return record


def phase_ngram(card):
    """The n-gram rescoring of the read (see the module docstring): four
    entry-point children in parallel, gate (a) in this process meanwhile,
    then the rescorer's forward."""
    import tempfile

    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.models.dino import FLAGSHIP

    with np.load(WORDS_REF) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(WORDS) as z:
        charset = [str(c) for c in z["charset"]]
        n_lines = len(z["texts"])
    n_batches = -(-n_lines // NGRAM_SETTINGS["batch_size"])
    n_dec = FLAGSHIP.dec_layers
    want_launches = {"mha_box": n_dec * n_batches, "mha": n_dec * n_batches, "mha_masked": 0}
    texts = [str(t) for t in ref["texts"]]
    records = []
    with tempfile.TemporaryDirectory() as workdir:
        runs = {"fp32": (False, "float32", []), "bf16": (False, "bfloat16", []),
                "lexicon_fp32": (True, "float32", []),
                "sweep_fp32": (False, "float32", ["--sweep_lm", NGRAM_SWEEP])}
        procs = {}
        for name, (lex, dt, extra) in runs.items():
            out_dir = os.path.join(workdir, name)
            yaml = ngram_yaml(os.path.join(workdir, f"{name}.yaml"), out_dir, lex)
            procs[name] = start_ngram_child(["--config_path", yaml, "--compute_dtype", dt,
                                             *extra])
        t0 = time.perf_counter()
        try:
            decode = host_decode(ref, charset)
        except BaseException:
            for p in procs.values():
                os.killpg(p.pid, 9)
            raise
        rec = {"phase": "ngram", "part": "decoder_on_jax_posteriors", **decode,
               "seconds": time.perf_counter() - t0}
        rec["ok"] = decode["ngram"]["equal"] and decode["lexicon"]["equal"]
        emit(rec)
        records.append(rec)

        for name, (lex, dt, extra) in runs.items():
            child, printed = finish_child(name, procs[name])
            out_dir = os.path.join(workdir, name, "ngram_preds")
            tol = NGRAM_TOL[dt]
            tag = "fp32" if dt == "float32" else "bf16"
            rec = {"phase": "ngram", "part": "entry_point", "run": name, "compute_dtype": dt,
                   "launches": child["launches"], "launches_expected": want_launches,
                   "seconds": child["seconds"], "lines": n_lines,
                   "lines_per_s": n_lines / child["seconds"],
                   "forward_ms_per_batch": child["timing"]["forward_ms_per_batch"],
                   "lm_fit_s": child["timing"]["lm_seconds"], "tol": tol, "card": card}
            greedy = child["greedy"]
            rec["greedy_vs_jax"] = {"cer": metrics.mean_cer(greedy, list(ref[f"greedy_{tag}"])),
                                    "lines_differ": sum(a != str(b) for a, b in
                                                        zip(greedy, ref[f"greedy_{tag}"]))}
            rec["greedy_CER_vs_gt"] = metrics.corpus_cer(greedy, texts)
            ok = (child["launches"] == want_launches and child["gts"] == texts
                  and rec["greedy_vs_jax"]["cer"] <= tol)
            if name == "sweep_fp32":
                points = [p for p in printed if "lm_weight" in p]
                rec.update(points=points, best=child["best"])
                want_ngram = [str(s) for s in ref["ngram_fp32"]]
                jax_cer = metrics.corpus_cer(want_ngram, texts)
                at = [p for p in points if p["lm_weight"] == NGRAM_SETTINGS["lm_weight"]]
                ok = (ok and [p["lm_weight"] for p in points] == [0.5, 0.75]
                      and child["best"] == min(points, key=lambda p: p["ngram_CER"])
                      and len(at) == 1 and abs(at[0]["ngram_CER"] - jax_cer) <= tol
                      and not os.path.exists(out_dir))
                rec["jax_ngram_CER_at_weight"] = jax_cer
                rec["decode_ms_per_line"] = [p["decode_ms_per_line"] for p in points]
            else:
                arm = "lexicon" if lex else "ngram"
                got = child["ngram"]
                want = [str(s) for s in ref[f"{arm}_{tag}"]]
                rec.update(arm=arm, ngram_vs_jax={"cer": metrics.mean_cer(got, want),
                                                  "lines_differ": sum(a != b for a, b in
                                                                      zip(got, want))},
                           greedy_CER=child["greedy_CER"], ngram_CER=child["ngram_CER"],
                           jax_CER={"greedy": float(ref[f"cer_greedy_{tag}"]),
                                    "ngram": float(ref[f"cer_{arm}_{tag}"])},
                           decode_ms_per_line=child["timing"]["decode_ms_per_line"],
                           lexicon=child["lexicon"])
                files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
                with open(os.path.join(out_dir, "preds_ngram.txt")) as fh:
                    written = fh.read()
                rec["files"] = files
                ok = (ok and rec["ngram_vs_jax"]["cer"] <= tol and child["lexicon"] == lex
                      and files == ["preds_ngram.txt"] and written == "\n".join(got)
                      and child["n"] == n_lines)
            rec["ok"] = ok
            emit(rec)
            records.append(rec)

    t0 = time.perf_counter()
    rec = {"phase": "ngram", **rescorer_forward(card, charset),
           "seconds": time.perf_counter() - t0}
    rec["ok"] = rec["finite"] and rec["shape"] == [NGRAM_SETTINGS["batch_size"], Q,
                                                  len(charset)]
    emit(rec)
    records.append(rec)
    failed = [r.get("run", r["part"]) for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"ngram phase checks failed: {failed}")
    launches = {f"ngram_{r['run']}": r["launches"] for r in records if "run" in r}
    return records, launches


def backbone_dtypes(model, images, valid_hw):
    """The dtypes of one forward's backbone: each Dense's output, each
    returned feature."""
    from dtlr_tpu_torch.eval.evaluate import forward_lines
    from dtlr_tpu_torch.models.layers import Dense

    dense, feats, hooks = set(), set(), []

    def dense_out(module, inputs, output):  # hooks return None: outputs stay
        dense.add(str(output.dtype))

    def features(module, inputs, outputs):
        feats.update(str(f.dtype) for f in outputs)

    for m in model.backbone_net.modules():
        if isinstance(m, Dense):
            hooks.append(m.register_forward_hook(dense_out))
    hooks.append(model.backbone_net.register_forward_hook(features))
    try:
        forward_lines(model, images, valid_hw)
    finally:
        for h in hooks:
            h.remove()
    return {"dense_outputs": sorted(dense), "features": sorted(feats)}


def backbone_read(card, backbone, compute_dtype, lines, ref, tree):
    """One reading of the fixture lines by Latin_TPU.py's model with
    ``backbone`` and ``tree`` (``deform_weights``'): the launches per
    forward, ms, lines/s, peak memory; held against JAX's reading (fp32,
    where ``ref`` has one) as the deform phase holds its own."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import (agreement, forward_lines, model_from_tree,
                                              read_lines)
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    t0 = time.perf_counter()
    cfg = backbone_config(backbone, compute_dtype)
    if ref is not None and tree_sha256(tree) != str(ref[f"{backbone}_weights_sha256"]):
        raise AssertionError(f"{backbone}: the seeded weights are not those the reference "
                             "was read with")
    model = model_from_tree(tree, cfg, "cuda")
    build_s = time.perf_counter() - t0
    th, nms = (float(x) for x in lines["nms_point"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
    torch.cuda.synchronize()
    launches = dict(flash_mha.launches)
    peak = torch.cuda.max_memory_allocated()
    n_dec = cfg.dec_layers
    record = {"phase": "backbones", "part": "read", "backbone": backbone,
              "compute_dtype": compute_dtype, "params": sum(p.numel() for p in model.parameters()),
              "launches_per_forward": launches, "build_s": build_s,
              "finite": all(np.isfinite(res[k]).all() for k in ("pred_boxes", "max_logit"))}
    ok = record["finite"] and launches == {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0}
    if ref is not None:
        jax_ref = deform_reference(ref, backbone)
        agree = agreement(res, jax_ref)
        same = (np.abs(res["anchors"] - jax_ref["jax_anchors"]).max(-1) < 1e-6).all(-1)
        cer_same = ({k: metrics.mean_cer([s for s, m in zip(res[k], same) if m],
                                         [s for s, m in zip(jax_ref[f"jax_{k}"], same) if m])
                     for k in ("greedy", "nms")} if same.any() else None)
        record.update(agree, box_tol=BOX_TOL, logit_tol=MAX_LOGIT_TOL,
                      swap_gap_tol=SWAP_GAP_TOL, cer_tol=CER_VS_JAX,
                      cer_vs_ref_same_selection=cer_same)
        ok = (ok and agree["lines_compared"] >= 1 and agree["max_pred_boxes_err"] <= BOX_TOL
              and agree["max_logit_err"] <= MAX_LOGIT_TOL
              and agree["max_swap_score_gap"] <= SWAP_GAP_TOL
              and max(cer_same.values()) <= CER_VS_JAX)
    images, valid_hw = lines["images"], lines["valid_hw"]
    if compute_dtype == "bfloat16":
        record["dtypes"] = backbone_dtypes(model, images, valid_hw)
        ok = ok and record["dtypes"]["dense_outputs"] == ["torch.bfloat16"]
    record["ok"] = ok
    if not ok:
        emit({**record, "failed": True})
        raise AssertionError(f"backbones {backbone} {compute_dtype}: the reading disagrees "
                             "with the JAX package's, or launched other kernels")
    fwd_ms = cuda_ms(lambda: forward_lines(model, images, valid_hw), calls=1, runs=5, warmup=2)
    record.update(forward_ms_per_batch=fwd_ms, batch=len(images),
                  lines_per_s=len(images) / (fwd_ms / 1e3), peak_memory_bytes=peak, card=card)
    del model
    torch.cuda.empty_cache()
    return record


def step_tree(backbone, read_tree, num_classes):
    """The weights of a backbone's pretraining step: the recipe's fresh
    initialization (train/init.py, seed 0, ``num_classes`` classes), with
    Swin's leaves taken from ``read_tree`` (deform_weights'): at the fresh
    init (zero biases, unit norms) the tokens of a line's zero padding stay
    exactly zero through every Swin block, each LayerNorm's backward there
    multiplies by 1 / sqrt(1e-6), and the gradient overflows, in the JAX
    package alike (PERF.md)."""
    from dtlr_tpu_torch.train.init import init_params

    cfg = backbone_config(backbone)
    tree = init_params(dataclasses.replace(cfg, dn_labelbook_size=num_classes + 1),
                       num_classes, torch.Generator().manual_seed(0))
    if backbone.startswith("swin"):
        tree.update({k: v for k, v in read_tree.items() if k.startswith("params/backbone_net/")})
    return tree


def trainer_steps(card, backbone, tree, workdir, steps=3):
    """``steps`` recipe detection steps (CDN, bf16) of Latin_TPU.py's model
    with ``backbone`` through ``Trainer`` on the detection fixture's first
    recipe batch: ms per step (the first cold), peak memory, launches per
    step, finite losses and gradient norms."""
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches
    from dtlr_tpu_torch.train.config import load_settings
    from dtlr_tpu_torch.train.engine import Trainer

    train_cfg, model_cfg, _, _ = load_settings(
        BACKBONES_CONFIG, [*ROUND4_OPTIONS, f"backbone={backbone}"], "pretrain")
    batcher = recipe_batcher("pretrain")
    try:
        batch = next(iter(batcher))
    finally:
        batcher.stop()
    trainer = Trainer(train_cfg, model_cfg, os.path.join(workdir, backbone), device="cuda",
                      mode="detection")
    trainer.build(tree)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, norms = [], [], []
    reset_launches()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = {k: v // steps for k, v in flash_mha.launches.items()}
    n_dec = model_cfg.dec_layers
    record = {"phase": "backbones", "run": f"backbones_steps_{backbone}", "backbone": backbone,
              "steps": steps, "ms_per_step": ms,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches_per_step": launches, "losses": losses, "grad_norms": norms,
              "params": sum(p.numel() for p in trainer.state.model.parameters()), "card": card}
    record["ok"] = (all(math.isfinite(x) for x in losses + norms)
                    and launches == {"mha_box": n_dec, "mha": 0, "mha_masked": n_dec}
                    and dict(flash_mha.launches) == {k: v * steps for k, v in launches.items()})
    del trainer
    torch.cuda.empty_cache()
    return record


def phase_backbones(card):
    """Latin_TPU.py's model with the Swin and ConvNeXt backbones (see the
    module docstring)."""
    import tempfile

    from dtlr_tpu_torch.eval.evaluate import load_lines
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.train import pretrain

    lines = load_lines(LINES)
    num_classes = len(lines["charset"])
    with np.load(BACKBONES_REF) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(DETECT_LINES) as z:
        detect_classes = len(z["charset"])
    n_dec = FLAGSHIP.dec_layers
    records, launches = [], {}

    def step_launches(res, steps):
        n_eval = eval_forwards(res)  # the fixture's 8 lines, batch 8
        return {"mha_box": n_dec * (steps + n_eval), "mha": n_dec * n_eval,
                "mha_masked": n_dec * steps}

    with tempfile.TemporaryDirectory() as workdir:
        for backbone in BACKBONES_HELD + BACKBONES_LARGE:
            held = backbone in BACKBONES_HELD
            t0 = time.perf_counter()
            tree = deform_weights(backbone_config(backbone), num_classes)
            draw_s = time.perf_counter() - t0
            for dt in (("float32", "bfloat16") if held else ("bfloat16",)):
                t0 = time.perf_counter()
                rec = backbone_read(card, backbone, dt, lines,
                                    ref if held and dt == "float32" else None, tree)
                rec.update(seconds=time.perf_counter() - t0, weights_draw_s=draw_s)
                tag = "fp32" if dt == "float32" else "bf16"
                launches[f"backbones_read_{backbone}_{tag}"] = rec["launches_per_forward"]
                emit(rec)
                records.append(rec)
            t0 = time.perf_counter()
            train_tree = step_tree(backbone, tree, detect_classes)
            del tree
            if held:
                # one pretraining step of the entry point, with CDN, and its
                # evaluations
                path = os.path.join(workdir, f"{backbone}.npz")
                np.savez(path, **train_tree)
                del train_tree
                res, _, rec = sub_run(f"backbones_step_{backbone}", lambda: pretrain.main(
                    ["-c", BACKBONES_CONFIG, "--lines", DETECT_LINES, "--seed", "0",
                     "--output_dir", os.path.join(workdir, backbone), "--epochs", "1",
                     "--steps_per_epoch", "1", "--params", path, "--options",
                     *ROUND4_OPTIONS, f"backbone={backbone}"]), step_launches)
                rec.update(phase="backbones", backbone=backbone, train=res["train"],
                           detection_eval=res["eval"], card=card)
                rec["ok"] = (rec["ok"] and rec["steps"] == 1
                             and math.isfinite(res["train"]["loss"])
                             and res["train"].get("skipped", 0) == 0
                             and math.isfinite(res["eval"]["loss"]))
                launches[rec["run"]] = rec["launches"]
            else:
                # the large ones: three steps through the recipe's trainer (the
                # entry point would also write their gigabytes of checkpoint)
                rec = trainer_steps(card, backbone, train_tree, workdir)
                del train_tree
                launches[rec["run"]] = {k: v * rec["steps"]
                                        for k, v in rec["launches_per_step"].items()}
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            records.append(rec)
            torch.cuda.empty_cache()
    failed = [r["run"] if "run" in r else f"{r['backbone']} {r['compute_dtype']}"
              for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"backbones phase checks failed: {failed}")
    return records, launches


@contextlib.contextmanager
def captured_attention():
    """Each attention kind's first call through the models'
    ``MultiHeadAttention`` while the block runs: {kind: its arguments,
    detached}, for the kernel-against-plain check after the path ran."""
    from dtlr_tpu_torch.models import layers

    calls, real = {}, layers.flash_mha

    def spy(qh, kh, vh, key_bias, box_prior=None, query_group=None):
        kind = ("mha_box" if box_prior is not None
                else "mha_masked" if query_group is not None else "mha")
        if kind not in calls:
            box = (None if box_prior is None
                   else type(box_prior)(*(t.detach() for t in box_prior)))
            calls[kind] = (qh.detach(), kh.detach(), vh.detach(), key_bias.detach(), box,
                           query_group)
        return real(qh, kh, vh, key_bias, box_prior, query_group)

    layers.flash_mha = spy
    try:
        yield calls
    finally:
        layers.flash_mha = real


def captured_against_plain(calls):
    """The kernel on each captured call's arguments against its plain
    version (the kernels phase's tolerances), with both times."""
    from dtlr_tpu_torch.ops.flash_attn import dense_reference, flash_mha

    out = {}
    for kind, args in calls.items():
        with torch.no_grad():
            err = float((flash_mha(*args) - dense_reference(*args)).abs().max())
        dtype = args[0].dtype
        out[kind] = {"S": int(args[1].shape[2]), "Q": int(args[0].shape[2]),
                     "dtype": str(dtype).split(".")[1], "max_abs_err": err, "tol": TOL[dtype],
                     "ok": math.isfinite(err) and err <= TOL[dtype],
                     "ms": cuda_ms(lambda: flash_mha(*args), calls=5, runs=3, warmup=1),
                     "plain_ms": cuda_ms(lambda: dense_reference(*args), calls=5, runs=3,
                                         warmup=1)}
    return out


@contextlib.contextmanager
def dropout_sites():
    """Every dropout call while the block runs: its kept share of the
    input's nonzero elements (counts on the device), and whether what it
    kept is scaled by exactly 1 / (1 - rate) (the first call)."""
    from dtlr_tpu_torch.models.transformer import Dropout

    record = {"counts": [], "scale_exact": None}
    real = Dropout.__call__

    def spy(self, x):
        out = real(self, x)
        nz = x != 0
        kept = (out != 0) & nz
        record["counts"].append(torch.stack([kept.sum(), nz.sum()]))
        if record["scale_exact"] is None:
            record["scale_exact"] = bool(torch.equal(out[kept], (x / (1.0 - self.rate))[kept]))
        return out

    Dropout.__call__ = spy
    try:
        yield record
    finally:
        Dropout.__call__ = real


def kept_shares(record, rate):
    """The sites' kept shares and their distance from 1 - rate in standard
    errors of a Bernoulli(1 - rate) share."""
    counts = torch.stack(record["counts"]).cpu().numpy().astype(np.float64)
    share = counts[:, 0] / counts[:, 1]
    sigma = np.sqrt(rate * (1 - rate) / counts[:, 1])
    z = np.abs(share - (1 - rate)) / sigma
    return {"sites": len(share), "share_min": float(share.min()), "share_max": float(share.max()),
            "max_sigmas": float(z.max()), "elements": int(counts[:, 1].sum()),
            "scale_exact": record["scale_exact"], "ok": bool(z.max() <= 5.0)
            and bool(record["scale_exact"])}


def train_mode_reading(model, lines, th, nms, gen):
    """``read_lines``' reading of one train-mode forward (dropout from
    ``gen``, no targets) of all the lines."""
    from dtlr_tpu_torch.data.charset import labels_to_text
    from dtlr_tpu_torch.eval.decode import greedy_decode, greedy_labels, nms_decode
    from dtlr_tpu_torch.ops.pixels import prep_images

    vh = torch.from_numpy(np.asarray(lines["valid_hw"], np.int32)).cuda()
    im = torch.from_numpy(np.ascontiguousarray(lines["images"])).cuda()
    model.train()
    with torch.no_grad():
        o = model(prep_images(im, vh), vh, train=True, dropout=gen)
    logits, boxes = o["pred_logits"], o["pred_boxes"]
    charset = lines["charset"]
    return {"greedy": [labels_to_text(l, charset)
                       for l in greedy_labels(greedy_decode(logits, boxes))],
            "nms": [labels_to_text(l, charset) for l in nms_decode(logits, boxes, th, nms)],
            "pred_boxes": boxes.cpu().numpy(), "max_logit": logits.max(-1).values.cpu().numpy(),
            "anchors": o["interm_outputs_for_matching_pre"]["pred_boxes"].cpu().numpy(),
            "interm_max_logit": o["interm_outputs"]["pred_logits"].max(-1).values.cpu().numpy()}


@contextlib.contextmanager
def forced_selection(anchors):
    """The two-stage top-k made to pick JAX's proposals: each of JAX's
    selected anchors (N, nq, 4) is found among the forward's own proposal
    grid (its nearest, ``match_err`` the largest distance), and those
    indices replace the port's top-k. With this model's seeded weights
    every line has proposal scores within float noise of each other (75
    swapped slots over the 8 lines, each between scores 9e-5 apart), so
    no line's own selection is JAX's slot for slot; forced, every line's
    is, and each query can be held to JAX's."""
    from dtlr_tpu_torch.models import transformer

    real_props, real_topk = transformer.gen_encoder_output_proposals, transformer.top_k_stable
    state = {"match_err": 0.0}

    def proposals(memory, padding_mask, spatial_shapes):
        out = real_props(memory, padding_mask, spatial_shapes)
        state["proposals"] = out[1]
        return out

    def top_k(scores, k):
        grid = state["proposals"].sigmoid()  # (B, S, 4)
        want = torch.from_numpy(np.array(anchors[:grid.shape[0]], np.float32)).to(grid.device)
        dist = (grid[:, None, :, :] - want[:, :, None, :]).abs().amax(-1)  # (B, k, S)
        best = dist.min(-1)
        state["match_err"] = max(state["match_err"], float(best.values.max()))
        return best.indices

    transformer.gen_encoder_output_proposals = proposals
    transformer.top_k_stable = top_k
    try:
        yield state
    finally:
        transformer.gen_encoder_output_proposals = real_props
        transformer.top_k_stable = real_topk


def held_to_jax(res, forced, match_err, ref, prefix):
    """The reading ``res`` against the JAX reading ``prefix`` of ARCH_REF:
    its own selection's swaps only between scores within SWAP_GAP_TOL;
    then the reading with JAX's selection forced (``forced_selection``)
    per query and by its strings on every line (the backbones phase's
    gates)."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import agreement

    jax_ref = {f"jax_{k}": ref[f"{prefix}_{k}"] for k in
               ("greedy", "nms", "pred_boxes", "max_logit", "anchors", "interm_max_logit")}
    own = agreement(res, jax_ref)
    agree = agreement(forced, jax_ref)
    cer = {k: metrics.mean_cer(forced[k], [str(x) for x in jax_ref[f"jax_{k}"]])
           for k in ("greedy", "nms")}
    ok = (own["max_swap_score_gap"] <= SWAP_GAP_TOL and match_err <= ANCHOR_TOL
          and agree["lines_compared"] == len(forced["greedy"])
          and agree["max_pred_boxes_err"] <= BOX_TOL and agree["max_logit_err"] <= MAX_LOGIT_TOL
          and max(cer.values()) <= CER_VS_JAX)
    return {"own_selection": own, "jax_selection_forced": agree, "anchor_match_err": match_err,
            "cer_vs_jax_forced": cer, "box_tol": BOX_TOL, "logit_tol": MAX_LOGIT_TOL,
            "swap_gap_tol": SWAP_GAP_TOL, "cer_tol": CER_VS_JAX, "ok": ok}


def arch_reads(card, lines, ref, tree):
    """(a): the model read in fp32 (held to JAX's eval reading) and in
    bf16 (strings within CER_VS_JAX_BF16 of JAX's bf16 ones), 6 mha_box
    launches over S = 2728 keys of 5 levels and 6 mha a forward, each
    kernel on a captured call against its plain version; then the model at
    dropout ARCH_DROPOUT read in eval mode, bit for bit the rate-0 fp32
    reading."""
    from dtlr_tpu_torch.eval import metrics
    from dtlr_tpu_torch.eval.evaluate import forward_lines, model_from_tree, read_lines
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches

    th, nms = (float(x) for x in lines["nms_point"])
    records, launches, fp32 = [], {}, None
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = arch_config(dt)
        model = model_from_tree(tree, cfg, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with captured_attention() as calls:
            reset_launches()
            res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
            torch.cuda.synchronize()
            got = dict(flash_mha.launches)
        peak = torch.cuda.max_memory_allocated()
        kernels = captured_against_plain(calls)
        n_dec = cfg.dec_layers
        rec = {"phase": "arch", "part": "read", "compute_dtype": dt,
               "settings": {"num_feature_levels": cfg.num_feature_levels,
                            "decoder_module_seq": list(cfg.decoder_module_seq),
                            "pe_temperatureH": cfg.pe_temperature_h,
                            "pe_temperatureW": cfg.pe_temperature_w},
               "launches_per_forward": got, "kernels_vs_plain": kernels}
        ok = (got == {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0}
              and kernels["mha_box"]["S"] == sum(h * w for h, w in LEVELS[2728])
              and all(k["ok"] for k in kernels.values())
              and all(np.isfinite(res[k]).all() for k in ("pred_boxes", "max_logit")))
        if dt == "float32":
            fp32 = res
            with forced_selection(ref["eval_anchors"]) as forced:
                res_forced = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
            rec["vs_jax"] = held_to_jax(res, res_forced, forced["match_err"], ref, "eval")
            ok = ok and rec["vs_jax"]["ok"]
        else:
            # as the deform phase holds its bf16 reading: the strings against
            # JAX's fp32 ones within twice JAX's own bf16-to-fp32 spread
            # (at least CER_VS_JAX_BF16); beside them, against JAX's bf16
            jax32 = {k: [str(x) for x in ref[f"eval_{k}"]] for k in ("greedy", "nms")}
            spread = {k: metrics.mean_cer([str(x) for x in ref[f"bf16_{k}"]], jax32[k])
                      for k in jax32}
            tol = {k: max(CER_VS_JAX_BF16, 2 * spread[k]) for k in spread}
            cer = {k: metrics.mean_cer(res[k], jax32[k]) for k in jax32}
            rec.update(cer_vs_jax_fp32=cer, jax_bf16_vs_fp32_cer=spread, cer_tol=tol,
                       cer_vs_jax_bf16={k: metrics.mean_cer(res[k], [str(x) for x in
                                                                    ref[f"bf16_{k}"]])
                                        for k in jax32})
            ok = ok and all(cer[k] <= tol[k] for k in tol)
        fwd_ms = cuda_ms(lambda: forward_lines(model, lines["images"], lines["valid_hw"]),
                         calls=1, runs=3, warmup=1)
        rec.update(ok=ok, forward_ms_per_batch=fwd_ms, batch=len(lines["images"]),
                   lines_per_s=len(lines["images"]) / (fwd_ms / 1e3), peak_memory_bytes=peak,
                   seconds=time.perf_counter() - t0, card=card)
        launches[f"arch_read_{'fp32' if dt == 'float32' else 'bf16'}_forward"] = got
        emit(rec)
        records.append(rec)
        del model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = model_from_tree(tree, arch_config("float32", ARCH_DROPOUT), "cuda")
    res = read_lines(model, lines, th, nms, batch_size=len(lines["images"]))
    same = all(np.array_equal(res[k], fp32[k]) for k in res)
    rec = {"phase": "arch", "part": "eval_at_dropout", "dropout": ARCH_DROPOUT,
           "equal_to_rate_0": same, "ok": same, "seconds": time.perf_counter() - t0}
    emit(rec)
    records.append(rec)
    del model
    torch.cuda.empty_cache()
    return records, launches


def arch_dropout(card, lines, ref, tree, workdir):
    """(b): the train-mode forward at rate 1.0 held to JAX's; three CTC
    steps of the model and three detection steps of configs/Latin.py
    (deformable encoder and cross-attention, CDN, B=8) at ARCH_DROPOUT:
    finite losses, ms per step, peak memory, each site's kept share, the
    kernels on captured calls against their plain versions. Returns the
    records, the launches and the CTC trainer (for the snapshot)."""
    from dtlr_tpu_torch.eval.evaluate import model_from_tree
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches
    from dtlr_tpu_torch.train.config import RECIPE, load_settings
    from dtlr_tpu_torch.train.engine import Trainer

    th, nms = (float(x) for x in lines["nms_point"])
    records, launches = [], {}
    t0 = time.perf_counter()
    model = model_from_tree(tree, arch_config("float32", 1.0), "cuda")
    reset_launches()
    res = train_mode_reading(model, lines, th, nms, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    got = dict(flash_mha.launches)
    launches["arch_train_mode_rate_1_fp32_forward"] = got
    with forced_selection(ref["train_anchors"]) as forced:
        res_forced = train_mode_reading(model, lines, th, nms,
                                        torch.Generator("cuda").manual_seed(0))
    rec = {"phase": "arch", "part": "train_mode_rate_1", "launches_per_forward": got,
           "vs_jax": held_to_jax(res, res_forced, forced["match_err"], ref, "train"),
           "seconds": time.perf_counter() - t0}
    rec["ok"] = rec["vs_jax"]["ok"] and got == {"mha_box": 6, "mha": 6, "mha_masked": 0}
    emit(rec)
    records.append(rec)
    del model
    torch.cuda.empty_cache()

    runs = []
    # the flagship's CTC steps with the arch settings, the recipe's bf16
    batcher = recipe_batcher("finetune")
    ctc_batch = batcher._make_batch()
    ctc = Trainer(RECIPE, arch_config("bfloat16", ARCH_DROPOUT), os.path.join(workdir, "ctc"),
                  device="cuda", charset=list(lines["charset"]))
    ctc.build(tree)
    runs.append(("arch_ctc_dropout_bf16_3_steps", ctc, ctc_batch,
                 {"mha_box": 6, "mha": 6, "mha_masked": 0}))
    # configs/Latin.py's detection steps, CDN on, B=8
    train_cfg, model_cfg, _, _ = load_settings(
        DEFORM_CONFIG, [*DEFORM_DATA_OPTIONS, f"dropout={ARCH_DROPOUT}"], "pretrain")
    batcher = recipe_batcher("pretrain")
    det_batch = batcher._make_batch()
    with np.load(DETECT_LINES) as z:
        detect_classes = len(z["charset"])
    det = Trainer(train_cfg, model_cfg, os.path.join(workdir, "detect"), device="cuda",
                  mode="detection")
    det.build(deform_weights(model_cfg, detect_classes))
    runs.append(("latin_detect_dropout_bf16_3_steps", det, det_batch,
                 {"mha_box": 0, "mha": 0, "mha_masked": 6}))
    for name, trainer, batch, per_step in runs:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        reset_launches()
        with captured_attention() as calls, dropout_sites() as sites:
            for _ in range(ARCH_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                m = trainer.step(batch)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t1) * 1e3)
        got = dict(flash_mha.launches)
        launches[name] = got
        kernels = captured_against_plain(calls)
        shares = kept_shares(sites, ARCH_DROPOUT)
        cfg = trainer.model_cfg
        n_sites = (3 * cfg.enc_layers if cfg.encoder_type == "deformable" else 0) \
            + 4 * cfg.dec_layers
        rec = {"phase": "arch", "part": "dropout_steps", "run": name, "dropout": ARCH_DROPOUT,
               "compute_dtype": cfg.compute_dtype, "encoder": cfg.encoder_type,
               "decoder_ca": cfg.decoder_ca, "batch": int(len(batch.texts)),
               "ms_per_step": ms, "losses": losses,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": got, "kernels_vs_plain": kernels, "kept": shares,
               "sites_per_step": shares["sites"] // ARCH_STEPS,
               "seconds": time.perf_counter() - t0, "card": card}
        rec["ok"] = (all(math.isfinite(x) for x in losses)
                     and got == {k: v * ARCH_STEPS for k, v in per_step.items()}
                     and all(k["ok"] for k in kernels.values()) and shares["ok"]
                     and shares["sites"] == n_sites * ARCH_STEPS)
        emit(rec)
        records.append(rec)
    del det
    torch.cuda.empty_cache()
    return records, launches, ctc


def arch_snapshot(card, lines, ctc):
    """(e): evaluate_ctc of the stepped CTC model on the fixture lines
    writes its snapshot; save_snapshot on SNAPSHOT_REF's arrays gives the
    JAX package's pixels."""
    import tempfile

    from dtlr_tpu_torch.data import images
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.charset import load_default_charset
    from dtlr_tpu_torch.data.loaders import NpzLines, eval_iter
    from dtlr_tpu_torch.ops.flash_attn import flash_mha, reset_launches
    from dtlr_tpu_torch.train.config import RECIPE
    from dtlr_tpu_torch.utils import visualizer

    t0 = time.perf_counter()
    ds = NpzLines(LINES)
    batches = list(make_batcher(RECIPE, eval_iter(ds), False, 0))
    reset_launches()
    stats = ctc.evaluate_ctc(iter(batches), list(lines["charset"]), snapshot=True)
    torch.cuda.synchronize()
    got = dict(flash_mha.launches)
    path = os.path.join(ctc.output_dir, "snapshots", "snapshot_epoch0000.png")
    written = os.path.exists(path)
    with open(path, "rb") as fh:
        snap = images.decode_image(fh.read()) if written else None
    with np.load(SNAPSHOT_REF) as z:
        ref = {k: z[k] for k in z.files}
    image = np.load(LINES)["images"][0]
    want = image.reshape(-1, 3).copy()
    want[ref["changed"]] = ref["values"]
    with tempfile.TemporaryDirectory() as out_dir:
        t1 = time.perf_counter()
        mine = visualizer.save_snapshot(out_dir, 3, image, ref["pred_boxes"], ref["pred_labels"],
                                        load_default_charset(), valid_hw=ref["valid_hw"],
                                        gt_boxes=ref["gt_boxes"])
        save_ms = (time.perf_counter() - t1) * 1e3
        with open(mine, "rb") as fh:
            pixels_equal = bool(np.array_equal(images.decode_image(fh.read()),
                                               want.reshape(image.shape)))
    rec = {"phase": "arch", "part": "snapshot", "evaluate": {"cer": stats["cer"], "n": stats["n"]},
           "launches": got, "snapshot_written": written,
           "snapshot_shape": list(snap.shape) if written else None,
           "snapshot_drawn": bool(written and snap.shape == batches[0].images[0].shape
                                  and (snap != batches[0].images[0]).any()),
           "committed_arrays_equal_jax_pixels": pixels_equal, "save_snapshot_ms": save_ms,
           "boxes_drawn": int(len(ref["pred_boxes"]) + len(ref["gt_boxes"])),
           "seconds": time.perf_counter() - t0, "card": card}
    rec["ok"] = written and rec["snapshot_drawn"] and pixels_equal and stats["n"] == len(ds)
    emit(rec)
    return rec, got


def phase_arch(card):
    """The architecture settings, dropout and the snapshot (see the module
    docstring)."""
    import tempfile

    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(LINES)
    with np.load(ARCH_REF) as z:
        ref = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    tree = deform_weights(arch_config(), len(lines["charset"]))
    if tree_sha256(tree) != str(ref["weights_sha256"]):
        raise AssertionError("arch: the seeded weights are not those the reference was read with")
    draw_s = time.perf_counter() - t0
    records, launches = arch_reads(card, lines, ref, tree)
    with tempfile.TemporaryDirectory() as workdir:
        recs, more, ctc = arch_dropout(card, lines, ref, tree, workdir)
        records += recs
        launches.update(more)
        rec, launches["arch_evaluate_snapshot_bf16"] = arch_snapshot(card, lines, ctc)
        records.append(rec)
        del ctc
    torch.cuda.empty_cache()
    records[0]["weights_draw_s"] = draw_s
    failed = [r.get("run", r["part"] + " " + r.get("compute_dtype", "")) for r in records
              if not r["ok"]]
    if failed:
        raise AssertionError(f"arch phase checks failed: {failed}")
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


def ddp_batches(path, max_targets, workdir, name):
    """The fixture's eight lines as one global batch, taken by each of
    DDP_STEPS steps, and each half of it (rows 0-3, 4-7) for one step, in
    ddp_check's npz layout; returns the paths and the batch."""
    from dtlr_tpu_torch.eval.evaluate import load_lines
    from dtlr_tpu_torch.train.engine import collate

    lines = load_lines(path)
    batch = collate(lines, range(len(lines["texts"])), lines["charset"], max_targets)
    keys = [k for k in ("images", "valid_hw", "labels", "valid", "boxes") if k in batch]
    paths = {"whole": os.path.join(workdir, f"{name}.npz")}
    np.savez(paths["whole"], **{k: np.stack([np.asarray(batch[k])] * DDP_STEPS) for k in keys})
    for h in range(2):
        paths[h] = os.path.join(workdir, f"{name}_half{h}.npz")
        np.savez(paths[h], **{k: np.asarray(batch[k])[None, 4 * h:4 * h + 4] for k in keys})
    return paths, batch


def half_draws(batch, workdir):
    """The first step's CDN noise of the whole batch, as the trainer's
    generator (seed 0) draws it on the card, cut into each half's rows."""
    from dtlr_tpu_torch.models.cdn import draw_cdn_noise
    from dtlr_tpu_torch.models.dino import FLAGSHIP

    with np.load(DETECT_PARAMS) as z:
        classes = z["params/class_embed/fc/kernel"].shape[-1]
    gen = torch.Generator("cuda:0").manual_seed(0)
    draws = draw_cdn_noise(len(batch["labels"]), batch["labels"].shape[1], FLAGSHIP.dn_number,
                           classes, gen, torch.device("cuda:0"))
    paths = {}
    for h in range(2):
        paths[h] = os.path.join(workdir, f"draws_half{h}.npz")
        np.savez(paths[h], **{k: getattr(draws, k)[None, 4 * h:4 * h + 4].cpu().numpy()
                              for k in ("flip", "label", "sign", "mag")})
    return paths


def halves_combined(mode, batch, half_dirs):
    """One process's first steps on each half of the batch, combined as
    the ranks' sum combines them: each half weighted by its share of the
    global normalizer (its targets for the detection losses, its lines for
    CTC and the cardinality error). Returns the loss, the terms and the
    path of the combined gradient."""
    steps = [ddp_records(d, 1)[0]["steps"][0] for d in half_dirs]
    if mode == "detection":
        nb = [max(1.0, float(np.asarray(batch["valid"])[4 * h:4 * h + 4].sum())) for h in range(2)]
    else:
        nb = [4.0, 4.0]
    w = [n / sum(nb) for n in nb]
    terms = {k: sum((0.5 if k == "cardinality_error" else wh) * s[k] for wh, s in zip(w, steps))
             for k in steps[0] if k not in ("ms", "launches", "skipped", "grad_norm")}
    out = os.path.join(os.path.dirname(half_dirs[0]), f"{mode}_halves_grads.npz")
    with np.load(os.path.join(half_dirs[0], "grads.npz")) as a, \
            np.load(os.path.join(half_dirs[1], "grads.npz")) as b:
        np.savez(out, **{k: w[0] * a[k] + w[1] * b[k] for k in a.files})
    return terms, out


def ddp_records(out, world):
    records = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            records.append(json.load(fh))
    return records


def grads_within(a_path, b_path):
    """Max |a - b| over every gradient leaf, b's global norm, and the leaf
    that holds the max."""
    with np.load(a_path) as a, np.load(b_path) as b:
        if set(a.files) != set(b.files):
            raise AssertionError("the two runs' gradients have different leaves")
        err = {k: float(np.abs(a[k] - b[k]).max()) for k in b.files}
        norm = math.sqrt(sum(float((b[k].astype(np.float64) ** 2).sum()) for k in b.files))
    leaf = max(err, key=err.get)
    return err[leaf], norm, leaf


def ulp_params(src, dst):
    """The checkpoint in float32 with every weight moved one float32 ulp
    up: a change of the size of one rounding."""
    up = np.array(np.inf, np.float32)
    with np.load(src) as z:
        np.savez(dst, **{k: np.nextafter(z[k].astype(np.float32), up)
                         if z[k].dtype.kind == "f" else z[k] for k in z.files})


@contextlib.contextmanager
def recorded_selections():
    """The two-stage selection of every forward in the block: the scores
    and indices of each call of the transformer's top_k_stable, on the
    host, in order."""
    from dtlr_tpu_torch.models import transformer

    calls, plain = [], transformer.top_k_stable

    def top_k(scores, k):
        idx = plain(scores, k)
        calls.append((scores.detach().float().cpu(), idx.cpu()))
        return idx

    transformer.top_k_stable = top_k
    try:
        yield calls
    finally:
        transformer.top_k_stable = plain


def selection_moves(whole, halves):
    """One process's first selection on the whole batch against its
    selections on each half (rows 0-3, 4-7): the largest difference of a
    proposal's score, the lines and slots whose selected proposals differ,
    and the largest distance of a proposal that moved from the whole
    batch's cut (its k-th score)."""
    s, idx = whole
    moves = {"score_max_abs_diff": 0.0, "lines_moved": 0, "slots_moved": 0,
             "moved_max_gap_to_cut": 0.0}
    for h, (s_h, idx_h) in enumerate(halves):
        rows = slice(4 * h, 4 * h + 4)
        valid = s[rows] > -1e8
        moves["score_max_abs_diff"] = max(moves["score_max_abs_diff"],
                                          float((s[rows] - s_h).abs()[valid].max()))
        for b, (a, c) in enumerate(zip(idx[rows], idx_h)):
            a, c = set(a.tolist()), set(c.tolist())
            if a == c:
                continue
            line = s[4 * h + b]
            cut = float(line[idx[4 * h + b, -1]])
            moves["lines_moved"] += 1
            moves["slots_moved"] += len(a - c)
            moves["moved_max_gap_to_cut"] = max(moves["moved_max_gap_to_cut"], max(
                abs(float(line[j]) - cut) for j in a ^ c))
    return moves


def resize_backward_times(card):
    """The windowed encoder's resizes of one layer at the flagship's levels
    (each level to its neighbours' sizes; B=8, C=256, float32, laid out as
    the encoder lays them out), forward and backward, with CUDA's backward
    (a scatter of atomic adds) and with _MatrixResize's (two matrix
    products, the encoder's): ms per layer (cuda_ms,
    RESIZE_REPS back-to-back layers, where the host's work bounds it), the
    card's own ms per layer (the kernels' device time under
    torch.profiler) and the gradients' distance."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dtlr_tpu_torch.models.windowed_encoder import _MatrixResize, _interpolate

    gen = torch.Generator("cuda:0").manual_seed(0)
    levels = LEVELS[2720]
    xs = [torch.randn(8, h, w, 256, device="cuda", generator=gen).permute(0, 3, 1, 2)
          .requires_grad_() for h, w in levels]
    pairs = [(i, j) for i in range(len(levels)) for j in (i - 1, i + 1)
             if 0 <= j < len(levels)]
    gys = [torch.randn(8, 256, *levels[j], device="cuda", generator=gen) for _, j in pairs]

    def layer(resize):
        outs = [resize(xs[i], *levels[j]) for i, j in pairs]
        return torch.autograd.grad(outs, xs, gys)

    def matrix(x, h, w):
        return _MatrixResize.apply(x, h, w)

    def device_ms(resize):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(RESIZE_REPS):
                layer(resize)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / RESIZE_REPS

    atomic_g, matrix_g = layer(_interpolate), layer(matrix)
    err = max(float((a - b).abs().max()) / float(a.abs().max())
              for a, b in zip(atomic_g, matrix_g))
    record = {"phase": "ddp", "part": "resize_backward", "resizes_per_layer": len(pairs),
              "atomic_ms": cuda_ms(lambda: layer(_interpolate), calls=RESIZE_REPS),
              "matrix_ms": cuda_ms(lambda: layer(matrix), calls=RESIZE_REPS),
              "atomic_device_ms": device_ms(_interpolate), "matrix_device_ms": device_ms(matrix),
              "grad_rel_err": err, "card": card}
    record["ok"] = err <= 1e-6
    emit(record)
    return record


def step_summary(rec):
    """A rank's record: ms per step after the first, peak memory, the
    all-reduce alone, the launches per step."""
    ms = [s["ms"] for s in rec["steps"]]
    return {"rank": rec["rank"], "world_size": rec["world_size"], "backend": rec["backend"],
            "device": rec["device"], "lines": rec["lines_per_rank"], "ms_per_step": ms,
            "ms_per_step_after_first": float(np.median(ms[1:])),
            "allreduce_ms": rec["allreduce_ms"], "grad_bytes": rec["grad_bytes"],
            "peak_memory_bytes": rec["peak_memory_bytes"],
            "launches_per_step": [s["launches"] for s in rec["steps"]]}


def pretrain_entry_run(out, torchrun):
    """python -m dtlr_tpu_torch.train.pretrain (two bf16 steps of the
    recipe at B=8 on the detection fixture, a save, the evaluations), as a
    child process, under torchrun --nproc_per_node 1 or without it."""
    from dtlr_tpu_torch.parallel import launch

    args = ["--params", DETECT_PARAMS, "--lines", DETECT_LINES, "--output_dir", out,
            "--epochs", "1", "--steps_per_epoch", "2", "--deterministic"]
    module = "dtlr_tpu_torch.train.pretrain"
    cmd = (launch.torchrun_command(1, module, args) if torchrun
           else [sys.executable, "-m", module, *args])
    t0 = time.perf_counter()
    done = launch.run_child(cmd, timeout=DDP_CHILD_TIMEOUT, cwd=REPO)
    if done.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} failed ({done.returncode}):\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return time.perf_counter() - t0


def phase_ddp(card):
    """Data parallelism on the card (see the module docstring)."""
    import tempfile

    from dtlr_tpu_torch.parallel import launch
    from dtlr_tpu_torch.scripts import ddp_check, dryrun_multichip
    from dtlr_tpu_torch.train import checkpoints as ckpt
    from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION

    records, launches = [resize_backward_times(card)], {}
    with tempfile.TemporaryDirectory() as workdir:
        # (a) the entry point at world size 1 over NCCL against the same
        # command without torchrun, and (c) the port's dry run over two gloo
        # ranks on the card: four processes side by side (each holds the
        # card alone for none of its time, so their ms are not timings of
        # record), their results read below
        t0 = time.perf_counter()
        names = {"plain": False, "torchrun_nccl_w1": True}
        with ThreadPoolExecutor(len(names) + 1) as pool:
            started = {name: pool.submit(pretrain_entry_run, os.path.join(workdir, name),
                                         torchrun) for name, torchrun in names.items()}
            dryrun = pool.submit(dryrun_multichip.dryrun_multichip, 2, device="cuda:0",
                                 backend="gloo", timeout=DDP_CHILD_TIMEOUT)
            seconds_of = {name: f.result() for name, f in started.items()}
            dryrun_loss = dryrun.result()
        side_by_side_s = time.perf_counter() - t0
        runs = {}
        for name, seconds in seconds_of.items():
            out = os.path.join(workdir, name)
            with open(os.path.join(out, "log.txt")) as fh:
                log = [json.loads(line) for line in fh]
            train = log[0]
            runs[name] = {"seconds": seconds, "log_lines": len(log),
                          "files": sorted(f for f in os.listdir(out) if not os.path.isdir(
                              os.path.join(out, f))),
                          "checkpoint_steps": ckpt._steps(os.path.join(out, "checkpoint")),
                          "state_sha256": ckpt.state_sha256(
                              ckpt.restore_checkpoint(os.path.join(out, "checkpoint"))),
                          "ms_per_step_epoch": 1e3 * train["epoch_time"] / train["iterations"],
                          "loss": train["loss"]}
        plain, nccl = runs["plain"], runs["torchrun_nccl_w1"]
        with np.load(os.path.join(workdir, "plain", "params.npz")) as a, \
                np.load(os.path.join(workdir, "torchrun_nccl_w1", "params.npz")) as b:
            same_npz = set(a.files) == set(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
        record = {"phase": "ddp", "part": "a_entry_point_nccl_w1", "runs": runs,
                  "state_bit_for_bit": plain["state_sha256"] == nccl["state_sha256"],
                  "params_npz_bit_for_bit": same_npz, "card": card,
                  "seconds_with_c_side_by_side": side_by_side_s}
        record["ok"] = (record["state_bit_for_bit"] and same_npz
                        and nccl["files"] == plain["files"]
                        and "info.txt" in nccl["files"]
                        and not any(f.startswith("info_rank") for f in nccl["files"])
                        and nccl["log_lines"] == plain["log_lines"]
                        and nccl["checkpoint_steps"] == plain["checkpoint_steps"] == [2])
        records.append(record)
        emit(record)

        # (b) two ranks on the one card over gloo against one process on
        # the whole batch, fp32, DDP_STEPS steps of each train step
        n_dec = 6
        per_step = {"detection": {"mha_box": n_dec, "mha": 0, "mha_masked": n_dec},
                    "ctc": {"mha_box": n_dec, "mha": n_dec, "mha_masked": 0}}
        for mode, params, lines, max_targets in (
                ("detection", DETECT_PARAMS, DETECT_LINES, RECIPE_DETECTION.max_targets),
                ("ctc", PARAMS, LINES, RECIPE.max_targets)):
            t0 = time.perf_counter()
            paths, batch = ddp_batches(lines, max_targets, workdir, mode)
            args = ["--mode", mode, "--params", params, "--compute_dtype", "float32"]
            one_dir = os.path.join(workdir, f"{mode}_one")
            with recorded_selections() as whole_sel:
                ddp_check.main(args + ["--batches", paths["whole"], "--out", one_dir,
                                       "--device", "cuda:0"])
            torch.cuda.empty_cache()
            one = ddp_records(one_dir, 1)[0]
            # one process on each half, combined: what the ranks' sum must give
            draws = half_draws(batch, workdir) if mode == "detection" else None
            half_dirs, half_sel = [], []
            for h in range(2):
                half_dirs.append(os.path.join(workdir, f"{mode}_half{h}"))
                with recorded_selections() as sel:
                    ddp_check.main(args + ["--batches", paths[h], "--out", half_dirs[h],
                                           "--device", "cuda:0"]
                                   + (["--cdn_draws", draws[h]] if draws else []))
                half_sel.append(sel[0])
                torch.cuda.empty_cache()
            halves, halves_grads = halves_combined(mode, batch, half_dirs)
            # that reference against one process on the whole batch: the
            # batch's shape alone
            shape_worst, norm, shape_leaf = grads_within(halves_grads,
                                                         os.path.join(one_dir, "grads.npz"))
            shape_loss = abs(halves["loss"] - one["steps"][0]["loss"]) / abs(one["steps"][0]["loss"])
            # beside it, one process on the whole batch with every weight
            # one ulp up: how far a change of one rounding moves the step
            ulp_dir = os.path.join(workdir, f"{mode}_ulp")
            ulp_path = os.path.join(workdir, f"{mode}_ulp_params.npz")
            ulp_params(params, ulp_path)
            ddp_check.main(["--mode", mode, "--params", ulp_path, "--compute_dtype", "float32",
                            "--batches", paths["whole"], "--out", ulp_dir, "--device", "cuda:0"])
            os.remove(ulp_path)
            torch.cuda.empty_cache()
            ulp_worst, _, ulp_leaf = grads_within(os.path.join(ulp_dir, "grads.npz"),
                                                  os.path.join(one_dir, "grads.npz"))
            ulp_loss = ddp_records(ulp_dir, 1)[0]["steps"][0]["loss"]
            worlds = {"gloo_w2": (2, ["--device", "cuda:0", "--backend", "gloo"])}
            if mode == "detection":
                worlds["nccl_w1"] = (1, ["--device", "cuda"])
            result = {"phase": "ddp", "part": f"b_{mode}_fp32", "steps": DDP_STEPS,
                      "global_batch": one["lines_per_rank"],
                      "one_process": step_summary(one),
                      "halves_vs_one_process": {
                          "loss_rel": shape_loss, "grad_err_of_norm": shape_worst / norm,
                          "worst_leaf": shape_leaf,
                          "selection": selection_moves(whole_sel[0], half_sel)},
                      "one_ulp_vs_one_process": {
                          "loss_rel": abs(ulp_loss - one["steps"][0]["loss"])
                          / abs(one["steps"][0]["loss"]),
                          "grad_err_of_norm": ulp_worst / norm, "worst_leaf": ulp_leaf},
                      "card": card}
            ok = shape_loss <= SHAPE_LOSS_REL and shape_worst <= SHAPE_GRAD_REL * norm
            for name, (world, extra) in worlds.items():
                out = os.path.join(workdir, f"{mode}_{name}")
                done = launch.launch(world, "dtlr_tpu_torch.scripts.ddp_check",
                                     args + extra + ["--batches", paths["whole"], "--out", out],
                                     timeout=DDP_CHILD_TIMEOUT, cwd=REPO)
                if done.returncode != 0:
                    raise AssertionError(f"ddp_check {mode} {name} failed ({done.returncode}):"
                                         f"\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
                ranks = ddp_records(out, world)
                first = ranks[0]["steps"][0]
                worst, _, _ = grads_within(os.path.join(out, "grads.npz"),
                                           os.path.join(one_dir, "grads.npz"))
                vs_halves, _, _ = grads_within(os.path.join(out, "grads.npz"), halves_grads)
                loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                            for a, b in zip(ranks[0]["steps"], one["steps"])]
                term_rel = {k: abs(first[k] - v) / max(abs(v), 1e-6) for k, v in halves.items()}
                agree = all(r["digests"] == ranks[0]["digests"] for r in ranks)
                counted = all(s["launches"] == per_step[mode] for r in ranks for s in r["steps"])
                part = {"ranks": [step_summary(r) for r in ranks], "ranks_bit_for_bit": agree,
                        "digests_equal_one_process": ranks[0]["digests"] == one["digests"],
                        "loss_rel_per_step": loss_rel,
                        "vs_halves": {"term_rel_max": max(term_rel.values()),
                                      "grad_err_of_norm": vs_halves / norm},
                        "vs_one_process": {"loss_rel": loss_rel[0],
                                           "grad_err_of_norm": worst / norm},
                        "grad_global_norm": norm, "launches_as_counted": counted,
                        "skipped": [s["skipped"] for s in ranks[0]["steps"]]}
                # two ranks: one process's step on each rank's rows; one
                # rank: one process's step on the whole batch (the first
                # step; later ones drift apart on the card's atomics)
                if world == 1:
                    exact = loss_rel[0] <= DDP_REL and worst <= DDP_REL * norm
                else:
                    exact = max(term_rel.values()) <= DDP_REL and vs_halves <= DDP_REL * norm
                part["ok"] = agree and counted and not any(part["skipped"]) and exact
                ok = ok and part["ok"]
                result[name] = part
                for r in ranks:
                    launches[f"ddp_{mode}_fp32_{name}_rank{r['rank']}_{DDP_STEPS}_steps"] = {
                        k: sum(s["launches"][k] for s in r["steps"]) for k in per_step[mode]}
            result["ok"] = ok and all(s["launches"] == per_step[mode] for s in one["steps"])
            result["seconds"] = time.perf_counter() - t0
            records.append(result)
            emit(result)

        # (c), run beside (a) above
        record = {"phase": "ddp", "part": "c_dryrun_multichip_gloo_w2", "loss": dryrun_loss,
                  "ok": math.isfinite(dryrun_loss)}
        records.append(record)
        emit(record)
    failed = [r["part"] for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"ddp phase checks failed: {failed}")
    return records, launches


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
    native_build = build_native()
    native_build["phase_seconds"] = time.perf_counter() - t0
    data_hashes = phase_data()

    t0 = time.perf_counter()
    built = _build.build([flash_attn.SOURCE, gather.SOURCE])
    attn_lib = flash_attn.load_library()
    gather.load_library()
    # tensor-core instructions per attention kernel: all six must have some
    sass = {fn: n for fn, n in _build.sass_counts(built[0]["path"]).items() if "box_attn" in fn}
    L = len(LEVELS[2720])
    emit({"phase": "build",
          "nvcc_seconds": {os.path.basename(b["source"]): b["seconds"] for b in built},
          "ptxas": [l.strip() for b in built for l in b["ptxas"].splitlines()
                    if "entry function" in l or "registers" in l or "spill" in l],
          # the attention's shared memory is dynamic, outside ptxas's report
          "dynamic_smem_bytes": {
              f"{name} {dt}{f', L={L}' if name == 'mha_box' else ''}":
                  attn_lib.dtlr_box_attn_smem(int(dt == "bf16"), int(name == "mha_box"),
                                              L if name == "mha_box" else 1,
                                              int(name == "mha_masked"))
              for name in flash_attn.KERNELS for dt in ("bf16", "fp32")},
          "sass_tensor_core_instructions": sass,
          "seconds": time.perf_counter() - t0})
    # three instantiations (with the prior, without it, and masked) of the
    # bf16 kernel and of the fp32 (3xTF32) one
    by_type = {dt: [n for fn, n in sass.items() if f"box_attn_{dt}_kernel" in fn]
               for dt in ("bf16", "f32")}
    if (any(len(ks) != 3 for ks in by_type.values())
            or not all(n["HMMA"] + n["HGMMA"] > 0 for ks in by_type.values() for n in ks)):
        raise AssertionError(f"the attention kernels do not all run on the tensor cores: {sass}")

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

    sweep_records, sweep_launches = phase_sweep(card)

    t0 = time.perf_counter()
    datasets_recs, datasets_launches = phase_datasets(card, native_build)
    emit({"phase": "datasets", "parts": [r.get("dataset", r["part"]) for r in datasets_recs],
          "seconds": time.perf_counter() - t0})

    train_records, train_launches = phase_train(card, data_hashes)

    detect_records, detect_launches = phase_detect(card, data_hashes)

    t0 = time.perf_counter()
    pretrain_records = phase_pretrain(card)
    emit({"phase": "pretrain", "runs": [r["run"] for r in pretrain_records],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    deform_records, deform_launches = phase_deform(card)
    emit({"phase": "deform", "parts": [r.get("run", r.get("variant", r.get("part")))
                                       for r in deform_records],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ddp_recs, ddp_launches = phase_ddp(card)
    emit({"phase": "ddp", "parts": [r["part"] for r in ddp_recs],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ngram_recs, ngram_launches = phase_ngram(card)
    emit({"phase": "ngram", "parts": [r.get("run", r["part"]) for r in ngram_recs],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    backbone_recs, backbone_launches = phase_backbones(card)
    emit({"phase": "backbones", "parts": [r["run"] if "run" in r
                                          else f"{r['backbone']} {r['compute_dtype']}"
                                          for r in backbone_recs],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    arch_recs, arch_launches = phase_arch(card)
    emit({"phase": "arch", "parts": [r.get("run", r["part"]) for r in arch_recs],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    rc, probe_launches = phase_probe()
    emit({"phase": "probe", "rc": rc, "launches": probe_launches,
          "seconds": time.perf_counter() - t0})

    # each kernel at its main path's shape, dtype and layout: the attention
    # in the recipe's bfloat16 on the decoder's strided views, the gather
    # in the probe. ``launches``: the cross-attention and the masked
    # self-attention of the detection step (1028 queries), the unmasked
    # self-attention of the 12 CTC steps, the gather in the probe. Every
    # path's counts beside them, the evaluate sweep's (one forward for 90
    # points) among them.
    #
    # The fp32 instantiations (``*_fp32``) at the shapes of the fp32 paths,
    # the precision mode every gate against JAX's fp32 reading runs in:
    # the cross-attention and the self-attention of the fp32 forward (read,
    # and once per batch in the sweep), the masked self-attention of the
    # fp32 first detection step. ``launches``: the fp32 read's forward and
    # that detection step; every fp32 path's counts beside them.
    main_shape = {"mha_box": (2720, Q_DETECT, "bfloat16", "strided"),
                  "mha": (900, Q, "bfloat16", "strided"),
                  "mha_masked": (Q_DETECT, Q_DETECT, "bfloat16", "strided"),
                  "mha_box_fp32": (2720, Q, "float32", "strided"),
                  "mha_fp32": (900, Q, "float32", "strided"),
                  "mha_masked_fp32": (Q_DETECT, Q_DETECT, "float32", "strided"),
                  "row_gather": (GATHER_S, GATHER_Q, "float32", None)}
    train_fp32 = train_records[0]["launches_per_step"]
    detect_fp32 = detect_records[0]["launches_per_step"]
    main_launches = {"mha_box": detect_launches["mha_box"], "mha": train_launches["mha"],
                     "mha_masked": detect_launches["mha_masked"],
                     "mha_box_fp32": launches["float32"]["mha_box"],
                     "mha_fp32": launches["float32"]["mha"],
                     "mha_masked_fp32": detect_fp32["mha_masked"], **probe_launches}
    paths = {"bfloat16": {"read_bf16_forward": launches["bfloat16"],
                          "sweep_bf16_90_points": sweep_launches["bfloat16"],
                          "ctc_train_bf16_12_steps": train_launches,
                          "detect_bf16_12_steps": detect_launches,
                          **{f"pretrain_{r['run']}": r["launches"] for r in pretrain_records},
                          "deform_read_bf16_forward": deform_launches["bf16"],
                          **{run: deform_launches[run] for run in
                             ("deform_latin_scratch", "deform_ctc_finetune", "deform_evaluate",
                              "deform_hwdb_pretrain")},
                          "ngram_bf16": ngram_launches["ngram_bf16"],
                          **{k: v for k, v in datasets_launches.items()
                             if not k.endswith("_float32") and not k.endswith("_fp32")},
                          **{k: v for k, v in backbone_launches.items()
                             if not k.endswith("_fp32")},
                          **{k: v for k, v in arch_launches.items() if "fp32" not in k}},
             "float32": {"read_fp32_forward": launches["float32"],
                         "sweep_fp32_90_points": sweep_launches["float32"],
                         "ctc_train_fp32_first_step": train_fp32,
                         "detect_fp32_first_step": detect_fp32,
                         "deform_read_fp32_forward": deform_launches["fp32"],
                         "deform_read_shared_fp32_forward": deform_launches["shared_fp32"],
                         **ddp_launches,
                         **{k: v for k, v in ngram_launches.items() if k != "ngram_bf16"},
                         **{k: v for k, v in datasets_launches.items()
                            if k.endswith("_float32") or k.endswith("_fp32")},
                         **{k: v for k, v in backbone_launches.items() if k.endswith("_fp32")},
                         **{k: v for k, v in arch_launches.items() if "fp32" in k}}}
    by_path = {name + suffix: {path: counts[name] for path, counts in paths[dt].items()}
               for name in flash_attn.KERNELS
               for suffix, dt in (("", "bfloat16"), ("_fp32", "float32"))}
    by_path["row_gather"] = {"probe": probe_launches["row_gather"]}
    replaces = {**REPLACES, "mha_masked": REPLACES["mha"]}
    kernels = []
    for name, shape in main_shape.items():
        base = name.removesuffix("_fp32")
        row = next(r for r in rows if (r["name"], r["S"], r.get("Q"), r["dtype"], r.get("layout"))
                   == (base, *shape) and "values" not in r)
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[base],
                        "replaces": replaces[base], "dtype": row["dtype"],
                        "launches": main_launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "graph_ms", "host_us")},
                        "launches_by_path": by_path[name]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
