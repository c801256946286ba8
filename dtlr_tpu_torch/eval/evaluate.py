"""Read lines with a checkpoint and score them (counterpart of
dtlr_tpu/eval/evaluate.py).

Usage:
    python -m dtlr_tpu_torch.eval.evaluate (--lines lines.npz | --dataset NAME \
        [--mode test] --data_root data [--eval_seed 0]) [--config run/config_cfg.py] \
        (--params artifacts/r4ft_params.npz | --ckpt_dir outputs/finetune [--ema]) \
        [--NMS 0.5 --TH 0.3 | --sweep [--sweep_th 0.3]] \
        [--metrics default|CER_only|chinese|cipher] [--max_images N] \
        [--dump_detections] [--out_dir DIR] [--device cuda] \
        [--compute_dtype bfloat16|float32] [--options key=value ...]

``--lines`` is an npz of pre-rendered lines (``data/loaders.py``'s
``NpzLines``); ``--dataset`` names a real dataset under ``--data_root``
(IAM, READ, RIMES, HWDB, borg, copiale, google1000: the split ``--mode``,
its images decoded by ``data/images.py``, its charset the one the model's
class head must match), or ``HWDB_synth``, which draws ``--max_images``
(default 64) Chinese lines from the glyph bank under
``--data_root``/HWDB_gnt, seeded 321 + ``--eval_seed``
(dtlr_tpu/eval/evaluate.py:233-274). They are batched by the recipe's
``BucketBatcher`` without augmentation. The
settings (data, model geometry, compute dtype) are a config file's with
``--config`` (``dtlr_tpu_torch/configs/``, or a training run's dumped
``config_cfg.py``), ``--options`` overriding its keys, else the recipe's
(``RECIPE`` and ``FLAGSHIP``), ``--options`` overriding their fields;
``--compute_dtype`` overrides either. The weights are an npz of
``params/...`` leaves
(``--params``) or the newest train state under ``--ckpt_dir``
(``checkpoint``, else ``checkpoint_best_regular``), its EMA weights with
``--ema``. Decode: greedy (``--NMS`` <= 0, the default), one (TH, NMS)
point, or with ``--sweep`` the grid TH in {0.05, 0.1, ..., 0.9} x NMS in
{0.1, ..., 0.9}, rows at and above the lowest TH whose predictions are
all empty skipped, the best point by the metric mode's lower-is-better
key. Each batch's forward runs once and every point is decoded from its
outputs (the model is deterministic in eval); the NMS keep mask is
computed once per NMS value and batch. Writes ``preds.txt``,
``gts.txt``, ``char_cer_impact.txt``, ``stats.json`` (and with
``--dump_detections`` ``detections.json``) of the best point to
``--out_dir`` (default ``<ckpt_dir or params dir>/stats_dect/<lines
stem or dataset>/``) and prints its record as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.batching import make_batcher
from ..data.charset import labels_to_text
from ..data.hwdb_synth import hwdb_stream
from ..data.loaders import NpzLines, build_dataset, eval_iter
from ..models.dino import FLAGSHIP, DINO, DinoConfig, build_dino
from ..ops.pixels import prep_images
from ..train import checkpoints as ckpt_lib
from ..train.config import load_settings
from ..train.torch_import import is_torch_checkpoint, load_params_file
from ..weights import load_into, params_from_npz
from . import metrics as M
from .decode import (greedy_decode, greedy_labels, nms_candidates, nms_decode,
                     postprocess_topk, threshold_labels)


def load_lines(path: str) -> Dict[str, object]:
    """The npz's arrays; string arrays become lists of str."""
    with np.load(path) as npz:
        return {k: ([str(s) for s in npz[k]] if npz[k].dtype.kind == "U" else npz[k])
                for k in npz.files}


def model_from_tree(tree: Dict[str, np.ndarray], cfg: DinoConfig, device="cuda") -> DINO:
    """The model of ``cfg`` with a flat ``params/...`` tree's weights; the
    class count comes from the tree's class head and the label book's
    size from its ``label_enc``."""
    num_classes = tree["params/class_embed/fc/kernel"].shape[-1]
    cfg = dataclasses.replace(cfg, dn_labelbook_size=tree["params/label_enc"].shape[0] - 1)
    model = build_dino(cfg, num_classes, device)
    load_into(model, tree)
    return model


def load_model(params_path: str, device: str = "cuda",
               compute_dtype: str = FLAGSHIP.compute_dtype) -> DINO:
    """The flagship model with a checkpoint's weights, computing in
    ``compute_dtype``."""
    return model_from_tree(params_from_npz(params_path),
                           dataclasses.replace(FLAGSHIP, compute_dtype=compute_dtype), device)


@torch.no_grad()
def forward_lines(model: DINO, images: np.ndarray, valid_hw: np.ndarray) -> dict:
    """One forward over uint8 lines (B, H, W, 3), normalized on the device."""
    dev = next(model.parameters()).device
    vh = torch.from_numpy(np.asarray(valid_hw, np.int32)).to(dev)
    im = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    return model(prep_images(im, vh), vh)


def read_lines(model: DINO, lines: dict, th: float, nms: float,
               batch_size: int = 8) -> Dict[str, object]:
    """Greedy and (TH, NMS) strings of every line, with per query the
    final box, the max logit, the two-stage anchor it started from and
    that proposal's max logit."""
    charset = lines["charset"]
    arrays = ("pred_boxes", "max_logit", "anchors", "interm_max_logit")
    out: Dict[str, List] = {k: [] for k in ("greedy", "nms") + arrays}
    for i in range(0, len(lines["images"]), batch_size):
        o = forward_lines(model, lines["images"][i:i + batch_size],
                          lines["valid_hw"][i:i + batch_size])
        logits, boxes = o["pred_logits"], o["pred_boxes"]
        out["greedy"] += [labels_to_text(l, charset)
                          for l in greedy_labels(greedy_decode(logits, boxes))]
        out["nms"] += [labels_to_text(l, charset)
                       for l in nms_decode(logits, boxes, th, nms)]
        out["pred_boxes"].append(boxes.cpu().numpy())
        out["max_logit"].append(logits.max(-1).values.cpu().numpy())
        out["anchors"].append(o["interm_outputs_for_matching_pre"]["pred_boxes"].cpu().numpy())
        out["interm_max_logit"].append(
            o["interm_outputs"]["pred_logits"].max(-1).values.cpu().numpy())
    for k in arrays:
        out[k] = np.concatenate(out[k])
    return out


def agreement(res: dict, ref: dict) -> dict:
    """How far a reading ``res`` (of read_lines) is from a reference
    reading of the same lines (the ``jax_*`` arrays and strings that the
    committed fixture stores).

    The two-stage selection sorts ~2700 proposal scores, so float noise
    can swap two near-tied proposals between query slots. A swapped slot
    starts from another anchor, and through the decoder's self-attention
    the whole line moves, so per-query errors are taken over the lines
    whose selection is the reference's, slot for slot.
    ``max_swap_score_gap`` is the largest score difference behind a swap.
    """
    same = np.abs(res["anchors"] - ref["jax_anchors"]).max(-1) < 1e-6  # (N, nq)
    lines_same = same.all(-1)
    box_err = np.abs(res["pred_boxes"] - ref["jax_pred_boxes"]).max(-1)[lines_same]
    logit_err = np.abs(res["max_logit"] - ref["jax_max_logit"])[lines_same]
    swap_gap = np.abs(res["interm_max_logit"] - ref["jax_interm_max_logit"])[~same]
    return {
        "lines_compared": int(lines_same.sum()),
        "lines_with_swaps": int((~lines_same).sum()),
        "slots_swapped": int((~same).sum()),
        "max_swap_score_gap": float(swap_gap.max(initial=0.0)),
        "max_pred_boxes_err": float(box_err.max(initial=0.0)),
        "max_logit_err": float(logit_err.max(initial=0.0)),
        "cer_vs_ref": {k: M.mean_cer(res[k], ref[f"jax_{k}"]) for k in ("greedy", "nms")},
    }


def score(preds: List[str], gts: List[str], th: float, nms: float) -> dict:
    return {"TH": th, "NMS": nms, "CER": M.mean_cer(preds, gts),
            "WER": M.mean_wer(preds, gts)}


TH_VALUES = [0.05] + [x / 10 for x in range(1, 10)]
NMS_VALUES = [n / 10 for n in range(1, 10)]
#: the lower-is-better key of each metric mode
RANK_KEY = {"chinese": "one_minus_AR", "cipher": "SER"}
#: (query, class) pairs per line in detections.json (num_select, Latin.py:46)
NUM_SELECT = 300


def sweep_grid(sweep: bool, sweep_th: Optional[float] = None, th: float = -1.0,
               nms: float = -1.0) -> List[tuple]:
    """The (TH, NMS) points in the JAX package's order: TH ascending (the
    all-empty skip relies on it), NMS inside; ``sweep_th`` keeps the TH
    values within 0.11 of it."""
    if not sweep:
        return [(th, nms)]
    ths = TH_VALUES if sweep_th is None else sorted(
        t for t in TH_VALUES if abs(t - sweep_th) < 0.11)
    return [(t, n) for t in ths for n in NMS_VALUES]


def compute_stats(mode: str, preds_text, preds_labels, gts_text, gts_labels) -> dict:
    """Per-line means as the primary report and the standardized corpus
    CER (reference evaluation.py:519-582); AR/CR (``chinese``) and
    SER/WA (``cipher``) over label sequences."""
    if mode == "chinese":
        ar, cr = M.ar_cr(preds_labels, gts_labels)
        return {"one_minus_AR": 1 - ar, "AR": ar, "CR": cr}
    if mode == "cipher":
        ser, wa = M.ser_wa(preds_labels, gts_labels)
        return {"SER": ser, "WA": wa}
    stats = {"CER": M.mean_cer(preds_text, gts_text),
             "CER_corpus": M.corpus_cer(preds_text, gts_text)}
    if mode == "default":
        stats["WER"] = M.mean_wer(preds_text, gts_text)
    return stats


def forward_batches(model: DINO, batches, max_images: int = -1):
    """One eval forward per batch, stopping after the batch that brings the
    count of lines to ``max_images`` (when > 0). Returns per batch the
    logits, boxes, texts and the forward's ms (closed by reading a value
    of its output)."""
    outputs, n = [], 0
    for batch in batches:
        t0 = time.perf_counter()
        o = forward_lines(model, batch.images, batch.valid_hw)
        o["pred_logits"].sum().item()
        outputs.append({"pred_logits": o["pred_logits"], "pred_boxes": o["pred_boxes"],
                        "texts": list(batch.texts),
                        "forward_ms": (time.perf_counter() - t0) * 1e3})
        n += len(batch.texts)
        if 0 < max_images <= n:
            break
    return outputs


def detections(outputs, num_select: int) -> List[dict]:
    """COCO-style records of the top-``num_select`` (query, class) pairs
    of every line (reference PostProcess, engine.py:429-484)."""
    dets, img_id = [], 0
    for o in outputs:
        sc, cls, bx = (t.cpu().numpy() for t in postprocess_topk(
            o["pred_logits"], o["pred_boxes"], num_select))
        for b in range(sc.shape[0]):
            for q in range(sc.shape[1]):
                cx, cy, w, h = bx[b, q]
                dets.append({"image_id": img_id + b, "category_id": int(cls[b, q]),
                             "bbox": [float(cx - w / 2), float(cy - h / 2), float(w), float(h)],
                             "score": float(sc[b, q])})
        img_id += len(o["texts"])
    return dets


def sweep(outputs, charset: Sequence[str], grid, metrics: str = "default",
          token_based: bool = False, log=print) -> dict:
    """Every (TH, NMS) point of ``grid`` decoded from the forward's
    ``outputs``, in the JAX package's order and with its rules (its
    evaluate.py:307-345): a point at or above the lowest TH whose
    predictions all came out empty is skipped; the best point has the
    lowest ``RANK_KEY`` value, the first of equals. Returns the records,
    the skipped points, the all-empty TH and the best point with its
    strings, and the ms of each NMS mask (per NMS value and batch) and of
    each point's decode."""
    index = {c: i for i, c in enumerate(charset)}
    gts_text = [t for o in outputs for t in o["texts"]]
    gts_labels = [[index[t] for t in (g.split(" ") if token_based else g) if t in index]
                  for g in gts_text]
    key = RANK_KEY.get(metrics, "CER")
    candidates: Dict[float, list] = {}
    greedy = None
    records, skipped, best, empty_th = [], [], None, None
    timings = {"forward_ms": [o["forward_ms"] for o in outputs], "nms_ms": [], "decode_ms": []}
    for th, nms in grid:
        if empty_th is not None and th >= empty_th:
            skipped.append({"TH": th, "NMS": nms})
            log(f"skip TH={th} NMS={nms}: all preds empty at TH={empty_th}")
            continue
        if nms > 0 and nms not in candidates:
            candidates[nms] = []
            for o in outputs:
                t0 = time.perf_counter()
                candidates[nms].append(nms_candidates(o["pred_logits"], o["pred_boxes"], nms))
                timings["nms_ms"].append((time.perf_counter() - t0) * 1e3)
        if nms <= 0 and greedy is None:
            greedy = [l for o in outputs for l in
                      greedy_labels(greedy_decode(o["pred_logits"], o["pred_boxes"]))]
        t0 = time.perf_counter()
        labels = ([l for c in candidates[nms] for l in threshold_labels(c, th)]
                  if nms > 0 else greedy)
        preds = [labels_to_text(l, charset, token_based) for l in labels]
        if th > 0 and all(len(p) == 0 for p in preds):
            empty_th = th
        stats = compute_stats(metrics, preds, labels, gts_text, gts_labels)
        timings["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        rec = {"TH": th, "NMS": nms, **stats}
        records.append(rec)
        log(f"eval {rec}")
        if best is None or stats[key] < best["record"][key]:
            best = {"record": rec, "preds": preds, "gts": gts_text}
    return {"records": records, "skipped": skipped, "empty_th": empty_th, "best": best,
            "timings": timings}


def write_char_histogram(out_dir: str, preds: List[str], gts: List[str]) -> None:
    """Per-character CER impact (reference evaluation.py:584-656):
    substitutions and deletions count against the ground truth's
    character, insertions against the predicted one, over the ground
    truth's count of it."""
    err, freq = Counter(), Counter()
    for p, g in zip(preds, gts):
        freq.update(g)
        m, n = len(p), len(g)
        dp = np.zeros((m + 1, n + 1), np.int32)
        dp[:, 0] = np.arange(m + 1)
        dp[0, :] = np.arange(n + 1)
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                c = 0 if p[i - 1] == g[j - 1] else 1
                dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + c)
        i, j = m, n
        while i > 0 or j > 0:
            if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (p[i - 1] != g[j - 1]):
                if p[i - 1] != g[j - 1]:
                    err[g[j - 1]] += 1
                i, j = i - 1, j - 1
            elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
                err[g[j - 1]] += 1
                j -= 1
            else:
                err[p[i - 1]] += 1
                i -= 1
    rows = sorted(((c, err[c], freq[c], err[c] / max(freq[c], 1)) for c in set(err) | set(freq)),
                  key=lambda r: -r[1])
    with open(os.path.join(out_dir, "char_cer_impact.txt"), "w") as fh:
        fh.write("char\terrors\tfreq\terror_rate\n")
        for c, e, f, r in rows:
            fh.write(f"{c!r}\t{e}\t{f}\t{r:.4f}\n")


def write_stats(out_dir: str, best: dict, dets: Optional[List[dict]] = None) -> None:
    """The best point's files, as dtlr_tpu/eval/evaluate.py:347-361 writes
    them."""
    os.makedirs(out_dir, exist_ok=True)
    if dets is not None:
        with open(os.path.join(out_dir, "detections.json"), "w") as fh:
            json.dump(dets, fh)
    with open(os.path.join(out_dir, "preds.txt"), "w") as fh:
        fh.write("\n".join(best["preds"]))
    with open(os.path.join(out_dir, "gts.txt"), "w") as fh:
        fh.write("\n".join(best["gts"]))
    write_char_histogram(out_dir, best["preds"], best["gts"])
    with open(os.path.join(out_dir, "stats.json"), "w") as fh:
        json.dump(best["record"], fh, indent=2)


def load_weights(params: Optional[str], ckpt_dir: Optional[str], ema: bool,
                 model_cfg: Optional[DinoConfig] = None) -> Dict[str, np.ndarray]:
    """The flat ``params/...`` tree of ``params`` (an npz, or a reference
    ``.pth`` of ``model_cfg``'s architecture), or of the newest train
    state under ``ckpt_dir`` (``checkpoint``, else
    ``checkpoint_best_regular``), its EMA weights with ``ema``; a train
    state's attention projections are split into ``model_cfg``'s heads
    (without it, as many as its ``ca_box_gamma`` has)."""
    n_heads = model_cfg.nheads if model_cfg is not None else None
    if params is not None:
        if ema:
            raise ValueError("--ema needs a train state (--ckpt_dir): a params npz has no "
                             "EMA weights")
        if is_torch_checkpoint(params):
            return load_params_file(params, model_cfg or FLAGSHIP)
        return params_from_npz(params)
    for name in ("checkpoint", "checkpoint_best_regular"):
        state = ckpt_lib.restore_checkpoint(os.path.join(ckpt_dir, name))
        if state is not None:
            break
    else:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if ema:
        if state.get("ema_params") is None:
            raise ValueError("--ema requested but the checkpoint has no EMA weights "
                             "(train with use_ema=True)")
        return ckpt_lib.params_to_flax(state["ema_params"], n_heads)
    return ckpt_lib.params_to_flax(state["params"], n_heads)


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port evaluation")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params", help="npz of params/... leaves, or a reference .pth")
    src.add_argument("--ckpt_dir", help="a training run's output_dir")
    lines = p.add_mutually_exclusive_group(required=True)
    lines.add_argument("--lines", help="npz of pre-rendered lines")
    lines.add_argument("--dataset", help="IAM, READ, RIMES, HWDB, borg, copiale, google1000 "
                                          "under --data_root, or HWDB_synth (lines from the "
                                          "glyph bank)")
    p.add_argument("--mode", default="test", choices=["val", "test", "valid"])
    p.add_argument("--data_root", default="./data")
    p.add_argument("--eval_seed", type=int, default=0,
                   help="offset of the generated lines' seed (321)")
    p.add_argument("--config", default=None,
                   help="config file, or a training run's config_cfg.py")
    p.add_argument("--ema", action="store_true", help="the train state's EMA weights")
    p.add_argument("--options", nargs="*", default=None,
                   help="key=value overrides of the config's keys (or, without --config, of "
                        "DinoConfig's and the data settings' fields)")
    p.add_argument("--NMS", type=float, default=-1.0, help="<= 0: greedy decode")
    p.add_argument("--TH", type=float, default=-1.0)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--sweep_th", type=float, default=None,
                   help="restrict --sweep to TH values within 0.11 of this")
    p.add_argument("--metrics", default="default",
                   choices=["default", "CER_only", "chinese", "cipher"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--dump_detections", action="store_true")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute_dtype", default=None, choices=("bfloat16", "float32"),
                   help="default: the settings' (the recipe's bfloat16)")
    return p.parse_args(argv)


def eval_lines(args, data_cfg):
    """The lines to read (a dataset or a list of sample dicts), their
    charset, whether its symbols are tokens, and their name."""
    if args.lines is not None:
        ds = NpzLines(args.lines)
        return ds, ds.charset, ds.token_based, os.path.splitext(os.path.basename(args.lines))[0]
    if args.dataset != "HWDB_synth":
        ds = build_dataset(args.dataset, args.mode, root=args.data_root)
        return ds, ds.charset, ds.token_based, args.dataset
    gen = hwdb_stream(args.data_root, 321 + args.eval_seed, data_cfg.hwdb_charset_pickle,
                      data_cfg.hwdb_glyphs_per_line)
    n = args.max_images if args.max_images > 0 else 64
    return [gen.sample() for _ in range(n)], gen.charset, False, args.dataset


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data_cfg, model_cfg, _, unread = load_settings(args.config, args.options, "ctc")
    if unread:
        print(f"config keys the port does not read: {unread}", file=sys.stderr)
    if args.compute_dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, compute_dtype=args.compute_dtype)
    data_cfg = dataclasses.replace(data_cfg, batch_size=args.batch_size)
    ds, charset, token_based, name = eval_lines(args, data_cfg)
    tree = load_weights(args.params, args.ckpt_dir, args.ema, model_cfg)
    classes = tree["params/class_embed/fc/kernel"].shape[-1]
    if classes != len(charset):
        raise ValueError(f"the model has {classes} classes and the lines' charset "
                         f"{len(charset)}")
    model = model_from_tree(tree, model_cfg, str(device))
    base = args.ckpt_dir or os.path.dirname(os.path.abspath(args.params))
    out_dir = args.out_dir or os.path.join(base, "stats_dect", name)

    t0 = time.perf_counter()
    batches = make_batcher(data_cfg, eval_iter(ds), False, 0)
    try:
        outputs = forward_batches(model, iter(batches), args.max_images)
    finally:
        batches.stop()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    grid = sweep_grid(args.sweep, args.sweep_th, args.TH, args.NMS)
    res = sweep(outputs, charset, grid, args.metrics, token_based, log)
    seconds = time.perf_counter() - t0
    dets = detections(outputs, NUM_SELECT) if args.dump_detections else None
    write_stats(out_dir, res["best"], dets)
    rec = res["best"]["record"]
    print(json.dumps(rec))
    lines = sum(len(o["texts"]) for o in outputs)
    return {**res, "out_dir": out_dir, "lines": lines,
            "lines_per_s": lines / seconds, "seconds": seconds}


if __name__ == "__main__":
    main()
