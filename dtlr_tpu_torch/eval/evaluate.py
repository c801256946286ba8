"""Read pre-batched lines with a checkpoint and score them (counterpart
of dtlr_tpu/eval/evaluate.py:73-123 for one decode point).

Usage:
    python -m dtlr_tpu_torch.eval.evaluate --params artifacts/r4ft_params.npz \
        --lines dtlr_tpu_torch/assets/smoke_lines.npz \
        [--TH 0.1 --NMS 0.4 | --greedy] [--device cuda] \
        [--compute_dtype bfloat16|float32]

``--lines`` is an npz with uint8 ``images`` (N, H, W, 3), ``valid_hw``
(N, 2), ``texts`` and ``charset``. Prints one JSON record
{"TH", "NMS", "CER", "WER"}; the greedy path reports TH = NMS = -1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List

import numpy as np
import torch

from ..models.dino import FLAGSHIP, DINO, build_dino
from ..ops.pixels import prep_images
from ..weights import load_into, params_from_npz
from . import metrics as M
from .decode import greedy_decode, greedy_labels, nms_decode
from ..data.charset import labels_to_text


def load_lines(path: str) -> Dict[str, object]:
    """The npz's arrays; string arrays become lists of str."""
    with np.load(path) as npz:
        return {k: ([str(s) for s in npz[k]] if npz[k].dtype.kind == "U" else npz[k])
                for k in npz.files}


def load_model(params_path: str, device: str = "cuda",
               compute_dtype: str = FLAGSHIP.compute_dtype) -> DINO:
    """The flagship model with a checkpoint's weights, computing in
    ``compute_dtype``; the class count comes from the checkpoint's class
    head and the label book's size from its ``label_enc``."""
    tree = params_from_npz(params_path)
    num_classes = tree["params/class_embed/fc/kernel"].shape[-1]
    cfg = dataclasses.replace(FLAGSHIP, compute_dtype=compute_dtype,
                              dn_labelbook_size=tree["params/label_enc"].shape[0] - 1)
    model = build_dino(cfg, num_classes, device)
    load_into(model, tree)
    return model


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


def parse_args(argv=None):
    p = argparse.ArgumentParser("DTLR port evaluation")
    p.add_argument("--params", required=True, help="flax params npz")
    p.add_argument("--lines", required=True, help="npz of pre-batched lines")
    p.add_argument("--TH", type=float, default=0.1)
    p.add_argument("--NMS", type=float, default=0.4)
    p.add_argument("--greedy", action="store_true",
                   help="greedy decode instead of TH/NMS")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", default=FLAGSHIP.compute_dtype,
                   choices=("bfloat16", "float32"))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = load_model(args.params, device=args.device, compute_dtype=args.compute_dtype)
    lines = load_lines(args.lines)
    res = read_lines(model, lines, args.TH, args.NMS, args.batch_size)
    if args.greedy:
        rec = score(res["greedy"], lines["texts"], -1.0, -1.0)
    else:
        rec = score(res["nms"], lines["texts"], args.TH, args.NMS)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
