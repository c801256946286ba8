"""N-gram rescoring entry point (counterpart of dtlr_tpu/ngram/rescore.py,
reference ngram/clean_gen_ngram_preds.py).

Usage:
    python -m dtlr_tpu_torch.ngram.rescore --config_path X.yaml \
        [--max_images N] [--sweep_lm 'lm_weight=0.5,0.75;beam=16,32'] \
        [--device cuda] [--compute_dtype bfloat16|float32]

The YAML is the JAX package's flat format (dtlr_tpu_torch/ngram/*.yaml
are copies of its files) with the same keys:
    lines: lines.npz                    # pre-rendered lines (NpzLines)
    dataset: IAM                        # a real dataset under data_root (mode: test)
    model_config: outputs/run/config_cfg.py   # optional: else the recipe
    ckpt_dir: outputs/run               # a train state; the output dir
    params: artifacts/r4ft_params.npz   # optional: npz or reference .pth
    lm_arpa: path/to/char6gram.arpa     # optional; else lm_corpus
    lm_corpus: path/to/training_text    # optional: fit a python LM
    lm_order: 6
    lm_smoothing: stupid                # or kn
    lm_weight: 0.25
    logits_multiplier: 2.0              # prediction_helpers.py:17-19
    beam: 16
    skip_gated_words: true              # uppercase/digit/dash gating
    no_uppercase_words / no_digits / no_dash
    lexicon: path | lexicon_from_corpus: true, lexicon_margin: 5.0
    batch_size: 8

The lines come from ``lines`` (an npz, as the evaluate CLI's
``--lines``), or from ``dataset`` (IAM, READ, RIMES, HWDB, borg, copiale,
google1000) under ``data_root`` (default ``./data``), split ``mode``
(default ``test``), as the JAX package builds it; ``dataset: synthetic``
renders with PIL and fonts and raises with ``data/loaders.py``'s
``NEEDS_PIL`` reason. ``dtlr_tpu_torch/ngram/smoke_words.yaml`` runs as
it is, on the repository's own lines, weights and corpus. The
weights are ``params`` where given, else the newest train state under
``ckpt_dir`` (``checkpoint``, else ``checkpoint_best_regular``, as JAX's
``try_resume`` falls back). One forward per batch on the device; the
frame posteriors ``blank_synthesis(logits * logits_multiplier, boxes,
eps=0.003)`` cross to the host once per batch as float32, and the beam
search runs there (ngram/lm_decode.py). Prints one JSON line (with
``--sweep_lm`` one per grid point, then ``{"best": ...}``) and writes
``<ckpt_dir, else the params' directory>/ngram_preds/preds_ngram.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from .. import resolve_device
from ..data.batching import make_batcher
from ..data.charset import labels_to_text
from ..data.loaders import NEEDS_PIL, NpzLines, build_dataset, eval_iter
from ..eval.decode import greedy_decode, greedy_labels
from ..eval.evaluate import forward_batches, load_weights, model_from_tree
from ..eval.metrics import corpus_cer
from ..ops.ctc import blank_synthesis
from ..train.config import load_settings
from .lm_decode import CharNgramLM, LexiconTrie, rescore_line


def load_yaml(path: str) -> dict:
    """Tiny YAML subset loader (flat key: value) to avoid a yaml dep."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, _, v = line.partition(":")
            v = v.strip()
            if v.lower() in ("true", "false"):
                v = v.lower() == "true"
            else:
                try:
                    v = int(v)
                except ValueError:
                    try:
                        v = float(v)
                    except ValueError:
                        pass
            out[k.strip()] = v
    return out


def open_lines(ycfg: dict):
    """The config's lines: ``lines`` (an npz), else ``dataset`` under
    ``data_root``, split ``mode``."""
    if ycfg.get("lines"):
        return NpzLines(ycfg["lines"])
    name = ycfg.get("dataset")
    if name == "synthetic":
        raise NotImplementedError(
            f"dataset 'synthetic' {NEEDS_PIL['synthetic_line_OCR_general']}, which the port "
            "does not use: write the lines to an npz and pass it as 'lines:'")
    return build_dataset(name, ycfg.get("mode", "test"), root=ycfg.get("data_root", "./data"))


def parse_sweep(spec: str) -> dict:
    grid = {}
    for part in spec.split(";"):
        k, _, v = part.partition("=")
        grid[k.strip()] = [x.strip() for x in v.split(",") if x.strip()]
    return grid


def main(argv=None):
    p = argparse.ArgumentParser("DTLR port ngram rescoring")
    p.add_argument("--config_path", required=True)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--sweep_lm", default=None,
                   help="grid over LM hyperparameters with a single model "
                        "decode, e.g. 'lm_order=4,6;lm_weight=0.1,0.25,0.5;"
                        "beam=16,32'; prints one JSON line per point plus a "
                        "best-point summary (the reference tunes these "
                        "per-dataset in its ngram/*.yaml)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute_dtype", default=None, choices=("bfloat16", "float32"),
                   help="default: the model config's (the recipe's bfloat16)")
    args = p.parse_args(argv)
    ycfg = load_yaml(args.config_path)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    ds = open_lines(ycfg)
    charset = ds.charset
    data_cfg, model_cfg, _, _ = load_settings(ycfg.get("model_config"), None, "ctc")
    if args.compute_dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, compute_dtype=args.compute_dtype)
    data_cfg = dataclasses.replace(data_cfg, batch_size=int(ycfg.get("batch_size", 8)))
    if not ycfg.get("params") and not ycfg.get("ckpt_dir"):
        raise KeyError("the config names neither params nor ckpt_dir")
    tree = load_weights(ycfg.get("params"), ycfg.get("ckpt_dir"), False, model_cfg)
    classes = tree["params/class_embed/fc/kernel"].shape[-1]
    if classes != len(charset):
        raise ValueError(f"the model has {classes} classes and the lines' charset "
                         f"{len(charset)}")
    model = model_from_tree(tree, model_cfg, str(device))

    def fit_corpus_lm(order: int, smoothing: str) -> CharNgramLM:
        # fit on charset-filtered text so the LM vocabulary matches the
        # label alphabet
        cs_set = set(charset)
        with open(ycfg["lm_corpus"]) as fh:
            return CharNgramLM(order=order, smoothing=smoothing).fit(
                [t for t in ("".join(c for c in l if c in cs_set) for l in fh) if t])

    t0 = time.perf_counter()
    lm_smoothing = str(ycfg.get("lm_smoothing", "stupid"))
    lm = None
    if ycfg.get("lm_arpa"):
        lm = CharNgramLM.from_arpa(ycfg["lm_arpa"])
    elif ycfg.get("lm_corpus"):
        lm = fit_corpus_lm(int(ycfg.get("lm_order", 6)), lm_smoothing)
    lm_seconds = time.perf_counter() - t0

    # lexicon-constrained decode (flashlight's lexicon contract,
    # reference prediction_helpers.py:76-91)
    lexicon = None
    if ycfg.get("lexicon"):
        lexicon = LexiconTrie.from_file(ycfg["lexicon"])
    elif ycfg.get("lexicon_from_corpus") and ycfg.get("lm_corpus"):
        cs_set = set(charset)
        with open(ycfg["lm_corpus"]) as fh:
            words = {"".join(c for c in w if c in cs_set) for l in fh for w in l.split()}
        lexicon = LexiconTrie(w for w in words if w)
    lexicon_margin = float(ycfg.get("lexicon_margin", 5.0))

    logits_mult = float(ycfg.get("logits_multiplier", 2.0))
    lm_weight = float(ycfg.get("lm_weight", 0.25))
    beam = int(ycfg.get("beam", 16))
    gate = bool(ycfg.get("skip_gated_words", True))
    gate_kw = dict(
        no_uppercase_words=gate and bool(ycfg.get("no_uppercase_words", True)),
        no_digits=gate and bool(ycfg.get("no_digits", False)),
        no_dash=gate and bool(ycfg.get("no_dash", True)),
    )

    # ---- single model pass: per line the greedy string and the frame
    # posteriors ----
    batches = make_batcher(data_cfg, eval_iter(ds), False, 0)
    try:
        outputs = forward_batches(model, iter(batches), args.max_images)
    finally:
        batches.stop()
    greedy_preds, line_probs, gts = [], [], []
    for o in outputs:
        frames = greedy_decode(o["pred_logits"], o["pred_boxes"])
        probs = blank_synthesis(o["pred_logits"] * logits_mult, o["pred_boxes"],
                                eps=0.003).cpu().numpy()
        greedy_preds += [labels_to_text(l, charset) for l in greedy_labels(frames)]
        line_probs += list(probs)
        gts += o["texts"]
    greedy_cer = corpus_cer(greedy_preds, gts)
    timing = {"forward_ms_per_batch": [o["forward_ms"] for o in outputs],
              "lm_seconds": lm_seconds}

    def rescore_all(the_lm, w, bm, lex=None, lex_margin=None):
        t = time.perf_counter()
        preds = [rescore_line(pr, gr, charset, the_lm, lm_weight=w, beam=bm, lexicon=lex,
                              lexicon_margin=(lexicon_margin if lex_margin is None
                                              else lex_margin), **gate_kw)
                 for pr, gr in zip(line_probs, greedy_preds)]
        return preds, (time.perf_counter() - t) * 1e3 / max(len(preds), 1)

    if args.sweep_lm:
        # decode-once hyperparameter grid; the LM is refit per order and
        # smoothing
        grid = parse_sweep(args.sweep_lm)
        orders = [int(float(o)) for o in grid.get("lm_order", [ycfg.get("lm_order", 6)])]
        weights = [float(w) for w in grid.get("lm_weight", [lm_weight])]
        beams = [int(float(b)) for b in grid.get("beam", [beam])]
        smooths = [str(s) for s in grid.get("lm_smoothing", [lm_smoothing])]
        # 'lexicon=on,off' toggles the trie (on needs a configured
        # lexicon); 'lexicon_margin=2.5,5' sweeps the OOV margin
        lex_arms = [a.strip() for a in grid.get("lexicon", ["on" if lexicon else "off"])]
        margins = [float(m) for m in grid.get("lexicon_margin", [lexicon_margin])]
        lms = {}
        for o in orders:
            for s in smooths:
                if ycfg.get("lm_arpa") or not ycfg.get("lm_corpus"):
                    lms[(o, s)] = lm  # an ARPA file fixes the order
                else:
                    lms[(o, s)] = fit_corpus_lm(o, s)
        best = None
        for o in orders:
            for s in smooths:
                for w in weights:
                    for bm in beams:
                        for la in lex_arms:
                            lex = lexicon if la == "on" else None
                            for mg in (margins if lex is not None else [0.0]):
                                preds, ms = rescore_all(lms[(o, s)], w, bm, lex, mg)
                                point = {"lm_order": o, "lm_smoothing": s, "lm_weight": w,
                                         "beam": bm, "lexicon": la, "lexicon_margin": mg,
                                         "ngram_CER": corpus_cer(preds, gts),
                                         "greedy_CER": greedy_cer, "n": len(gts),
                                         "decode_ms_per_line": ms}
                                print(json.dumps(point), flush=True)
                                if best is None or point["ngram_CER"] < best["ngram_CER"]:
                                    best = point
                                if lex is None:
                                    break
        print(json.dumps({"best": best}), flush=True)
        return {"best": best, "greedy": greedy_preds, "gts": gts, "posteriors": line_probs,
                "timing": timing}

    lm_preds, ms = rescore_all(lm, lm_weight, beam, lexicon)
    result = {"greedy_CER": greedy_cer, "ngram_CER": corpus_cer(lm_preds, gts),
              "lexicon": bool(lexicon), "n": len(gts)}
    print(json.dumps(result), flush=True)
    timing["decode_ms_per_line"] = ms
    base = ycfg.get("ckpt_dir") or os.path.dirname(os.path.abspath(ycfg["params"]))
    out_dir = os.path.join(base, "ngram_preds")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "preds_ngram.txt"), "w") as fh:
        fh.write("\n".join(lm_preds))
    return {**result, "greedy": greedy_preds, "ngram": lm_preds, "gts": gts,
            "posteriors": line_probs, "out_dir": out_dir, "timing": timing}


if __name__ == "__main__":
    main()
