"""The CTC finetuning loop (counterpart of the finetuning half of
dtlr_tpu/train/engine.py:75-573): build the train state from a
parameter tree, run epochs of steps, evaluate greedy CER/WER, save and
resume the whole train state.

Batches are dicts of numpy arrays as ``line_batches`` makes them:
``images`` (B, H, W, 3) uint8, ``valid_hw`` (B, 2) int32, ``labels``
(B, N) int32, ``valid`` (B, N) bool and ``texts``. The loop copies each
to the device and reads the step's metrics back only every
``print_freq`` steps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.charset import labels_to_text, text_to_labels
from ..eval import metrics
from ..eval.decode import greedy_decode, greedy_labels, nms_decode
from ..models.dino import FLAGSHIP, DinoConfig, build_dino
from ..ops.ctc import ctc_loss
from ..ops.pixels import prep_images
from ..weights import load_into
from . import checkpoints as ckpt_lib
from .config import TrainConfig
from .optim import build_head_only_optimizer, build_optimizer
from .train_step import TrainState, init_train_state, make_ctc_train_step


def collate(lines: Mapping, index: Sequence[int], charset: Sequence[str],
            max_targets: int) -> Dict[str, object]:
    """The lines at ``index`` of a ``load_lines`` dict as one batch; each
    text becomes charset indices, cut at ``max_targets``."""
    idx = np.asarray(index)
    texts = [lines["texts"][i] for i in idx]
    labels = np.zeros((len(idx), max_targets), np.int32)
    valid = np.zeros((len(idx), max_targets), bool)
    for row, text in enumerate(texts):
        lab = text_to_labels(text, charset)[:max_targets]
        labels[row, :len(lab)] = lab
        valid[row, :len(lab)] = True
    return {"images": np.ascontiguousarray(lines["images"][idx]),
            "valid_hw": np.asarray(lines["valid_hw"][idx], np.int32),
            "labels": labels, "valid": valid, "texts": texts}


def line_batches(lines: Mapping, batch_size: int, charset: Sequence[str], max_targets: int,
                 seed: Optional[int] = None) -> Iterator[Dict[str, object]]:
    """Batches of pre-rendered lines: with ``seed``, endless reshuffled
    passes drawn from ``np.random.default_rng(seed)``; without, one pass
    in order."""
    n = len(lines["texts"])
    if seed is None:
        for i in range(0, n, batch_size):
            yield collate(lines, range(i, min(i + batch_size, n)), charset, max_targets)
        return
    if n < batch_size:
        raise ValueError(f"{n} lines cannot fill a batch of {batch_size}")
    rng = np.random.default_rng(seed)
    order = np.arange(n)
    while True:
        rng.shuffle(order)
        for i in range(0, n - batch_size + 1, batch_size):
            yield collate(lines, order[i:i + batch_size], charset, max_targets)


def to_device(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device, non_blocking=True)
            for k in ("images", "valid_hw", "labels", "valid")}


class Trainer:
    def __init__(self, cfg: TrainConfig, model_cfg: DinoConfig = FLAGSHIP,
                 output_dir: str = "outputs/finetune", device: str = "cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.output_dir = output_dir
        self.device = resolve_device(device)
        os.makedirs(output_dir, exist_ok=True)
        self.state: Optional[TrainState] = None
        #: make_ctc_train_step's step; ``step_fn.loss_fn`` is its forward and loss
        self.step_fn = None
        self.epoch = 0

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')} dtlr_tpu_torch]: {msg}"
        print(line, flush=True)
        with open(os.path.join(self.output_dir, "info.txt"), "a") as fh:
            fh.write(line + "\n")

    def append_log_line(self, record: Mapping) -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as fh:
            fh.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------ build
    def build(self, params: Mapping[str, np.ndarray], head_only: bool = False) -> None:
        """The model from a flat ``params/...`` tree (its class count and
        label book from the tree), the optimizer (the class heads alone
        with ``head_only``) and the step."""
        cfg = self.cfg
        num_classes = params["params/class_embed/fc/kernel"].shape[-1]
        model_cfg = dataclasses.replace(
            self.model_cfg, dn_labelbook_size=params["params/label_enc"].shape[0] - 1)
        model = build_dino(model_cfg, num_classes, str(self.device))
        load_into(model, params)
        named = dict(model.named_parameters())
        tx = build_head_only_optimizer(cfg, named) if head_only else build_optimizer(cfg, named)
        self.state = init_train_state(model, tx, use_ema=cfg.use_ema)
        self.step_fn = make_ctc_train_step(
            ctc_eps=cfg.ctc_eps, ctc_coef=cfg.CTC_loss_coef,
            ema_decay=cfg.ema_decay if cfg.use_ema else 0.0)
        n = sum(p.numel() for p in model.parameters())
        self.log(f"model params: {n / 1e6:.2f}M, {num_classes} classes, "
                 f"{'head-only' if head_only else 'full-model'} optimizer")

    # ------------------------------------------------------------ loops
    def step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One train step on a ``line_batches`` batch; the metrics stay on
        the device."""
        self.state, metrics = self.step_fn(self.state, to_device(batch, self.device))
        return metrics

    def train_epoch(self, batches: Iterable[Mapping], max_iterations: int = -1) -> Dict[str, float]:
        """Steps over ``batches`` (at most ``max_iterations``); the metrics
        are read back every ``cfg.print_freq`` steps and averaged over
        those reads."""
        if self.state is None:
            raise RuntimeError("call build() first")
        print_freq = self.cfg.print_freq
        sums: Dict[str, float] = {}
        reads = 0
        t0 = time.time()
        n_it = 0
        for i, batch in enumerate(batches):
            if 0 < max_iterations <= i:
                break
            m = self.step(batch)
            n_it += 1
            if i % print_freq == 0:
                host = {k: float(m[k]) for k in ("loss", "loss_CTC", "skipped")}
                for k, v in host.items():
                    sums[k] = sums.get(k, 0.0) + v
                reads += 1
                self.log(f"epoch {self.epoch} it {i}: "
                         + " ".join(f"{k}={v:.4f}" for k, v in host.items()))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        stats = {k: v / max(reads, 1) for k, v in sums.items()}
        stats.update(epoch_time=dt, iterations=n_it, it_per_sec=n_it / max(dt, 1e-9))
        self.append_log_line({"epoch": self.epoch, **stats})
        self.epoch += 1
        return stats

    @torch.no_grad()
    def evaluate_ctc(self, batches: Iterable[Mapping], charset: Sequence[str]) -> Dict[str, float]:
        """Greedy CER/WER (corpus, standardized) and the NMS decode's CER
        at TH 0.3 / NMS 0.5, with the mean CTC loss, over ``batches``."""
        model = self.state.model
        model.eval()
        preds, nms_preds, gts, losses = [], [], [], []
        for batch in batches:
            arrays = to_device(batch, self.device)
            out = model(prep_images(arrays["images"], arrays["valid_hw"]), arrays["valid_hw"])
            loss, _ = ctc_loss(out["pred_logits"], out["pred_boxes"], arrays["labels"],
                               arrays["valid"], eps=self.cfg.ctc_eps)
            losses.append(float(loss))
            frames = greedy_decode(out["pred_logits"], out["pred_boxes"])
            preds += [labels_to_text(l, charset) for l in greedy_labels(frames)]
            nms_preds += [labels_to_text(l, charset) for l in
                          nms_decode(out["pred_logits"], out["pred_boxes"], 0.3, 0.5)]
            gts += list(batch["texts"])
        stats = {"cer": metrics.corpus_cer(preds, gts), "wer": metrics.corpus_wer(preds, gts),
                 "nms_cer": metrics.corpus_cer(nms_preds, gts),
                 "loss_CTC": float(np.mean(losses)) if losses else float("nan"),
                 "n": len(preds)}
        self.log(f"eval: {stats}")
        self.append_log_line({"epoch": self.epoch, "eval": stats})
        return stats

    # ------------------------------------------------------------ ckpt
    def checkpoint_state(self) -> dict:
        s = self.state
        return {"params": {n: p.detach() for n, p in s.model.named_parameters()},
                "opt_state": s.optimizer.state_dict(), "step": s.step,
                "ema_params": s.ema, "epoch": self.epoch}

    def save(self, name: str = "checkpoint") -> str:
        path = ckpt_lib.save_checkpoint(os.path.join(self.output_dir, name), self.state.step,
                                        self.checkpoint_state())
        self.log(f"saved checkpoint @{self.state.step} -> {path}")
        return path

    @torch.no_grad()
    def try_resume(self, name: str = "checkpoint") -> bool:
        """Restore the newest saved state under ``name``. If its optimizer
        state is another stage's (head-only against full model), the
        fresh optimizer is kept, the parameters, step and epoch restored,
        and EMA seeded from the restored parameters."""
        restored = ckpt_lib.restore_checkpoint(os.path.join(self.output_dir, name))
        if restored is None:
            return False
        s = self.state
        for n, p in s.model.named_parameters():
            p.copy_(restored["params"][n])
        try:
            s.optimizer.load_state_dict(restored["opt_state"])
            same = True
        except KeyError:
            same = False
        s.step = int(restored["step"])
        if s.ema is not None:
            src = restored["ema_params"] if same and restored["ema_params"] is not None \
                else restored["params"]
            for n in s.ema:
                s.ema[n].copy_(src[n])
        self.epoch = int(restored["epoch"])
        self.log(f"resumed from {name} at epoch {self.epoch}, step {s.step}"
                 + ("" if same else " (params only: the optimizer changed between stages)"))
        return True
