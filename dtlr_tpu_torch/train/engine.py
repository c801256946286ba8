"""The training loop (counterpart of dtlr_tpu/train/engine.py:75-573):
build the train state from a parameter tree, run epochs of steps,
evaluate, save and resume the whole train state. ``mode="ctc"`` is CTC
finetuning, ``mode="detection"`` the DINO detection pretraining step
with contrastive denoising. ``evaluate_ctc`` reads a held-out set (greedy
and NMS CER, the decode's diagnostics; the raw or the EMA weights) in
either mode; ``evaluate_detection`` gives the detection loss.

Batches are ``data.batching.Batch``es as ``BucketBatcher`` makes them
(``images`` (B, H, W, 3) uint8, ``valid_hw`` (B, 2) int32, ``labels``
(B, N) int32, ``boxes`` (B, N, 4) cxcywh in [0, 1], ``valid`` (B, N)
bool, ``texts``), or dicts of the same arrays (``collate`` makes one of
committed lines, as they are, for the checks of a first step). The loop
copies each to the device and reads the step's metrics back only every
``print_freq`` steps.

Data parallelism (``torchrun``, ``parallel/mesh.py``): ``batch_size`` is
the global batch, as JAX's mesh shards it, and the world size must
divide it (JAX takes the largest device prefix that divides it,
dtlr_tpu/train/engine.py:110-119; processes that are already launched
cannot). Every rank reads the same global batches and keeps its rows;
the steps sum the gradients over the ranks. The evaluations combine
every rank's lines before the metrics, so they equal one process's.
Rank 0 alone writes ``log.txt``, ``info.txt`` and the checkpoints (the
other ranks log to ``info_rank{r}.txt``), and every rank restores the
same checkpoint after a barrier.
"""

from __future__ import annotations

import dataclasses
import os
import time
import types
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.batching import Batch
from ..data.charset import labels_to_text, text_to_labels
from ..eval import metrics
from ..eval.decode import greedy_decode, greedy_labels, nms_decode
from ..losses.criterion import build_weight_dict, detection_loss
from ..models.dino import FLAGSHIP, DinoConfig, build_dino
from ..ops.ctc import ctc_loss
from ..ops.pixels import prep_images
from ..parallel import mesh
from ..utils.logging_utils import MetricLogger, append_log_line, setup_logger
from ..weights import load_into
from . import checkpoints as ckpt_lib
from .config import TrainConfig
from .optim import build_head_only_optimizer, build_optimizer
from .train_step import (TrainState, init_train_state, make_ctc_train_step,
                         make_detection_train_step)

MODES = ("ctc", "detection")
#: the score thresholds of evaluate_ctc's nq@TH diagnostics
DIAGNOSTIC_TH = (0.05, 0.1, 0.2, 0.3)
#: the metrics ``train_epoch`` reads back and logs, per mode
LOGGED = {"ctc": ("loss", "loss_CTC", "skipped"),
          "detection": ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_ce_dn", "skipped")}


def collate(lines: Mapping, index: Sequence[int], charset: Sequence[str],
            max_targets: int) -> Dict[str, object]:
    """The lines at ``index`` of a ``load_lines`` dict as one batch, with
    ``max_targets`` target slots. Lines with character boxes (``boxes``
    in the dict) bring their own ``labels``, ``boxes`` and ``valid``;
    otherwise each text becomes charset indices, cut at ``max_targets``."""
    idx = np.asarray(index)
    texts = [lines["texts"][i] for i in idx]
    labels = np.zeros((len(idx), max_targets), np.int32)
    valid = np.zeros((len(idx), max_targets), bool)
    batch = {"images": np.ascontiguousarray(lines["images"][idx]),
             "valid_hw": np.asarray(lines["valid_hw"][idx], np.int32), "texts": texts}
    if "boxes" in lines:
        n = min(max_targets, lines["labels"].shape[1])
        boxes = np.zeros((len(idx), max_targets, 4), np.float32)
        labels[:, :n] = lines["labels"][idx, :n]
        boxes[:, :n] = lines["boxes"][idx, :n]
        valid[:, :n] = lines["valid"][idx, :n]
        batch["boxes"] = boxes
    else:
        for row, text in enumerate(texts):
            lab = text_to_labels(text, charset)[:max_targets]
            labels[row, :len(lab)] = lab
            valid[row, :len(lab)] = True
    batch.update(labels=labels, valid=valid)
    return batch


def box_iou_cxcywh(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """IoU of (T, 4) target and (Q, 4) predicted normalized cxcywh boxes,
    (T, Q), in numpy (dtlr_tpu/train/engine.py:46-61)."""
    def to_xyxy(b):
        cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)

    g, p = to_xyxy(gt)[:, None], to_xyxy(pred)[None]
    lt = np.maximum(g[..., :2], p[..., :2])
    rb = np.minimum(g[..., 2:], p[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    area_p = (p[..., 2] - p[..., 0]) * (p[..., 3] - p[..., 1])
    return inter / np.clip(area_g + area_p - inter, 1e-9, None)


def batch_to_arrays(batch) -> Dict[str, object]:
    """A ``Batch`` as a dict of its arrays and texts (counterpart of
    dtlr_tpu/train/engine.py:36-43); a dict passes as it is."""
    if isinstance(batch, Batch):
        return {"images": batch.images, "valid_hw": batch.valid_hw, "labels": batch.labels,
                "boxes": batch.boxes, "valid": batch.valid, "texts": batch.texts}
    return batch


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    batch = batch_to_arrays(batch)
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device, non_blocking=True)
            for k in ("images", "valid_hw", "labels", "valid", "boxes") if k in batch}


def rank_rows(batch, train: bool = True) -> Dict[str, object]:
    """This rank's rows of a global batch, as arrays (all of it in one
    process). A training batch must split evenly over the ranks; an
    evaluation batch needs a line for every rank."""
    arrays = batch_to_arrays(batch)
    world = mesh.world_size()
    if world == 1:
        return arrays
    n = len(arrays["images"])
    if (train and n % world) or n < world:
        raise ValueError(f"a batch of {n} lines does not split over {world} ranks"
                         + (" evenly" if train else ""))
    return mesh.shard_batch(arrays, mesh.rank(), world)


def check_batch_size(batch_size: int, world: int) -> None:
    """The global batch splits evenly over the ranks, or this raises,
    naming the batch sizes that would split and the world sizes that
    split this one."""
    if batch_size % world == 0:
        return
    near = sorted({max(world, (batch_size // world) * world), (batch_size // world + 1) * world})
    divisors = [w for w in range(1, batch_size + 1) if batch_size % w == 0]
    raise ValueError(f"batch_size {batch_size} is the global batch, split evenly over the "
                     f"ranks, and {world} ranks do not divide it: use batch_size "
                     f"{' or '.join(map(str, near))} (a multiple of {world}), or launch "
                     f"{divisors} processes")


def detection_weight_dict(cfg, model_cfg: DinoConfig) -> Dict[str, float]:
    """``build_weight_dict`` of the training settings with the model's
    decoder depth and CDN switch."""
    return build_weight_dict(types.SimpleNamespace(
        **dataclasses.asdict(cfg), dec_layers=model_cfg.dec_layers, use_dn=model_cfg.use_dn))


class Trainer:
    def __init__(self, cfg: TrainConfig, model_cfg: DinoConfig = FLAGSHIP,
                 output_dir: str = "outputs/finetune", device: str = "cuda",
                 mode: str = "ctc", seed: int = 0, charset: Optional[Sequence[str]] = None):
        if mode not in MODES:
            raise ValueError(f"mode is one of {MODES}, got {mode!r}")
        #: this process's rank and the ranks' count (1 without a group)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        check_batch_size(cfg.batch_size, self.world)
        self.cfg = cfg
        #: the labels' characters, for the training CER (train_epoch)
        self.charset = charset
        self.model_cfg = model_cfg
        self.mode = mode
        self.output_dir = output_dir
        self.device = resolve_device(device)
        os.makedirs(output_dir, exist_ok=True)
        self.logger = setup_logger(output_dir, "dtlr_tpu_torch", self.rank)
        self.state: Optional[TrainState] = None
        #: the mode's train step; ``step_fn.loss_fn`` is its forward and loss
        self.step_fn = None
        self.num_classes = 0
        self.weight_dict: Dict[str, float] = {}
        #: the denoising queries' noise (detection mode), on the device,
        #: seeded anew each epoch with seed + epoch, as JAX's key is
        #: (dtlr_tpu/train/engine.py:236), so a resumed run draws as an
        #: uninterrupted one
        self.seed = seed
        self.cdn_generator = torch.Generator(self.device).manual_seed(seed)
        self._dropout_gen: Optional[torch.Generator] = None
        self.epoch = 0

    def log(self, msg: str) -> None:
        """To stdout and the rank's info file."""
        self.logger.info(msg)

    def append_log_line(self, record: Mapping) -> None:
        """One JSON line of ``log.txt``, written by rank 0."""
        if self.rank == 0:
            append_log_line(self.output_dir, dict(record))

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
        self.num_classes = num_classes
        ema_decay = cfg.ema_decay if cfg.use_ema else 0.0
        if self.mode == "detection":
            self.weight_dict = detection_weight_dict(cfg, model_cfg)
            self.step_fn = make_detection_train_step(
                num_classes, self.weight_dict, focal_alpha=cfg.focal_alpha,
                matcher_impl=cfg.matcher_impl, cost_class=cfg.set_cost_class,
                cost_bbox=cfg.set_cost_bbox, cost_giou=cfg.set_cost_giou, ema_decay=ema_decay)
        else:
            self.step_fn = make_ctc_train_step(ctc_eps=cfg.ctc_eps, ctc_coef=cfg.CTC_loss_coef,
                                               ema_decay=ema_decay)
        n = sum(p.numel() for p in model.parameters())
        self.log(f"model params: {n / 1e6:.2f}M, {num_classes} classes, "
                 f"{'head-only' if head_only else 'full-model'} optimizer, {self.mode} step")

    # ------------------------------------------------------------ loops
    def step(self, batch, mark=None) -> Dict[str, torch.Tensor]:
        """One train step on a batch; the metrics stay on
        the device. ``mark`` goes to the detection step (its phases' ends)."""
        arrays = to_device(rank_rows(batch), self.device)
        dropout = self.dropout_generator()
        if self.mode == "detection":
            self.state, metrics = self.step_fn(self.state, arrays, self.cdn_generator, mark,
                                               dropout)
        else:
            self.state, metrics = self.step_fn(self.state, arrays, dropout)
        return metrics

    def dropout_generator(self) -> Optional[torch.Generator]:
        """The step's generator of dropout masks, seeded from the run's
        seed, the step's index and the rank (JAX draws each step's masks
        from a key split off the epoch's); None at rate 0."""
        if self.model_cfg.dropout == 0:
            return None
        if self._dropout_gen is None:
            self._dropout_gen = torch.Generator(self.device)
        seed = np.random.SeedSequence([self.seed, self.state.step, self.rank]).generate_state(2)
        return self._dropout_gen.manual_seed(int(seed[0]) << 32 | int(seed[1]))

    def train_epoch(self, batches: Iterable, max_iterations: int = -1,
                    train_cer_every: int = 0) -> Dict[str, float]:
        """Steps over ``batches`` (at most ``max_iterations``); the metrics
        are read back every ``cfg.print_freq`` steps and averaged over
        those reads. ``train_cer_every`` > 0: every that many steps the
        greedy CER and WER of the step's batch under the updated weights
        (an eval forward), averaged apart (dtlr_tpu/train/engine.py:268-277;
        the finetune takes 100)."""
        if self.state is None:
            raise RuntimeError("call build() first")
        self.cdn_generator.manual_seed(self.seed + self.epoch)
        print_freq = self.cfg.print_freq
        mlog = MetricLogger()
        t0 = time.time()
        n_it = 0
        for i, batch in enumerate(mesh.lockstep(batches)):
            if 0 < max_iterations <= i:
                break
            m = self.step(batch)
            n_it += 1
            if train_cer_every > 0 and i % train_cer_every == 0 and self.charset:
                mlog.update(**self.batch_cer(batch))
            if i % print_freq == 0:
                # without CDN (use_dn False) a detection step has no DN terms
                host = {k: float(m[k]) for k in LOGGED[self.mode] if k in m}
                mlog.update(**host)
                self.log(f"epoch {self.epoch} it {i}: "
                         + " ".join(f"{k}={v:.4f}" for k, v in host.items()))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        stats = {k: m.global_avg for k, m in mlog.meters.items()}
        stats.update(epoch_time=dt, iterations=n_it, it_per_sec=n_it / max(dt, 1e-9))
        self.append_log_line({"epoch": self.epoch, **stats})
        self.epoch += 1
        return stats

    @torch.no_grad()
    def batch_cer(self, batch) -> Dict[str, float]:
        """The greedy CER and WER of one batch under the current weights
        (every rank's lines of it)."""
        arrays = to_device(rank_rows(batch, train=False), self.device)
        out = self.state.model(prep_images(arrays["images"], arrays["valid_hw"]),
                               arrays["valid_hw"])
        preds = [labels_to_text(l, self.charset)
                 for l in greedy_labels(greedy_decode(out["pred_logits"], out["pred_boxes"]))]
        preds = [p for part in mesh.all_gather_object(preds) for p in part]
        texts = list(batch_to_arrays(batch)["texts"])
        return {"cer": metrics.corpus_cer(preds, texts), "wer": metrics.corpus_wer(preds, texts)}

    @torch.no_grad()
    def evaluate_detection(self, batches: Iterable) -> Dict[str, float]:
        """The detection loss alone over ``batches`` (reference
        engine.py:277-340, dtlr_tpu/train/engine.py:319-355): the eval
        forward (no denoising queries), the matched losses, no decode.
        Returns the means of the total and of loss_ce, loss_bbox and
        loss_giou."""
        cfg = self.cfg
        model = self.state.model
        model.eval()
        mlog = MetricLogger()
        keys = ("loss_ce", "loss_bbox", "loss_giou")
        for batch in mesh.lockstep(batches):
            arrays = to_device(rank_rows(batch, train=False), self.device)
            targets = {k: arrays[k] for k in ("labels", "boxes", "valid")}
            out = model(prep_images(arrays["images"], arrays["valid_hw"]), arrays["valid_hw"])
            total, losses = detection_loss(
                out, targets, self.num_classes, self.weight_dict, focal_alpha=cfg.focal_alpha,
                matcher_impl=cfg.matcher_impl, cost_class=cfg.set_cost_class,
                cost_bbox=cfg.set_cost_bbox, cost_giou=cfg.set_cost_giou)
            # each rank's values are its share of the global batch's
            values = mesh.all_reduce_sum(torch.stack([total] + [losses[k] for k in keys]))
            mlog.update(**dict(zip(("loss",) + keys, values.tolist())))
        stats = {k: m.global_avg for k, m in mlog.meters.items()}
        self.log(f"detection eval: {stats}")
        self.append_log_line({"epoch": self.epoch, "eval": stats})
        return stats

    def save_snapshot(self, host, logits: np.ndarray, boxes: np.ndarray,
                      charset: Sequence[str]) -> None:
        """The first line of an evaluation's first batch with its
        detections drawn (dtlr_tpu/train/engine.py:404-438): the queries
        scoring above TH 0.3, or the top 40 when none does, and the
        ground-truth boxes that have extent, as
        ``<output_dir>/snapshots/snapshot_epochNNNN.png``, written by
        rank 0."""
        if self.rank != 0:
            return
        from ..utils.visualizer import save_snapshot

        scores = 1 / (1 + np.exp(-logits.max(-1)))
        keep = scores > 0.3
        if not keep.any():
            keep = np.zeros_like(keep)
            keep[np.argsort(scores)[-40:]] = True
        gt_valid = np.asarray(host["valid"][0], bool)
        gt_boxes = np.asarray(host["boxes"][0])[gt_valid]
        gt_boxes = gt_boxes[(gt_boxes[:, 2] > 0) & (gt_boxes[:, 3] > 0)]
        save_snapshot(os.path.join(self.output_dir, "snapshots"), self.epoch,
                      np.asarray(host["images"][0]), boxes[keep], logits.argmax(-1)[keep],
                      charset, valid_hw=np.asarray(host["valid_hw"][0]),
                      gt_boxes=gt_boxes if len(gt_boxes) else None)

    @torch.no_grad()
    def evaluate_ctc(self, batches: Iterable, charset: Sequence[str], use_ema: bool = False,
                     tag: str = "eval", snapshot: bool = True) -> Dict[str, float]:
        """Read a held-out set as dtlr_tpu/train/engine.py:357-495 does,
        with the raw weights or (``use_ema``, if the state keeps them) the
        EMA weights: the greedy CER (corpus, standardized) and the NMS
        decode's CER at TH 0.3 / NMS 0.5, the mean CTC loss, then the
        greedy WER or, for a charset without a space (HWDB, the ciphers:
        WER is pinned at 1 there), the NMS decode's AR and CR on the
        labels. The decode's diagnostics: each line's highest sigmoid
        score (``max_conf`` the largest, ``mean_max_conf`` their mean),
        ``nq@TH`` the queries per line scoring above TH, and on the first
        batch ``p_gt_matched``, the mean probability of each target's
        class at the query whose box overlaps it most. Logged under
        ``tag``. With ``snapshot`` the first batch's first line is drawn
        (``save_snapshot``); a failure there is logged, not raised."""
        model = self.state.model
        model.eval()
        ema = self.state.ema if use_ema else None
        forward = ((lambda im, vh: torch.func.functional_call(model, ema, (im, vh)))
                   if ema is not None else model)
        spaceless = " " not in charset
        parts = []  # per batch, this rank's lines
        for i, batch in enumerate(mesh.lockstep(batches)):
            host = rank_rows(batch, train=False)
            arrays = to_device(host, self.device)
            out = forward(prep_images(arrays["images"], arrays["valid_hw"]), arrays["valid_hw"])
            # one process's mean over the global batch: each rank's share
            loss, _ = ctc_loss(out["pred_logits"], out["pred_boxes"], arrays["labels"],
                               arrays["valid"], eps=self.cfg.ctc_eps,
                               lines=len(batch_to_arrays(batch)["images"])
                               if mesh.world_size() > 1 else None)
            logits = out["pred_logits"].float().cpu().numpy()
            scores = 1.0 / (1.0 + np.exp(-logits.max(-1)))  # (B, Q)
            frames = greedy_decode(out["pred_logits"], out["pred_boxes"])
            nms = nms_decode(out["pred_logits"], out["pred_boxes"], 0.3, 0.5)
            valid = np.asarray(host["valid"], bool)
            part = {"loss": float(loss), "max_confs": scores.max(-1).tolist(),
                    "th_counts": {t: int((scores > t).sum()) for t in DIAGNOSTIC_TH},
                    "preds": [labels_to_text(l, charset) for l in greedy_labels(frames)],
                    "nms_preds": [labels_to_text(l, charset) for l in nms],
                    "nms_labels": [list(l) for l in nms], "gts": list(host["texts"]),
                    "gt_labels": [np.asarray(l)[v].tolist()
                                  for l, v in zip(host["labels"], valid)],
                    "p_gt": (0.0, 0)}
            if i == 0:
                probs = 1.0 / (1.0 + np.exp(-logits))
                boxes = out["pred_boxes"].float().cpu().numpy()
                if snapshot:
                    try:
                        self.save_snapshot(host, logits[0], boxes[0], charset)
                    except Exception as exc:  # a snapshot never stops an evaluation
                        self.log(f"snapshot failed: {exc}")
                p_sum, p_n = 0.0, 0
                for b in range(logits.shape[0]):
                    gt_b = np.asarray(host["boxes"][b], np.float32)[valid[b]]
                    gt_l = np.asarray(host["labels"][b])[valid[b]]
                    if len(gt_b) == 0:
                        continue
                    best_q = box_iou_cxcywh(gt_b, boxes[b]).argmax(-1)
                    p_sum += float(probs[b, best_q, gt_l].sum())
                    p_n += len(gt_l)
                part["p_gt"] = (p_sum, p_n)
            parts.append(part)
        # every rank's lines, batch by batch in rank order: the global
        # batches' order, as one process reads them
        by_rank = mesh.all_gather_object(parts)
        preds, nms_preds, gts, losses = [], [], [], []
        nms_labels, gt_labels = [], []
        max_confs: List[float] = []
        th_counts = {t: 0 for t in DIAGNOSTIC_TH}
        p_gt_sum, p_gt_n = 0.0, 0
        for batch_parts in zip(*by_rank):
            losses.append(sum(p["loss"] for p in batch_parts))
            for p in batch_parts:
                preds += p["preds"]
                nms_preds += p["nms_preds"]
                nms_labels += p["nms_labels"]
                gts += p["gts"]
                gt_labels += p["gt_labels"]
                max_confs += p["max_confs"]
                for t in DIAGNOSTIC_TH:
                    th_counts[t] += p["th_counts"][t]
                p_gt_sum += p["p_gt"][0]
                p_gt_n += p["p_gt"][1]
        n_images = len(max_confs)
        stats = {"cer": metrics.corpus_cer(preds, gts),
                 "nms_cer": metrics.corpus_cer(nms_preds, gts),
                 "loss_CTC": float(np.mean(losses)) if losses else float("nan"),
                 "n": len(preds),
                 "max_conf": float(np.max(max_confs)) if max_confs else 0.0,
                 "mean_max_conf": float(np.mean(max_confs)) if max_confs else 0.0,
                 **{f"nq@{t}": round(th_counts[t] / max(n_images, 1), 2) for t in DIAGNOSTIC_TH}}
        if spaceless:
            stats["ar"], stats["cr"] = metrics.ar_cr(nms_labels, gt_labels)
        else:
            stats["wer"] = metrics.corpus_wer(preds, gts)
        if p_gt_n:
            stats["p_gt_matched"] = round(p_gt_sum / p_gt_n, 4)
        self.log(f"{tag}: {stats}")
        self.append_log_line({"epoch": self.epoch, tag: stats})
        return stats

    # ------------------------------------------------------------ ckpt
    def checkpoint_state(self) -> dict:
        s = self.state
        return {"params": {n: p.detach() for n, p in s.model.named_parameters()},
                "opt_state": s.optimizer.state_dict(), "step": s.step,
                "ema_params": s.ema, "epoch": self.epoch}

    def save(self, name: str = "checkpoint") -> str:
        """Rank 0 writes the train state (every rank holds the same); the
        ranks wait for it together."""
        directory = os.path.join(self.output_dir, name)
        if self.rank == 0:
            path = ckpt_lib.save_checkpoint(directory, self.state.step, self.checkpoint_state())
            self.log(f"saved checkpoint @{self.state.step} -> {path}")
        else:
            path = ckpt_lib.checkpoint_path(directory, self.state.step)
        mesh.barrier()
        return path

    @torch.no_grad()
    def try_resume(self, name: str = "checkpoint") -> bool:
        """Restore the newest saved state under ``name``. If its optimizer
        state is another stage's (head-only against full model), the
        fresh optimizer is kept, the parameters, step and epoch restored,
        and EMA seeded from the restored parameters. Every rank restores
        the same file."""
        mesh.barrier()
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
        if self.world > 1:
            # every rank must now hold the same state
            digests = mesh.all_gather_object(ckpt_lib.state_sha256(self.checkpoint_state()))
            self.log(f"resumed state sha256 {digests[self.rank]}")
            if len(set(digests)) != 1:
                raise RuntimeError(f"the ranks resumed different states: {digests}")
        return True
