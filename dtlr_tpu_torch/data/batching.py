"""Bucketed batches of augmented lines (counterpart of
dtlr_tpu/data/batching.py).

Per batch one min-side scale is drawn from the augmentation scales (the
last scale when not training); each line is resized (aspect kept, long
side capped), squashed to ``h_max`` rows if taller, augmented when
training (four random erasings; optionally column erasings, word
erasings, photometric changes, the resize-crop-resize branch), and
padded to (next multiple of ``h_quant`` rows, ``w_max``) in uint8 or
ImageNet-normalized float32. Boxes stay normalized to the unpadded
resized line. The random draws are the JAX package's, in its order, so
one seed gives the same batches in both packages.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from . import transforms as T


@dataclass
class Batch:
    images: np.ndarray     # (B, H, W, 3) uint8, or float32 ImageNet-normalized
    valid_hw: np.ndarray   # (B, 2) int32
    labels: np.ndarray     # (B, N) int32
    boxes: np.ndarray      # (B, N, 4) float32 normalized cxcywh
    valid: np.ndarray      # (B, N) bool
    texts: List[str] = field(default_factory=list)


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def prepare_sample(
    rng: np.random.Generator,
    image: np.ndarray,            # (H, W, 3) float32 [0, 1]
    boxes: Optional[np.ndarray],  # (n, 4) pixel xyxy or None
    scale: int,
    max_size: int,
    train: bool,
    truly_random_erasing: bool = False,
    instance_erasing: bool = False,
    labels: Optional[np.ndarray] = None,
    space_label: int = 165,
    strong_aug: bool = False,
    rotate_p: float = 0.0,
    rotate_angle: float = 10.0,
    scales2: Optional[tuple] = None,   # (scales2_resize, scales2_crop)
    h_max: Optional[int] = None,
):
    """One line resized and augmented; returns (image, normalized cxcywh
    boxes, labels). With ``rotate_p`` > 0 a training line is rotated by
    ``rotate_angle`` with that probability first (PIL's rotation and
    bicubic resize, ``transforms.rotate_with_boxes``)."""
    if train and rotate_p > 0 and rng.random() < rotate_p:
        image, boxes = T.rotate_with_boxes(image, boxes, rotate_angle)
    if train and scales2 is not None and rng.random() < 0.5:
        img, bx, labels = T.scales2_chain(rng, image, boxes, labels, scales2[0], scales2[1],
                                          [scale], max_size)
    else:
        img, bx = T.resize_min_side(image, boxes, scale, max_size)
    if h_max is not None and img.shape[0] > h_max:
        # a tall, narrow line would open a bucket of its own: squash its
        # height, keep its width
        s = h_max / img.shape[0]
        img = T._interp_resize(img, h_max, max(1, int(round(img.shape[1] * s))))
        if bx is not None and len(bx):
            bx = bx * s
    if train:
        if strong_aug:
            pick = rng.integers(0, 3)
            if pick == 0:
                img = T.lighting_noise(rng, img)
            elif pick == 1:
                img = T.adjust_brightness_contrast(rng, img, contrast=(1.0, 1.0))
            else:
                img = T.adjust_brightness_contrast(rng, img, brightness=(1.0, 1.0))
        if truly_random_erasing:
            # 5 full-height column erasings (reference IAM.py:146-149)
            for _ in range(5):
                img = T.random_erasing_full_vertical(rng, img, p=0.5, n_range=(1, 3),
                                                     width_frac=(0.005, 0.03))
        if instance_erasing and bx is not None and labels is not None:
            img = T.instance_aware_erasing(rng, img, bx, labels, space_label)
        # 4 x RandomErasing(p=0.5, scale=(0.005, 0.05), ratio=(5, 6))
        # (reference IAM.py:205-210)
        for _ in range(4):
            img = T.random_erasing(rng, img, p=0.5, scale=(0.005, 0.05), ratio=(5.0, 6.0))
    bx = T.normalize_boxes(bx, img.shape[0], img.shape[1])
    return img, bx, labels


def collate(samples: Sequence[dict], max_targets: int, w_max: int = 1344, h_quant: int = 64,
            pad_value: float = 0.0, normalize_pixels: bool = True,
            as_uint8: bool = False) -> Batch:
    """Samples (image (H, W, 3) float32 in [0, 1], boxes normalized cxcywh
    or None, labels, text) padded into one batch. ``as_uint8`` ships
    round(255 x) and leaves the normalization to the device
    (ops/pixels.py); otherwise pixels are ImageNet-normalized here (or
    taken as they are with ``normalize_pixels=False``)."""
    from ..runtime import native

    B = len(samples)
    hmax = _round_up(max(s["image"].shape[0] for s in samples), h_quant)
    wmax = w_max
    if as_uint8:
        images = np.zeros((B, hmax, wmax, 3), np.uint8)
    else:
        images = np.full((B, hmax, wmax, 3), pad_value, np.float32)
    valid_hw = np.zeros((B, 2), np.int32)
    labels = np.zeros((B, max_targets), np.int32)
    boxes = np.zeros((B, max_targets, 4), np.float32)
    valid = np.zeros((B, max_targets), bool)
    texts = []
    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if w > wmax:  # crop overly wide lines
            img = img[:, :wmax]
            w = wmax
        if as_uint8:
            # in place, as the JAX package does: on the prepared copy
            np.clip(img * 255.0 + 0.5, 0, 255, out=img)
            images[i, :h, :w] = img.astype(np.uint8)
        elif not normalize_pixels:
            images[i, :h, :w] = img
        else:  # in the native runtime, as the JAX package does
            native.normalize_into(img, images[i])
        valid_hw[i] = (h, w)
        lab = np.asarray(s.get("labels", []), np.int32).reshape(-1)
        n = min(len(lab), max_targets)
        labels[i, :n] = lab[:n]
        if s.get("boxes") is not None and len(s["boxes"]):
            boxes[i, :n] = np.asarray(s["boxes"], np.float32)[:n]
        valid[i, :n] = True
        texts.append(s.get("text", ""))
    return Batch(images, valid_hw, labels, boxes, valid, texts)


def normalize_plain(img: np.ndarray) -> np.ndarray:
    """The ImageNet normalization of ``collate`` in numpy."""
    return (img - T.IMAGENET_MEAN) / T.IMAGENET_STD


class BucketBatcher:
    """Batches from a source of sample dicts {image float32 (H, W, 3) in
    [0, 1], boxes pixel xyxy or None, labels, text}. A thread keeps
    ``prefetch`` batches ready; ``stop()`` ends it.

    ``reuse`` > 1 is the pretraining's sample economy: each fresh sample
    enters a pool of at most ``reuse_pool``, and each batch slot takes a
    fresh sample with probability 1/reuse, else a pooled one, augmented
    anew."""

    def __init__(self, source: Iterable[dict], batch_size: int, scales: Sequence[int],
                 max_size: int = 1333, max_targets: int = 256, w_max: int = 1344,
                 h_quant: int = 64, train: bool = True, truly_random_erasing: bool = False,
                 instance_erasing: bool = False, space_label: int = 165,
                 strong_aug: bool = False, rotate_p: float = 0.0, rotate_angle: float = 10.0,
                 scales2: Optional[tuple] = None, h_max: Optional[int] = None, seed: int = 0,
                 prefetch: int = 4, transfer_uint8: bool = False, reuse: int = 1,
                 reuse_pool: int = 512):
        self.source = iter(source)
        self.batch_size = batch_size
        self.scales = list(scales)
        self.max_size = max_size
        self.max_targets = max_targets
        self.w_max = w_max
        self.h_quant = h_quant
        self.train = train
        self.truly_random_erasing = truly_random_erasing
        self.instance_erasing = instance_erasing
        self.space_label = space_label
        self.strong_aug = strong_aug
        self.rotate_p = rotate_p
        self.rotate_angle = rotate_angle
        self.scales2 = scales2
        self.h_max = h_max
        self.rng = np.random.default_rng(seed)
        self.transfer_uint8 = transfer_uint8
        self.reuse = max(1, int(reuse))
        self._pool: List[dict] = []
        self._pool_cap = int(reuse_pool)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def _make_batch(self) -> Batch:
        scale = int(self.rng.choice(self.scales)) if self.train else self.scales[-1]
        prepared = []
        while len(prepared) < self.batch_size:
            if self.reuse > 1 and self._pool and self.rng.random() > 1.0 / self.reuse:
                raw = self._pool[int(self.rng.integers(len(self._pool)))]
            else:
                raw = next(self.source)
                if self.reuse > 1:
                    if len(self._pool) < self._pool_cap:
                        self._pool.append(raw)
                    else:
                        self._pool[int(self.rng.integers(self._pool_cap))] = raw
            img, bx, lab = prepare_sample(
                self.rng, raw["image"], raw.get("boxes"), scale, self.max_size, self.train,
                self.truly_random_erasing, self.instance_erasing,
                labels=np.asarray(raw.get("labels", []), np.int32),
                space_label=self.space_label, strong_aug=self.strong_aug,
                rotate_p=self.rotate_p, rotate_angle=self.rotate_angle, scales2=self.scales2,
                h_max=self.h_max)
            prepared.append({"image": img, "boxes": bx,
                             "labels": lab if lab is not None else raw.get("labels", []),
                             "text": raw.get("text", "")})
        return collate(prepared, self.max_targets, self.w_max, self.h_quant,
                       as_uint8=self.transfer_uint8)

    def _put(self, item) -> bool:
        """A bounded put that re-checks ``_stop``, so that ``stop()`` frees
        a worker waiting on a full queue."""
        while not self._stop:
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop:
            try:
                if not self._put(self._make_batch()):
                    return
            except StopIteration:
                self._put(None)
                return
            except Exception as exc:  # raised again in the consumer
                self._put(exc)
                return

    def __iter__(self) -> Iterator[Batch]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch

    def stop(self):
        self._stop = True
        try:  # drain, so that a worker blocked in put() sees _stop
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def make_batcher(cfg, source, train: bool, seed: int, space_label: int = -1,
                 reuse: int = 1, erasing: bool = False) -> BucketBatcher:
    """The recipe's batcher over ``source`` (sample dicts); ``erasing``
    adds the column and word erasings, which the pretraining takes from
    ``truly_random_erasing`` and the finetune leaves off."""
    return BucketBatcher(
        source, batch_size=cfg.batch_size, scales=cfg.data_aug_scales,
        max_size=cfg.data_aug_max_size, max_targets=cfg.max_targets, w_max=cfg.image_w_max,
        h_quant=cfg.h_quant, h_max=cfg.image_h_max, train=train, space_label=space_label,
        seed=seed, transfer_uint8=cfg.transfer_uint8,
        truly_random_erasing=erasing, instance_erasing=erasing, reuse=reuse)
