"""Pixel preparation on the device (counterpart of dtlr_tpu/ops/pixels.py).

uint8 lines are ImageNet-normalized as pixel/255 and everything outside
each image's ``valid_hw`` is set to 0.0, as the host path pads the
normalized buffer with zeros.
"""

from __future__ import annotations

import torch

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def prep_images(images: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> float32 normalized, padded region zeroed.
    Float input is taken as already normalized and returned as is."""
    if images.dtype != torch.uint8:
        return images
    B, H, W, _ = images.shape
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(_STD, dtype=torch.float32, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    rows = torch.arange(H, device=images.device).view(1, H, 1, 1)
    cols = torch.arange(W, device=images.device).view(1, 1, W, 1)
    valid_hw = valid_hw.to(images.device)
    mask = (rows < valid_hw[:, 0].view(B, 1, 1, 1)) & (
        cols < valid_hw[:, 1].view(B, 1, 1, 1))
    return torch.where(mask, x, torch.zeros((), device=images.device))
