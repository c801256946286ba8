"""Sine positional embeddings (counterpart of
dtlr_tpu/models/position_encoding.py)."""

from __future__ import annotations

import math

import torch


def _interleave_sin_cos(e: torch.Tensor) -> torch.Tensor:
    """(..., F) -> (..., F): sin of the even features and cos of the odd
    ones, stacked pairwise and flattened."""
    return torch.stack([e[..., 0::2].sin(), e[..., 1::2].cos()], dim=-1).flatten(-2)


def sine_position_embedding_hw(
    pad_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature_h: float = 20.0,
    temperature_w: float = 20.0,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """pad_mask (B, H, W), True at padding -> (B, H, W, 2*num_pos_feats):
    cumulative sums over valid pixels, normalized by the last one, then
    interleaved sin/cos with per-axis temperatures, y features first."""
    not_mask = (~pad_mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim = torch.arange(num_pos_feats, dtype=torch.float32, device=pad_mask.device)
    expo = 2 * torch.div(dim, 2, rounding_mode="floor") / num_pos_feats
    pos_x = _interleave_sin_cos(x_embed[..., None] / temperature_w ** expo)
    pos_y = _interleave_sin_cos(y_embed[..., None] / temperature_h ** expo)
    return torch.cat([pos_y, pos_x], dim=3)


def gen_sineembed_for_position(pos: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Sine embedding of normalized cxcywh boxes: (..., 4) -> (..., 4*dim)
    in the order y, x, w, h (reference models/dino/utils.py:141-167)."""
    dim_t = torch.arange(dim, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)

    def embed(coord):
        return _interleave_sin_cos(coord[..., None] * (2 * math.pi) / dim_t)

    return torch.cat([embed(pos[..., i]) for i in (1, 0, 2, 3)], dim=-1)
