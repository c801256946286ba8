"""Multi-scale deformable attention sampling (counterpart of
dtlr_tpu/ops/deform_attn.py).

The semantics of the JAX cores, not their TPU packing: bilinear
sampling with pixel centres at (i + 0.5) / size, corners outside the
level contributing zero, as ``F.grid_sample(align_corners=False,
padding_mode="zeros")``. JAX packs the four corners of a sample into one
gathered row (``_sample_level_packed``, the quads of
``deform_attn_xla_shared``) because TPU gathers are bound by their row
rate; on the card and the CPU plain torch ops take the corners as they
come. JAX left this core to XLA (no Pallas kernel), so it is plain torch
here too, on the card as on the CPU.

Precision, as JAX's: the value rows arrive rounded to the compute dtype
(the value projection's output), the locations and attention weights are
float32, and so is the bilinear and attention arithmetic. In the
head-shared core the folded weight (bilinear corner weight times the
head's attention weight) is rounded to the value's dtype before the
contraction (dtlr_tpu/ops/deform_attn.py:266-271), so under bfloat16 it
is a bf16 weight, accumulated in float32 over a sample's corners, points
and levels.

``spatial_shapes`` is a tuple of (H, W) ints per level.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.nn import functional as F


def level_splits(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """Each level's size H*W and its first row in the flattened S axis."""
    sizes = [h * w for h, w in spatial_shapes]
    starts = [0]
    for s in sizes[:-1]:
        starts.append(starts[-1] + s)
    return sizes, starts


def deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor) -> torch.Tensor:
    """The per-head core (``deform_attn_xla``): value (B, S, M, D),
    sampling_locations (B, Lq, M, L, P, 2) in [0, 1] as (x, y),
    attention_weights (B, Lq, M, L, P) -> (B, Lq, M*D) float32.

    One ``grid_sample`` per level on the level's value rows in float32,
    (B*M, D, H, W), at the heads' (B*M, Lq, P) points; what the backward
    keeps per level is the sampled (B*M, D, Lq, P) float32 tensor."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    sizes, starts = level_splits(spatial_shapes)
    if L != len(spatial_shapes) or sum(sizes) != S:
        raise ValueError(f"levels {tuple(spatial_shapes)} do not fit S={S}, L={L}")
    grids = (2.0 * sampling_locations.float() - 1.0).permute(0, 2, 3, 1, 4, 5)  # (B,M,L,Lq,P,2)
    attn = attention_weights.float().permute(0, 2, 3, 1, 4)  # (B, M, L, Lq, P)
    out = None
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, starts[lvl]:starts[lvl] + sizes[lvl]].float()  # (B, HW, M, D)
        v = v.permute(0, 2, 3, 1).reshape(B * M, D, h, w)
        sampled = F.grid_sample(v, grids[:, :, lvl].reshape(B * M, Lq, P, 2),
                                mode="bilinear", padding_mode="zeros", align_corners=False)
        part = torch.einsum("ndqp,nqp->nqd", sampled, attn[:, :, lvl].reshape(B * M, Lq, P))
        out = part if out is None else out + part
    return out.view(B, M, Lq, D).permute(0, 2, 1, 3).reshape(B, Lq, M * D)


def _corners(loc: torch.Tensor, h: int, w: int):
    """The four bilinear corners of float32 locations (..., 2) on an
    (h, w) level: flat indices within the level (clamped; a corner
    outside it has weight zero) and weights, each (..., 4), in the order
    (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    idx, wgt = [], []
    for dy, dx, wy, wx in ((0, 0, 1 - ly, 1 - lx), (0, 1, 1 - ly, lx),
                           (1, 0, ly, 1 - lx), (1, 1, ly, lx)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx.append(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
        wgt.append(wy * wx * valid.float())
    return torch.stack(idx, -1), torch.stack(wgt, -1)


def deform_attn_shared(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """The head-shared core (``deform_attn_xla_shared``): value (B, S, C)
    with the heads not split, sampling_locations (B, Lq, L, P, 2) shared
    by the heads, attention_weights (B, Lq, M, L, P) per head ->
    (B, Lq, C) float32.

    One row gather of every sample's four corners (each a full C-wide
    row), and one contraction with the folded weights in the value's
    dtype, accumulated in float32."""
    B, S, C = value.shape
    _, Lq, L, P, _ = sampling_locations.shape
    M = n_heads
    D = C // M
    sizes, starts = level_splits(spatial_shapes)
    if L != len(spatial_shapes) or sum(sizes) != S:
        raise ValueError(f"levels {tuple(spatial_shapes)} do not fit S={S}, L={L}")
    loc = sampling_locations.float()
    idxs, wgts = [], []
    for lvl, (h, w) in enumerate(spatial_shapes):
        idx, wgt = _corners(loc[:, :, lvl], h, w)  # (B, Lq, P, 4)
        idxs.append(idx + starts[lvl])
        wgts.append(wgt)
    idx = torch.stack(idxs, 2)  # (B, Lq, L, P, 4)
    wgt = torch.stack(wgts, 2)
    rows = idx + torch.arange(B, device=idx.device).view(B, 1, 1, 1, 1) * S
    g = value.reshape(B * S, C).index_select(0, rows.reshape(-1))
    g = g.view(B, Lq, L * P * 4, M, D).permute(0, 1, 3, 2, 4)  # (B, Lq, M, LP4, D)
    w4 = (wgt.reshape(B, Lq, 1, L * P, 4)
          * attention_weights.float().reshape(B, Lq, M, L * P, 1))  # (B, Lq, M, LP, 4)
    # the folded weight rounded to the value's dtype; the products of two
    # values of that dtype are exact in float32, so the float32
    # contraction is JAX's float32 accumulation
    w4 = w4.to(value.dtype).float().reshape(B, Lq, M, 1, L * P * 4)
    out = torch.matmul(w4, g.float())  # (B, Lq, M, 1, D)
    return out.reshape(B, Lq, C)
