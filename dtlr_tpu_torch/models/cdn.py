"""Contrastive denoising (CDN) queries with a static layout (counterpart
of dtlr_tpu/models/cdn.py).

Targets come padded to ``n_max`` with a validity mask. There are ``G =
cdn_num_groups(dn_number, n_max)`` groups of ``2 * n_max`` queries, so
the DN prefix before the matching queries has ``pad = G * 2 * n_max``
slots: slot ``g*2*n_max + i`` is target i's positive in group g, slot
``g*2*n_max + n_max + i`` its negative. Invalid target slots get zero
queries; the loss leaves them out through the validity mask.

Matching queries cannot see DN queries, and DN groups cannot see each
other. ``cdn_query_groups`` gives that mask in the form the attention
kernel takes: one int32 group per query, the DN group in the prefix and
-1 for the matching queries; a score (row r, key c) is blocked when
``group[c] >= 0 and group[c] != group[r]``. ``cdn_attn_mask`` is the same
mask as a (Q, Q) bool array.

The noise comes from four draws, as JAX splits its key four ways
(dtlr_tpu/models/cdn.py:80): a uniform per slot for the label flip, a
random label per slot, a sign and a magnitude per box coordinate.
``draw_cdn_noise`` makes them from a ``torch.Generator``; ``prepare_cdn``
also takes them as given (``CdnDraws``), so that a test can hand it JAX's.
A data-parallel rank draws the global batch's and keeps its rows
(``rows``, ``take_rows``): JAX draws once for the sharded global batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.boxes import inverse_sigmoid


class CdnMeta(NamedTuple):
    pad_size: int       # DN prefix length
    num_groups: int     # groups of positives and negatives
    n_max: int          # positives per group


class CdnDraws(NamedTuple):
    """The noise of one ``prepare_cdn`` call, shapes (B, G, 2, N[, 4])."""

    flip: torch.Tensor   # (B, G, 2, N) uniform [0, 1): label flip if < ratio / 2
    label: torch.Tensor  # (B, G, 2, N) int: the label a flipped slot takes
    sign: torch.Tensor   # (B, G, 2, N, 4) float, -1 or +1
    mag: torch.Tensor    # (B, G, 2, N, 4) uniform [0, 1)


def cdn_num_groups(dn_number: int, n_max: int) -> int:
    """The reference's dn_number*2 // (2*max_cnt) with the static target
    capacity, at least 1."""
    return max(1, (2 * dn_number) // (2 * n_max))


def cdn_query_groups(num_queries: int, meta: CdnMeta,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(pad + num_queries,) int32: q // (2 n_max) in the DN prefix, -1 for
    the matching queries."""
    pad = meta.pad_size
    dn = torch.arange(pad, dtype=torch.int32, device=device) // (2 * meta.n_max)
    return torch.cat([dn, torch.full((num_queries,), -1, dtype=torch.int32, device=device)])


def cdn_attn_mask(num_queries: int, meta: CdnMeta,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """(Q, Q) bool, True = blocked, Q = pad_size + num_queries."""
    pad, group = meta.pad_size, 2 * meta.n_max
    Q = pad + num_queries
    mask = torch.zeros((Q, Q), dtype=torch.bool, device=device)
    # matching queries cannot see DN queries
    mask[pad:, :pad] = True
    # DN groups cannot see each other
    rows = torch.arange(pad, device=device)
    row_group = rows // group
    col_group = torch.cat([row_group, torch.full((num_queries,), -1, dtype=row_group.dtype,
                                                 device=device)])
    mask[:pad, :] = (col_group[None, :] >= 0) & (col_group[None, :] != row_group[:, None])
    return mask


def draw_cdn_noise(batch: int, n_max: int, dn_number: int, num_classes: int,
                   generator: Optional[torch.Generator] = None,
                   device: Optional[torch.device] = None,
                   rows: Optional[slice] = None) -> CdnDraws:
    """The four draws of one ``prepare_cdn`` call from ``generator`` (on
    its device; the default generator without one), moved to ``device``.
    ``rows``: a data-parallel rank's rows of the global batch of
    ``batch`` lines, drawn whole as one process draws it and then cut, so
    that the ranks together draw what one process draws."""
    G = cdn_num_groups(dn_number, n_max)
    gen_dev = generator.device if generator is not None else device
    shape = (batch, G, 2, n_max)
    flip = torch.rand(shape, generator=generator, device=gen_dev)
    label = torch.randint(0, num_classes, shape, generator=generator, device=gen_dev,
                          dtype=torch.int32)
    sign = torch.randint(0, 2, shape + (4,), generator=generator, device=gen_dev).float() * 2 - 1
    mag = torch.rand(shape + (4,), generator=generator, device=gen_dev)
    draws = CdnDraws(*(t.to(device) for t in (flip, label, sign, mag)))
    return draws if rows is None else take_rows(draws, rows)


def take_rows(draws: CdnDraws, rows: slice) -> CdnDraws:
    """The draws of a batch's ``rows``."""
    return CdnDraws(*(t[rows] for t in draws))


def prepare_cdn(labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                label_enc: torch.Tensor, dn_number: int, label_noise_ratio: float,
                box_noise_scale: float, num_classes: int,
                noise: Optional[CdnDraws | torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, CdnMeta]:
    """labels (B, N) int, boxes (B, N, 4) cxcywh in [0, 1], valid (B, N)
    bool, label_enc (labelbook, C) -> (input_query_label (B, pad, C),
    input_query_bbox (B, pad, 4) unsigmoided, meta). ``noise`` is the four
    draws, or the generator to draw them from."""
    B, N = labels.shape
    dev = labels.device
    G = cdn_num_groups(dn_number, N)
    pad = G * 2 * N
    meta = CdnMeta(pad_size=pad, num_groups=G, n_max=N)
    if not isinstance(noise, CdnDraws):
        noise = draw_cdn_noise(B, N, dn_number, num_classes, noise, dev)

    lab = labels.long()[:, None, None, :].expand(B, G, 2, N)
    box = boxes.float()[:, None, None, :, :].expand(B, G, 2, N, 4)
    val = valid[:, None, None, :].expand(B, G, 2, N)

    # label noise on even slots only, the reference's index-parity gate
    # (dtlr_tpu/models/cdn.py:88-94): an effective p = ratio / 2
    gate = torch.arange(pad, device=dev).view(G, 2, N) % 2 == 0
    flip = (noise.flip < label_noise_ratio * 0.5) & gate[None]
    noised_lab = torch.where(flip, noise.label.long(), lab)

    # box noise: corners jittered by +-mag*wh/2*scale; negatives (the second
    # half of each group) get a magnitude in (1, 2]
    if box_noise_scale > 0:
        xy, wh = box[..., :2], box[..., 2:]
        corners = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        diff = torch.cat([wh / 2, wh / 2], dim=-1)
        is_neg = torch.zeros((G, 2, N), dtype=torch.bool, device=dev)
        is_neg[:, 1, :] = True
        mag = noise.mag + is_neg[None, ..., None].to(noise.mag.dtype)
        corners = corners + noise.sign * mag * diff * box_noise_scale
        corners = corners.clamp(0.0, 1.0)
        noised_box = torch.cat([(corners[..., :2] + corners[..., 2:]) / 2,
                                corners[..., 2:] - corners[..., :2]], dim=-1)
    else:
        noised_box = box

    keep = val.reshape(B, pad)[..., None]
    emb = label_enc[noised_lab.reshape(B, pad)]
    emb = torch.where(keep, emb, torch.zeros((), dtype=emb.dtype, device=dev))
    qbox = inverse_sigmoid(noised_box.reshape(B, pad, 4))
    qbox = torch.where(keep, qbox, torch.zeros((), dtype=qbox.dtype, device=dev))
    return emb, qbox, meta
