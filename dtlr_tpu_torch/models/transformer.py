"""Encoder, two-stage query selection and decoder with iterative box
refinement (counterpart of dtlr_tpu/models/transformer.py
with ``encoder_type="windowed"``, ``decoder_ca="dense"`` and
``dense_box_bias=True``: the flagship recipe).

Every decoder attention goes through ``flash_mha``: the cross-attention
with the box prior, and the self-attention, which has no mask at
inference or in CTC finetuning (no CDN queries), without it. On CUDA
both run the hand-written kernel.

Gradients stop where JAX's do (dtlr_tpu/models/transformer.py:423,469):
the decoder starts from the selected boxes detached, and each layer
refines the previous layer's box detached, while the returned
references keep each layer's undetached box and ``ref_enc`` the
undetached selection. So a loss reaches a layer's box head only through
that layer's own outputs.

``dtype`` is the compute dtype of every projection, as flax's: the
encoder's input, the position encodings and the learned content queries
enter in it, the norms return float32, and the heads' outputs are taken
to float32 before they meet the float32 anchors and references.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attn import make_box_prior
from ..utils.boxes import inverse_sigmoid
from .layers import MLP, Dense, LayerNorm, MultiHeadAttention
from .position_encoding import gen_sineembed_for_position
from .windowed_encoder import WindowedEncoderLayer


def get_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fraction of non-padded width and height per level: masks (B, H, W)
    True at padding -> (B, L, 2) in (w, h) order."""
    ratios = []
    for m in masks:
        valid_h = (~m[:, :, 0]).sum(1).float()
        valid_w = (~m[:, 0, :]).sum(1).float()
        ratios.append(torch.stack([valid_w / m.shape[2], valid_h / m.shape[1]], -1))
    return torch.stack(ratios, dim=1)


def gen_encoder_output_proposals(memory: torch.Tensor, padding_mask: torch.Tensor,
                                 spatial_shapes: Sequence[Tuple[int, int]]):
    """Grid anchors per level and the masked memory. A proposal on padding
    or outside the 0.01-0.99 band gets the finite logit 1e6. Returns
    (output_memory, output_proposals (unsigmoided cxcywh), valid)."""
    B = memory.shape[0]
    dev = memory.device
    proposals = []
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        mask_l = padding_mask[:, offset:offset + h * w].view(B, h, w)
        valid_h = (~mask_l[:, :, 0]).sum(1).float()
        valid_w = (~mask_l[:, 0, :]).sum(1).float()
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # (h, w, 2)
        scale = torch.stack([valid_w, valid_h], dim=-1).view(B, 1, 1, 2)
        grid = (grid[None] + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([grid, wh], dim=-1).view(B, -1, 4))
        offset += h * w
    output_proposals = torch.cat(proposals, dim=1)
    valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(-1, keepdim=True)
    output_proposals = torch.log(output_proposals / (1 - output_proposals))
    invalid = padding_mask[..., None] | ~valid
    output_proposals = output_proposals.masked_fill(invalid, 1e6)
    output_memory = memory.masked_fill(invalid, 0.0)
    return output_memory, output_proposals, ~invalid[..., 0]


def top_k_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, ties to the lower index,
    as ``jax.lax.top_k`` orders them."""
    return torch.argsort(scores, dim=-1, descending=True, stable=True)[..., :k]


class DecoderLayer(nn.Module):
    """Self-attention, dense cross-attention with the box prior, FFN."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048, n_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm2 = LayerNorm(d_model)
        self.ca_box_gamma = nn.Parameter(torch.zeros(n_heads))
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, d_ffn, dtype=dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, query_pos, reference_points_input, memory,
                spatial_shapes, key_bias, memory_pos):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        prior = make_box_prior(reference_points_input, spatial_shapes,
                               self.ca_box_gamma.exp())
        t2 = self.cross_attn(tgt + query_pos, memory + memory_pos, memory,
                             key_bias=key_bias, box_prior=prior)
        tgt = self.norm1(tgt + t2)
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DeformableTransformer(nn.Module):
    """Windowed encoder, two-stage top-k selection and decoder. ``forward``
    returns (hs, references, hs_enc, ref_enc, init_box_proposal) as the
    JAX module does, batch-major."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 d_ffn: int = 2048, num_feature_levels: int = 4,
                 num_queries: int = 900, encoder_win: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.compute_dtype = dtype
        self.num_queries = num_queries
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", WindowedEncoderLayer(
                d_model, d_ffn, n_heads, win=encoder_win, shift=bool(i % 2), dtype=dtype))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}",
                            DecoderLayer(d_model, d_ffn, n_heads, dtype))
        self.decoder_norm = LayerNorm(d_model)
        self.enc_output = Dense(d_model, d_model, dtype=dtype)
        self.enc_output_norm = LayerNorm(d_model)
        self.tgt_embed = nn.Parameter(torch.zeros(num_queries, d_model))
        self.ref_point_head = MLP(2 * d_model, d_model, d_model, 2, dtype)

    def forward(self, srcs: List[torch.Tensor], masks: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], enc_class_head: nn.Module,
                enc_bbox_head: nn.Module, bbox_head: nn.Module):
        """srcs, pos_embeds per level (B, H, W, C); masks (B, H, W) True at
        padding; ``bbox_head`` is the box head shared by all decoder layers."""
        B = srcs[0].shape[0]
        C = self.d_model
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(B, -1, C) for s in srcs], dim=1).to(self.compute_dtype)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks], dim=1)
        pos_flat = torch.cat([(p + self.level_embed[lvl]).reshape(B, -1, C)
                              for lvl, p in enumerate(pos_embeds)], dim=1).to(self.compute_dtype)
        valid_ratios = get_valid_ratios(masks)

        memory = src_flat
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer_{i}")(
                memory, pos_flat, spatial_shapes, mask_flat)

        # two-stage selection
        output_memory, output_proposals, proposal_valid = gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        output_memory = self.enc_output_norm(self.enc_output(output_memory))
        enc_outputs_class = enc_class_head(output_memory)
        enc_outputs_coord = enc_bbox_head(output_memory).float() + output_proposals
        scores = enc_outputs_class.float().max(-1).values.masked_fill(~proposal_valid, -1e9)
        topk_idx = top_k_stable(scores, self.num_queries)

        def take(arr):
            return torch.gather(arr, 1, topk_idx[..., None].expand(-1, -1, arr.shape[-1]))

        refpoint_embed = take(enc_outputs_coord)  # (B, nq, 4) unsigmoided
        init_box_proposal = take(output_proposals).sigmoid()
        tgt_undetach = take(output_memory)

        # decoder
        key_bias = torch.zeros(mask_flat.shape, dtype=torch.float32,
                               device=mask_flat.device).masked_fill(mask_flat, -1e9)
        ratios4 = torch.cat([valid_ratios, valid_ratios], dim=-1)[:, None]  # (B, 1, L, 4)
        # the decoder starts from the selected boxes with their gradient
        # stopped; only ref_enc (below) keeps it, as JAX's
        # stop_gradient(refpoint_embed_undetach) does
        reference_points = refpoint_embed.detach().sigmoid()
        ref_points = [reference_points]
        intermediate = []
        out_dec = self.tgt_embed[None].expand(B, -1, -1).to(self.compute_dtype)
        for lid in range(self.num_decoder_layers):
            ref_input = reference_points[:, :, None, :] * ratios4  # (B, nq, L, 4)
            query_pos = self.ref_point_head(
                gen_sineembed_for_position(ref_input[:, :, 0, :], dim=C // 2))
            out_dec = getattr(self, f"decoder_layer_{lid}")(
                out_dec, query_pos, ref_input, memory, spatial_shapes, key_bias,
                pos_flat)
            delta = bbox_head(out_dec).float()
            new_ref = (delta + inverse_sigmoid(reference_points)).sigmoid()
            # the next layer refines a stopped box; the outputs keep new_ref
            reference_points = new_ref.detach()
            ref_points.append(new_ref)
            intermediate.append(self.decoder_norm(out_dec))

        hs = torch.stack(intermediate)        # (n_dec, B, nq, C)
        references = torch.stack(ref_points)  # (n_dec + 1, B, nq, 4) sigmoided
        return hs, references, tgt_undetach[None], refpoint_embed.sigmoid()[None], \
            init_box_proposal
