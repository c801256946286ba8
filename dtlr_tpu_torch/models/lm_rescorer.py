"""Self-attention LM rescorer over detected character features (counterpart
of dtlr_tpu/models/lm_rescorer.py; reference models/LM_model.py:8-130,
SelfAttentionModel): a 4-layer pre-norm transformer encoder over
per-character feature vectors with a sinusoidal positional encoding of
the boxes' x-centres, scoring character classes. An auxiliary model: no
train or eval path of the JAX package or the reference calls it.

The attention is flax's ``MultiHeadDotProductAttention`` (plain torch, as
JAX computes it outside any kernel): ``query``, ``key`` and ``value`` are
flax ``DenseGeneral`` (C, M, D) kernels and ``out`` an (M, D, C) one,
which weights.py reshapes into the ``nn.Linear`` layouts here; the query
is scaled by 1/sqrt(D) before the product; a masked score is float32's
lowest value, so a fully padded row attends uniformly, as in flax.
Submodule names are flax's (``input_proj``, ``norm1_<i>``, ``attn_<i>``,
``norm2_<i>``, ``ffn1_<i>``, ``ffn2_<i>``, ``final_norm``, ``classifier``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Dense, LayerNorm


def box_x_positional_encoding(x_centers: torch.Tensor, d_model: int) -> torch.Tensor:
    """(B, N) x-centres in [0, 1] -> (B, N, d_model) float32 sine PE
    (reference LM_model.py:8-27 over scaled x positions)."""
    pos = x_centers.float()[..., None] * 100.0
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=x_centers.device)
    div = torch.exp(-math.log(10000.0) * 2 * dim / d_model)
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with q = k = v input."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.query = Dense(d_model, d_model, dtype=dtype)
        self.key = Dense(d_model, d_model, dtype=dtype)
        self.value = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, N, C); ``mask`` (B, 1, 1, N), True = attend."""
        B, N, C = x.shape
        M = self.n_heads
        D = C // M
        heads = lambda t: t.view(B, N, M, D).transpose(1, 2)  # (B, M, N, D)
        q = heads(self.query(x))
        k, v = heads(self.key(x)), heads(self.value(x))
        q = q / torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
        w = q @ k.transpose(-2, -1)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = F.softmax(w, dim=-1)
        out = (w @ v).transpose(1, 2).reshape(B, N, C)
        return self.out(out)


class SelfAttentionRescorer(nn.Module):
    def __init__(self, in_features: int, num_classes: int, d_model: int = 256,
                 n_heads: int = 8, n_layers: int = 4, d_ffn: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_layers = d_model, n_layers
        self.input_proj = Dense(in_features, d_model, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"norm1_{i}", LayerNorm(d_model))
            self.add_module(f"attn_{i}", DotProductAttention(d_model, n_heads, dtype))
            self.add_module(f"norm2_{i}", LayerNorm(d_model))
            self.add_module(f"ffn1_{i}", Dense(d_model, d_ffn, dtype=dtype))
            self.add_module(f"ffn2_{i}", Dense(d_ffn, d_model, dtype=dtype))
        self.final_norm = LayerNorm(d_model)
        self.classifier = Dense(d_model, num_classes, dtype=dtype)

    def forward(self, features: torch.Tensor, x_centers: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """features (B, N, C), x_centers (B, N), pad_mask (B, N) True at
        padding -> logits (B, N, K)."""
        h = self.input_proj(features)
        h = h + box_x_positional_encoding(x_centers, self.d_model).to(h.dtype)
        mask = None if pad_mask is None else ~pad_mask[:, None, None, :]
        for i in range(self.n_layers):
            q = getattr(self, f"norm1_{i}")(h)
            h = h + getattr(self, f"attn_{i}")(q, mask)
            f = getattr(self, f"norm2_{i}")(h)
            f = getattr(self, f"ffn2_{i}")(F.relu(getattr(self, f"ffn1_{i}")(f)))
            h = h + f
        return self.classifier(self.final_norm(h))
