"""MLP and multi-head attention (counterpart of dtlr_tpu/models/layers.py).

flax's ``DenseGeneral((M, D))`` q/k/v projections are ``nn.Linear(C, M*D)``
here and its ``out_proj`` over the (M, D) axes is ``nn.Linear(M*D, C)``;
weights.py reshapes the kernels accordingly. The attention core is
``flash_mha``: the decoder is the only user, and at inference neither of
its attentions takes a mask, only key padding and the box prior.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attn import BoxPrior, flash_mha


class MLP(nn.Module):
    """ReLU MLP whose layers are named ``layers_<i>`` as in flax."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Multi-head attention with q/k/v/out projections around
    ``flash_mha`` (the hand-written kernel on CUDA tensors, its plain
    version on the CPU): key padding comes as the additive ``key_bias``
    (B, S), the box prior as a ``BoxPrior``."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_bias: Optional[torch.Tensor] = None,
                box_prior: Optional[BoxPrior] = None) -> torch.Tensor:
        B, Lq, C = q.shape
        S = k.shape[1]
        M = self.n_heads
        D = C // M
        qh = self.q_proj(q).view(B, Lq, M, D).transpose(1, 2)  # (B, M, Q, D)
        kh = self.k_proj(k).view(B, S, M, D).transpose(1, 2)
        vh = self.v_proj(v).view(B, S, M, D).transpose(1, 2)
        if key_bias is None:
            key_bias = torch.zeros(B, S, dtype=torch.float32, device=q.device)
        out = flash_mha(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                        key_bias, box_prior)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))
