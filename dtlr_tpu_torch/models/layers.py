"""Dense, conv and norm layers with flax's ``dtype`` semantics, the MLP
and multi-head attention (counterpart of dtlr_tpu/models/layers.py).

flax's ``DenseGeneral((M, D))`` q/k/v projections are ``nn.Linear(C, M*D)``
here and its ``out_proj`` over the (M, D) axes is ``nn.Linear(M*D, C)``;
weights.py reshapes the kernels accordingly. The attention core is
``flash_mha``: the decoder is the only user, and without CDN (inference
and CTC finetuning) neither of its attentions takes a mask, only key
padding and the box prior.

Compute dtype: a flax ``Dense``/``Conv`` with ``dtype=bfloat16`` casts its
input, kernel and bias to bf16 and returns bf16, while its parameters
stay float32; ``Dense`` and ``Conv`` below do the same at the call. The
recipe's norms compute in float32 and return float32 whatever comes in:
``LayerNorm(dtype=float32)`` explicitly, and the GroupNorms because their
float32 parameters promote a bf16 input (the backbone's get
``make_norm``'s default ``dtype=float32``, dtlr_tpu/models/resnet.py:50,56;
the input projections' have none, dtlr_tpu/models/dino.py:154).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attn import BoxPrior, flash_mha


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: flax ``nn.Dense(dtype=...)``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``: flax ``nn.Conv(dtype=...)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=float32)``: eps 1e-6, float32 in and out."""

    def __init__(self, d_model: int):
        super().__init__(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) with float32 parameters: float32 in and out."""

    def __init__(self, channels: int, eps: float):
        super().__init__(32, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class MLP(nn.Module):
    """ReLU MLP whose layers are named ``layers_<i>`` as in flax."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

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
    (B, S), the box prior as a ``BoxPrior``. The projections compute in
    ``dtype``; ``flash_mha`` takes their bf16 or fp32 heads and returns
    fp32, cast back to ``dtype`` before ``out_proj`` as in
    dtlr_tpu/models/layers.py:183."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.compute_dtype = dtype
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, q, k, v, key_bias: Optional[torch.Tensor] = None,
                box_prior: Optional[BoxPrior] = None) -> torch.Tensor:
        B, Lq, C = q.shape
        S = k.shape[1]
        M = self.n_heads
        D = C // M
        # (B, M, Q, D) views of the projections' (B, Q, M, D) rows: the
        # kernel reads them in place through their strides
        qh = self.q_proj(q).view(B, Lq, M, D).transpose(1, 2)
        kh = self.k_proj(k).view(B, S, M, D).transpose(1, 2)
        vh = self.v_proj(v).view(B, S, M, D).transpose(1, 2)
        if key_bias is None:
            key_bias = torch.zeros(B, S, dtype=torch.float32, device=q.device)
        out = flash_mha(qh, kh, vh, key_bias, box_prior)
        # on CUDA ``out`` is laid out as (B, Q, M, D) and the cast keeps that
        # layout, so the transpose and reshape below are views
        return self.out_proj(out.to(self.compute_dtype).transpose(1, 2).reshape(B, Lq, C))
