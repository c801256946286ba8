"""Dense, conv and norm layers with flax's ``dtype`` semantics, the MLP,
multi-head attention and multi-scale deformable attention (counterpart
of dtlr_tpu/models/layers.py).

flax's ``DenseGeneral((M, D))`` q/k/v projections are ``nn.Linear(C, M*D)``
here and its ``out_proj`` over the (M, D) axes is ``nn.Linear(M*D, C)``;
weights.py reshapes the kernels accordingly. The attention core is
``flash_mha``: the decoder is the only user. Its cross-attention takes key
padding and the box prior; its self-attention takes the CDN group mask
in a detection training step and no mask otherwise (inference, CTC
finetuning).

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

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.deform_attn import deform_attn, deform_attn_shared
from ..ops.flash_attn import BoxPrior, flash_mha


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: flax ``nn.Dense(dtype=...)``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``: flax ``nn.Conv(dtype=...)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, groups=groups)
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
    (B, S), the box prior as a ``BoxPrior``, the CDN mask of the
    self-attention as (Q,) int32 ``query_group``. The projections compute in
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
                box_prior: Optional[BoxPrior] = None,
                query_group: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        out = flash_mha(qh, kh, vh, key_bias, box_prior, query_group)
        # on CUDA ``out`` is laid out as (B, Q, M, D) and the cast keeps that
        # layout, so the transpose and reshape below are views
        return self.out_proj(out.to(self.compute_dtype).transpose(1, 2).reshape(B, Lq, C))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (dtlr_tpu/models/layers.py:60-137):
    query (B, Lq, C), reference points (B, Lq, L, 2) normalized or
    (B, Lq, L, 4) boxes (cxcywh) in [0, 1], the flattened levels
    (B, S, C) with their (H, W) shapes, and the padding mask (B, S) True
    at padding -> (B, Lq, C) in ``dtype``.

    ``value_proj`` and ``output_proj`` compute in ``dtype``; the sampling
    offsets and attention weights in float32 on the query cast to float32,
    whatever ``dtype`` is. With ``shared_offsets`` one offset group serves
    every head (``deform_attn_shared``); the attention weights stay per
    head. 2-d reference points take offsets in pixels of each level;
    4-d ones take them relative to the box, ``offsets / P * wh * 0.5``."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, shared_offsets: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.shared_offsets = shared_offsets
        self.compute_dtype = dtype
        groups = 1 if shared_offsets else n_heads
        self.sampling_offsets = Dense(d_model, groups * n_levels * n_points * 2)
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points)
        self.value_proj = Dense(d_model, d_model, dtype=dtype)
        self.output_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                input_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Lq, _ = query.shape
        S, C = input_flatten.shape[1:]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        q = query.float()
        offsets = self.sampling_offsets(q).view(B, Lq, -1, L, P, 2)
        attn = F.softmax(self.attention_weights(q).view(B, Lq, M, L * P), dim=-1)
        attn = attn.view(B, Lq, M, L, P)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=torch.float32, device=ref.device)
            loc = ref[:, :, None, :, None, :] + offsets / normalizer[:, None, :]
        elif ref.shape[-1] == 4:
            loc = (ref[:, :, None, :, None, :2]
                   + offsets / P * ref[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError(f"reference points end in 2 or 4 values, got {ref.shape[-1]}")
        if self.shared_offsets:
            out = deform_attn_shared(value, spatial_shapes, loc[:, :, 0], attn, M)
        else:
            out = deform_attn(value.view(B, S, M, C // M), spatial_shapes, loc, attn)
        return self.output_proj(out.to(self.compute_dtype))
