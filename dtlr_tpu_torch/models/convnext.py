"""ConvNeXt backbone (counterpart of dtlr_tpu/models/convnext.py; reference
models/dino/convnext.py:55-251, selected by backbone='convnext_xlarge_22k').

NHWC inside, as in JAX; ``ConvNeXt`` takes and returns NCHW as
``resnet.ResNet`` does. Submodules carry the flax names (``stem_conv``,
``stem_norm``, ``down_norm{s}``, ``down_conv{s}``, ``stage{s}_block{b}``,
``out_norm{s}``). As in the JAX module: the stem (4x4, stride 4) and the
downsamplings (2x2, stride 2) pad as XLA's 'SAME' does
(``swin.same_pad``); the depthwise 7x7 convolution pads 3 on each side;
LayerNorms have epsilon 1e-6 and compute in float32; GELU is the tanh
approximation; the layer scale ``gamma`` multiplies the block's output
in its dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Conv, Dense, LayerNorm
from .swin import same_pad

#: the layer scale ``gamma``'s initial value (flax's constant)
LAYER_SCALE = 1e-6


def nchw(conv: nn.Module, x: torch.Tensor, pad=None) -> torch.Tensor:
    """An NCHW convolution on an NHWC tensor, NHWC out; ``pad`` (kernel,
    stride) pads as 'SAME' first."""
    x = x.permute(0, 3, 1, 2)
    if pad is not None:
        x = same_pad(x, *pad)
    return conv(x).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(nchw(self.dwconv, x))
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="tanh"))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (256, 512, 1024, 2048),
                 return_indices: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.return_indices = tuple(return_indices)
        prev = 3
        for st, (depth, dim) in enumerate(zip(depths, dims)):
            if st == 0:
                self.stem_conv = Conv(3, dim, 4, stride=4, dtype=dtype)
                self.stem_norm = LayerNorm(dim)
            else:
                self.add_module(f"down_norm{st}", LayerNorm(prev))
                self.add_module(f"down_conv{st}", Conv(prev, dim, 2, stride=2, dtype=dtype))
            for b in range(depth):
                self.add_module(f"stage{st}_block{b}", ConvNeXtBlock(dim, dtype))
            self.add_module(f"out_norm{st}", LayerNorm(dim))
            prev = dim
        self.num_channels = [dims[i] for i in self.return_indices]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 2, 3, 1)
        outs = []
        for st, depth in enumerate(self.depths):
            if st == 0:
                x = self.stem_norm(nchw(self.stem_conv, x, (4, 4)))
            else:
                x = nchw(getattr(self, f"down_conv{st}"), getattr(self, f"down_norm{st}")(x),
                         (2, 2))
            for b in range(depth):
                x = getattr(self, f"stage{st}_block{b}")(x)
            if st in self.return_indices:
                outs.append(getattr(self, f"out_norm{st}")(x).permute(0, 3, 1, 2))
        return tuple(outs)


CONVNEXT_CONFIGS = {
    "convnext_xlarge_22k": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
    "convnext_large_22k": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "convnext_base_22k": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
}


def build_convnext(name: str, return_indices=(1, 2, 3),
                   dtype: torch.dtype = torch.float32) -> ConvNeXt:
    if name not in CONVNEXT_CONFIGS:
        raise ValueError(f"unknown convnext variant {name!r}")
    return ConvNeXt(return_indices=return_indices, dtype=dtype, **CONVNEXT_CONFIGS[name])
