"""ResNet-50 trunk with GroupNorm (counterpart of
dtlr_tpu/models/resnet.py with ``norm_kind="group"``, the flagship
recipe's backbone). NCHW inside; submodule names follow the flax
parameter tree (unnamed GroupNorms are ``GroupNorm_<i>`` in creation
order) so that weights.py maps leaves by name.

With ``dtype=bfloat16`` the convolutions compute in bf16 and every
GroupNorm returns float32, as in JAX, so the residual sums and the
returned features are float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Conv, GroupNorm

STAGES = (3, 4, 6, 3)  # ResNet-50
WIDTH = 64
RETURN_INDICES = (1, 2, 3)  # layers 2-4


def group_norm(channels: int) -> GroupNorm:
    """The backbone's GroupNorm(32): eps 1e-5 (dtlr_tpu/models/resnet.py:56)."""
    return GroupNorm(channels, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 1, bias=False, dtype=dtype)
        self.GroupNorm_0 = group_norm(features)
        self.conv2 = Conv(features, features, 3, stride=stride, padding=1,
                          bias=False, dtype=dtype)
        self.GroupNorm_1 = group_norm(features)
        self.conv3 = Conv(features, features * 4, 1, bias=False, dtype=dtype)
        self.GroupNorm_2 = group_norm(features * 4)
        self.needs_proj = in_ch != features * 4 or stride != 1
        if self.needs_proj:
            self.downsample = Conv(in_ch, features * 4, 1, stride=stride,
                                   bias=False, dtype=dtype)
            self.GroupNorm_3 = group_norm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.conv1(x)))
        y = F.relu(self.GroupNorm_1(self.conv2(y)))
        y = self.GroupNorm_2(self.conv3(y))
        residual = self.GroupNorm_3(self.downsample(x)) if self.needs_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns the outputs of layers 2-4 (strides 8/16/32), NCHW."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(3, WIDTH, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.GroupNorm_0 = group_norm(WIDTH)
        self.stage_blocks = []
        in_ch = WIDTH
        for stage, blocks in enumerate(STAGES):
            feats = WIDTH * 2 ** stage
            names = []
            for blk in range(blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, Bottleneck(in_ch, feats, stride, dtype))
                names.append(name)
                in_ch = feats * 4
            self.stage_blocks.append(names)
        self.num_channels = [WIDTH * 2 ** i * 4 for i in RETURN_INDICES]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = F.relu(self.GroupNorm_0(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = []
        for names in self.stage_blocks:
            for name in names:
                y = getattr(self, name)(y)
            outputs.append(y)
        return tuple(outputs[i] for i in RETURN_INDICES)
