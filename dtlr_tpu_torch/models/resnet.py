"""ResNet-50/101 trunk with GroupNorm or FrozenBatchNorm (counterpart of
dtlr_tpu/models/resnet.py). NCHW inside; submodule names follow the flax
parameter tree (unnamed norms are ``GroupNorm_<i>`` or
``FrozenBatchNorm_<i>`` in creation order: conv1-3, then the
downsample) so that weights.py maps leaves by name.

With ``dtype=bfloat16`` the convolutions compute in bf16. Every
GroupNorm returns float32, as in JAX, so under GroupNorm (the flagship
recipe) the residual sums and the returned features are float32; a
FrozenBatchNorm returns its input's dtype (dtlr_tpu/models/resnet.py:49),
so under it (the reference's recipe) they are bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Conv, GroupNorm

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
WIDTH = 64
RETURN_INDICES = (1, 2, 3)  # layers 2-4
#: ``batch_norm_type`` values and the flax module name of each norm
NORM_NAMES = {"group": "GroupNorm", "FrozenBatchNorm2d": "FrozenBatchNorm",
              "frozen_bn": "FrozenBatchNorm"}


def group_norm(channels: int) -> GroupNorm:
    """The backbone's GroupNorm(32): eps 1e-5 (dtlr_tpu/models/resnet.py:56)."""
    return GroupNorm(channels, eps=1e-5)


class FrozenBatchNorm(nn.Module):
    """Batch norm with constant statistics (dtlr_tpu/models/resnet.py:28-49):
    ``x * w + b`` in float32 with ``w = weight / sqrt(var + 1e-5)`` and
    ``b = bias - mean * w``, returned in the input's dtype. ``weight`` is
    flax's ``scale``. The four are parameters, as in JAX, so that their
    gradients enter the clip's global norm; the optimizer's ``frozen``
    group never updates them (train/optim.py)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / torch.sqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        return (x.float() * w[:, None, None] + b[:, None, None]).to(x.dtype)


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "group":
        return group_norm(channels)
    if NORM_NAMES.get(kind) == "FrozenBatchNorm":
        return FrozenBatchNorm(channels)
    raise ValueError(f"unknown norm kind {kind!r}")


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm_kind: str = "group"):
        super().__init__()
        norm = NORM_NAMES[norm_kind]
        self.norms = [f"{norm}_{i}" for i in range(4)]
        self.conv1 = Conv(in_ch, features, 1, bias=False, dtype=dtype)
        self.add_module(self.norms[0], make_norm(norm_kind, features))
        self.conv2 = Conv(features, features, 3, stride=stride, padding=1,
                          bias=False, dtype=dtype)
        self.add_module(self.norms[1], make_norm(norm_kind, features))
        self.conv3 = Conv(features, features * 4, 1, bias=False, dtype=dtype)
        self.add_module(self.norms[2], make_norm(norm_kind, features * 4))
        self.needs_proj = in_ch != features * 4 or stride != 1
        if self.needs_proj:
            self.downsample = Conv(in_ch, features * 4, 1, stride=stride,
                                   bias=False, dtype=dtype)
            self.add_module(self.norms[3], make_norm(norm_kind, features * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = [getattr(self, name) for name in self.norms[:4 if self.needs_proj else 3]]
        y = F.relu(n[0](self.conv1(x)))
        y = F.relu(n[1](self.conv2(y)))
        y = n[2](self.conv3(y))
        residual = n[3](self.downsample(x)) if self.needs_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns the outputs of layers 2-4 (strides 8/16/32), NCHW."""

    def __init__(self, dtype: torch.dtype = torch.float32, norm_kind: str = "group",
                 name: str = "resnet50"):
        super().__init__()
        if name not in STAGES:
            raise ValueError(f"unsupported backbone {name!r}")
        self.conv1 = Conv(3, WIDTH, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.stem_norm = f"{NORM_NAMES[norm_kind]}_0"
        self.add_module(self.stem_norm, make_norm(norm_kind, WIDTH))
        self.stage_blocks = []
        in_ch = WIDTH
        for stage, blocks in enumerate(STAGES[name]):
            feats = WIDTH * 2 ** stage
            names = []
            for blk in range(blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                block = f"layer{stage + 1}_{blk}"
                self.add_module(block, Bottleneck(in_ch, feats, stride, dtype, norm_kind))
                names.append(block)
                in_ch = feats * 4
            self.stage_blocks.append(names)
        self.num_channels = [WIDTH * 2 ** i * 4 for i in RETURN_INDICES]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = F.relu(getattr(self, self.stem_norm)(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = []
        for names in self.stage_blocks:
            for name in names:
                y = getattr(self, name)(y)
            outputs.append(y)
        return tuple(outputs[i] for i in RETURN_INDICES)
