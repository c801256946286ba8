"""Swin Transformer backbone (counterpart of dtlr_tpu/models/swin.py;
reference models/dino/swin_transformer.py:435-727, selected by
``backbone`` in build_backbone, backbone.py:172-205).

4x4 patch embed, stages of shifted-window attention blocks with a
relative position bias, patch merging between stages, a LayerNorm on each
returned feature. NHWC inside, as in JAX; ``SwinTransformer`` takes and
returns NCHW as ``resnet.ResNet`` does. Submodules carry the flax names
(``patch_embed``, ``stage{s}_block{b}``, ``out_norm{s}``,
``merge_norm{s}``, ``merge_reduce{s}``) so that weights.py maps leaves by
name.

Where torch's defaults differ from flax's, the JAX module's are kept: the
stem is a 4x4 stride-4 convolution with XLA's 'SAME' padding (``same_pad``);
LayerNorms have epsilon 1e-6 and compute in float32; the MLP's GELU is the
tanh approximation (flax's ``nn.gelu``). Each block pads its normalized
input at the bottom and right to window multiples and crops after; the
shifted blocks roll by -shift, take the -100 mask built on the padded
size, and roll back. Under ``dtype=bfloat16`` the rounding points are
flax's: the Dense layers compute in bf16, the norms in float32, the
softmax in float32 and the attention's value product in float32 (flax
promotes the float32 weights against bf16 values), so the residual
stream is float32 in the first stage and bf16 after the first merge's
bf16 reduction.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .layers import Conv, Dense, LayerNorm


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad an NCHW input as XLA's 'SAME' does for a ``kernel`` x
    ``kernel`` convolution of ``stride``: out = ceil(n / stride), the
    total padding split low = total // 2, high the rest."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last axis first
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """(windows, ws*ws, ws*ws) float32: -100 between tokens of different
    regions of the rolled, padded map, 0 within one
    (dtlr_tpu/models/swin.py:117-129)."""
    img = np.zeros((1, Hp, Wp, 1), np.int32)
    cnt = 0
    for hsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hsl, wsl, :] = cnt
            cnt += 1
    img = np.roll(img, (-shift, -shift), axis=(1, 2))
    wins = img.reshape(1, Hp // ws, ws, Wp // ws, ws, 1)
    wins = wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    return ((wins[:, :, None] != wins[:, None, :]) * -100.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rp_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1).astype(np.int64)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (windows, ws*ws, C); ``mask`` (windows per image, ws*ws, ws*ws)."""
        nW, N, C = x.shape
        M = self.num_heads
        D = C // M
        qkv = self.qkv(x).reshape(nW, N, 3, M, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (nW, M, N, D)
        # jnp.sqrt(D) is float32, cast to the products' dtype
        scale = torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
        attn = (q @ k.transpose(-2, -1)) / scale
        bias = self.relative_position_bias_table[self.rp_index].reshape(N, N, M)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nmask = mask.shape[0]
            attn = attn.reshape(nW // nmask, nmask, M, N, N) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(nW, M, N, N)
        attn = F.softmax(attn.float(), dim=-1).to(x.dtype)
        dt = torch.promote_types(attn.dtype, v.dtype)
        out = (attn.to(dt) @ v.to(dt)).transpose(1, 2).reshape(nW, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def attn_mask(self, Hp: int, Wp: int, device: torch.device) -> torch.Tensor:
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shifted_window_mask(Hp, Wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, sh = self.window_size, self.shift
        pad_h, pad_w = (-H) % ws, (-W) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if sh > 0:
            y = torch.roll(y, (-sh, -sh), dims=(1, 2))
            mask = self.attn_mask(Hp, Wp, y.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, B, Hp, Wp)
        if sh > 0:
            y = torch.roll(y, (sh, sh), dims=(1, 2))
        x = x + y[:, :H, :W]
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + z


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 return_indices: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.return_indices = tuple(return_indices)
        self.patch_embed = Conv(3, embed_dim, 4, stride=4, dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        for st, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{st}_block{b}", SwinBlock(
                    dim, num_heads[st], window_size,
                    shift=0 if b % 2 == 0 else window_size // 2, dtype=dtype))
            self.add_module(f"out_norm{st}", LayerNorm(dim))
            if st < len(self.depths) - 1:
                self.add_module(f"merge_norm{st}", LayerNorm(4 * dim))
                self.add_module(f"merge_reduce{st}", Dense(4 * dim, 2 * dim, dtype=dtype,
                                                           bias=False))
                dim *= 2
        self.num_channels = [embed_dim * 2 ** i for i in self.return_indices]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(same_pad(x, 4, 4)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        outs = []
        for st, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{st}_block{b}")(x)
            if st in self.return_indices:
                outs.append(getattr(self, f"out_norm{st}")(x).permute(0, 3, 1, 2))
            if st < len(self.depths) - 1:
                # patch merging: 2x down, 2x channels
                x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 1::2]], dim=-1)
                x = getattr(self, f"merge_reduce{st}")(getattr(self, f"merge_norm{st}")(x))
        return tuple(outs)


SWIN_CONFIGS = {
    "swin_T_224_1k": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_S_224_1k": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_B_224_22k": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_L_224_22k": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


def build_swin(name: str, return_indices=(1, 2, 3),
               dtype: torch.dtype = torch.float32) -> SwinTransformer:
    if name not in SWIN_CONFIGS:
        raise ValueError(f"unknown swin variant {name!r}")
    return SwinTransformer(return_indices=return_indices, dtype=dtype, **SWIN_CONFIGS[name])
