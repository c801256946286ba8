"""Windowed dense encoder layer (counterpart of
dtlr_tpu/models/windowed_encoder.py).

Each level is cut into full-height windows of ``win`` columns; odd
layers shift the windows by win/2 and block the pairs that the shift
wraps round (Swin-style). Masked logits take ``finfo.min`` as in JAX, so
a window with no valid key softmaxes to uniform weights instead of NaN.
Levels then mix through bilinear resizes with antialiasing, which is
what ``jax.image.resize`` does when it shrinks.

With ``dtype=bfloat16`` the projections and the attention products
compute in bf16, the softmax in float32 (cast back, as
dtlr_tpu/models/windowed_encoder.py:50 does) and both norms return
float32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Dense, LayerNorm


def window_attention(q, k, v, key_valid, n_heads: int,
                     col_allow: Optional[torch.Tensor] = None,
                     dims: Optional[Tuple[int, int, int, int]] = None):
    """q, k, v (Bw, N, C); key_valid (Bw, N) bool; ``col_allow``
    (nW, win, win) masks the wrapped pairs of shifted windows laid out
    as ``dims`` = (B, nW, h, win)."""
    Bw, N, C = q.shape
    D = C // n_heads
    qh = q.view(Bw, N, n_heads, D).transpose(1, 2)
    kh = k.view(Bw, N, n_heads, D).transpose(1, 2)
    vh = v.view(Bw, N, n_heads, D).transpose(1, 2)
    # JAX divides by sqrt(D) rounded to the inputs' dtype
    scale = float(torch.tensor(math.sqrt(D)).to(q.dtype))
    logits = qh @ kh.transpose(-1, -2) / scale  # (Bw, H, N, N)
    neg = torch.finfo(logits.dtype).min
    logits = logits.masked_fill(~key_valid[:, None, None, :], neg)
    if col_allow is not None:
        B, nW, h, win = dims
        lg = logits.view(B, nW, n_heads, h, win, h, win)
        lg = lg.masked_fill(~col_allow[None, :, None, None, :, None, :], neg)
        logits = lg.view(Bw, n_heads, N, N)
    out = logits.float().softmax(-1).to(vh.dtype) @ vh
    return out.transpose(1, 2).reshape(Bw, N, C)


def _interpolate(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


@functools.lru_cache(maxsize=None)
def _axis_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in): the resize along one axis, as a matrix (the resize
    of each unit vector)."""
    eye = torch.eye(n_in, device=device, dtype=torch.float32).view(n_in, 1, 1, n_in)
    return _interpolate(eye, 1, n_out).view(n_in, n_out).t().contiguous()


class _MatrixResize(torch.autograd.Function):
    """The antialiased resize whose backward is the transpose of its two
    one-axis matrices (two matrix products, as JAX's resize contracts
    them): torch's own gradient within float32 rounding, in a fixed order.
    torch's backward scatters atomic adds on the card, which has no
    deterministic form (it raises under
    ``torch.use_deterministic_algorithms``), so a step there could not
    repeat bit for bit."""

    @staticmethod
    def forward(ctx, x, h, w):
        ctx.in_hw = x.shape[-2:]
        return _interpolate(x, h, w)

    @staticmethod
    def backward(ctx, gy):
        (H, W), (h, w) = ctx.in_hw, gy.shape[-2:]
        a_h, a_w = _axis_weights(H, h, gy.device), _axis_weights(W, w, gy.device)
        # (B, C, h, w) @ (w, W), then the rows: (B, C, W, h) @ (h, H)
        gx = (gy @ a_w).transpose(-1, -2) @ a_h
        return gx.transpose(-1, -2), None, None


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h0, w0, C) -> (B, h, w, C), bilinear with half-pixel centres
    and antialiasing: ``jax.image.resize(x, ..., "bilinear")``. Computed
    in float32 (torch has no bf16 antialiased resize on the CPU) and
    returned in the input's dtype, as JAX returns it."""
    y = _MatrixResize.apply(x.permute(0, 3, 1, 2).float(), h, w)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class WindowedEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 2048, n_heads: int = 8,
                 win: int = 32, shift: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_heads, self.win, self.shift = d_model, n_heads, win, shift
        self.qk = Dense(d_model, 2 * d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        self.mix_up = Dense(d_model, d_model, dtype=dtype)
        self.mix_down = Dense(d_model, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, d_ffn, dtype=dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model)

    def _level(self, x, p, valid):
        """Windowed attention over one level: x, p (B, h, w, C), valid
        (B, h, w). Returns x + attention output."""
        B, h, w, C = x.shape
        win = min(self.win, max(1, w))
        sh = win // 2 if (self.shift and w > win) else 0
        pad_w = (-w) % win
        xw = F.pad(x, (0, 0, 0, pad_w))
        pw = F.pad(p, (0, 0, 0, pad_w))
        vw = F.pad(valid, (0, pad_w))
        if sh:
            xw, pw, vw = (t.roll(-sh, dims=2) for t in (xw, pw, vw))
        Wp = w + pad_w
        nW = Wp // win

        def part(t):
            t = t.reshape(B, h, nW, win, *t.shape[3:]).transpose(1, 2)
            return t.reshape(B * nW, h * win, *t.shape[4:])

        col_allow = None
        if sh:
            seg = (torch.arange(Wp, device=x.device) >= Wp - sh).view(nW, win)
            col_allow = seg[:, :, None] == seg[:, None, :]
        xp = part(xw)
        q, k = self.qk(xp + part(pw)).view(B * nW, h * win, 2, C).unbind(2)
        attn = window_attention(q, k, self.v_proj(xp), part(vw), self.n_heads,
                                col_allow=col_allow, dims=(B, nW, h, win))
        attn = self.out_proj(attn).view(B, nW, h, win, C).transpose(1, 2)
        attn = attn.reshape(B, h, Wp, C)
        if sh:
            attn = attn.roll(sh, dims=2)
        return x + attn[:, :, :w]

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                key_padding_mask: torch.Tensor) -> torch.Tensor:
        """src, pos (B, S, C) flattened levels; key_padding_mask (B, S),
        True at padding."""
        B, S, C = src.shape
        feats = []
        offset = 0
        for h, w in spatial_shapes:
            sl = slice(offset, offset + h * w)
            feats.append(self._level(src[:, sl].reshape(B, h, w, C),
                                     pos[:, sl].reshape(B, h, w, C),
                                     ~key_padding_mask[:, sl].reshape(B, h, w)))
            offset += h * w
        mixed = []
        for lvl, y in enumerate(feats):
            h, w = y.shape[1:3]
            acc = y
            if lvl + 1 < len(feats):
                acc = acc + self.mix_up(_resize(feats[lvl + 1], h, w))
            if lvl > 0:
                acc = acc + self.mix_down(_resize(feats[lvl - 1], h, w))
            mixed.append(acc.reshape(B, h * w, C))
        src = self.norm1(torch.cat(mixed, dim=1))
        ffn = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + ffn)
