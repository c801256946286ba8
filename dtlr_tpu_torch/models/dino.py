"""DINO character detector (counterpart of dtlr_tpu/models/dino.py for the
flagship recipe: ResNet-50 with GroupNorm, windowed encoder, dense decoder
cross-attention with the box prior).

``DINO.forward(images, valid_hw, targets=None, train=False, cdn_noise=None)``
takes ImageNet-normalized (B, H, W, 3) images, as the JAX module does, and
returns the same dict: pred_logits, pred_boxes, aux_outputs,
interm_outputs, interm_outputs_for_matching_pre. With ``train``,
``cfg.use_dn`` and ``targets`` (labels (B, N), boxes (B, N, 4) cxcywh,
valid (B, N)) the decoder also runs the contrastive denoising queries
(models/cdn.py) before the matching ones, and the dict gains their
outputs (``dn_outputs`` with ``aux_outputs``) and ``dn_meta``, as at
dtlr_tpu/models/dino.py:245-259,299-312; ``cdn_noise`` is the generator
of their noise or the draws themselves (``CdnDraws``).
Submodules carry the flax parameter names, so that weights.py maps the
checkpoint's leaves by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..utils.boxes import inverse_sigmoid
from .cdn import CdnDraws, cdn_query_groups, prepare_cdn
from .layers import MLP, Conv, Dense, GroupNorm
from .position_encoding import sine_position_embedding_hw
from .resnet import ResNet
from .transformer import DeformableTransformer


@dataclass(frozen=True)
class DinoConfig:
    """Model geometry. The defaults are the flagship recipe
    (dtlr_tpu/configs/Latin_TPU.py, dumped in
    outputs/finetune_r4b/config_cfg.py)."""

    num_queries: int = 900
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    encoder_win: int = 32
    #: rows of the CDN label encoder less one; None is JAX's default,
    #: num_classes + 1 (dtlr_tpu/models/dino.py:354)
    dn_labelbook_size: Optional[int] = None
    #: "bfloat16" (the recipe, dtlr_tpu/configs/Latin.py:91) or "float32"
    compute_dtype: str = "bfloat16"
    #: contrastive denoising in training (dtlr_tpu/configs/Latin.py:77-80)
    use_dn: bool = True
    dn_number: int = 100
    dn_box_noise_scale: float = 0.4
    dn_label_noise_ratio: float = 0.5

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype is bfloat16 or float32, got {self.compute_dtype!r}")
        return getattr(torch, self.compute_dtype)


FLAGSHIP = DinoConfig()  # bfloat16, as the recipe computes
NUM_LEVELS = 4  # feature levels: layers 2-4 of the backbone and one more


def level_pad_mask(valid_hw: torch.Tensor, h: int, w: int, img_h: int,
                   img_w: int) -> torch.Tensor:
    """(B, 2) valid pixel sizes -> (B, h, w) mask, True at padding, for a
    level of shape (h, w) downsampled from (img_h, img_w): a cell is valid
    if its top-left source pixel is."""
    dev = valid_hw.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) * (img_h / h)).int()
    xs = (torch.arange(w, dtype=torch.float32, device=dev) * (img_w / w)).int()
    vy = ys[None, :] < valid_hw[:, 0:1]
    vx = xs[None, :] < valid_hw[:, 1:2]
    return ~(vy[:, :, None] & vx[:, None, :])


class ClassHead(nn.Module):
    def __init__(self, hidden_dim: int, num_classes: int, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(hidden_dim, num_classes, dtype=dtype)
        nn.init.constant_(self.fc.bias, -math.log((1 - prior_prob) / prior_prob))

    def forward(self, x):
        return self.fc(x)


class BboxHead(MLP):
    """3-layer MLP giving a box delta (layers_0..layers_2)."""

    def __init__(self, hidden_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, hidden_dim, 4, 3, dtype)


class DINO(nn.Module):
    def __init__(self, cfg: DinoConfig, num_classes: int):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        C = cfg.hidden_dim
        dt = cfg.dtype
        self.backbone_net = ResNet(dt)
        chans = self.backbone_net.num_channels
        for i in range(NUM_LEVELS):
            if i < len(chans):
                conv = Conv(chans[i], C, 1, dtype=dt)
            else:
                conv = Conv(chans[-1] if i == len(chans) else C, C, 3,
                            stride=2, padding=1, dtype=dt)
            self.add_module(f"input_proj_{i}_conv", conv)
            # flax GroupNorm's default epsilon, not torch's
            self.add_module(f"input_proj_{i}_norm", GroupNorm(C, eps=1e-6))
        self.transformer = DeformableTransformer(
            d_model=C, n_heads=cfg.nheads, num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers, d_ffn=cfg.dim_feedforward,
            num_feature_levels=NUM_LEVELS,
            num_queries=cfg.num_queries, encoder_win=cfg.encoder_win, dtype=dt)
        self.class_embed = ClassHead(C, num_classes, dtype=dt)
        self.bbox_embed = BboxHead(C, dt)
        self.enc_out_class_embed = ClassHead(C, num_classes, dtype=dt)
        self.enc_out_bbox_embed = BboxHead(C, dt)
        # the CDN label encoder: the denoising queries' content (training
        # only)
        labelbook = cfg.dn_labelbook_size
        if labelbook is None:
            labelbook = num_classes + 1
        self.label_enc = nn.Parameter(torch.zeros(labelbook + 1, C))

    def levels(self, images: torch.Tensor, valid_hw: torch.Tensor):
        """Backbone and input projections: per level srcs (B, h, w, C),
        masks (B, h, w) True at padding, and sine position encodings
        (B, h, w, C)."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        feats = self.backbone_net(images.permute(0, 3, 1, 2))
        srcs, masks, poss = [], [], []
        x = None
        for lvl in range(NUM_LEVELS):
            x = feats[lvl] if lvl < len(feats) else (feats[-1] if lvl == len(feats) else x)
            x = getattr(self, f"input_proj_{lvl}_norm")(
                getattr(self, f"input_proj_{lvl}_conv")(x))
            h, w = x.shape[2:]
            m = level_pad_mask(valid_hw, h, w, H, W)
            srcs.append(x.permute(0, 2, 3, 1))
            masks.append(m)
            poss.append(sine_position_embedding_hw(m, num_pos_feats=cfg.hidden_dim // 2))
        return srcs, masks, poss

    def forward(self, images: torch.Tensor, valid_hw: torch.Tensor,
                targets: Optional[dict] = None, train: bool = False,
                cdn_noise: Optional[CdnDraws | torch.Generator] = None) -> dict:
        cfg = self.cfg
        srcs, masks, poss = self.levels(images, valid_hw)
        use_cdn = train and cfg.use_dn and targets is not None
        dn_tgt = dn_refpoint = query_group = meta = None
        if use_cdn:
            dn_tgt, dn_refpoint, meta = prepare_cdn(
                targets["labels"], targets["boxes"], targets["valid"], self.label_enc,
                cfg.dn_number, cfg.dn_label_noise_ratio, cfg.dn_box_noise_scale,
                self.num_classes, cdn_noise)
            query_group = cdn_query_groups(cfg.num_queries, meta, images.device)
        hs, references, hs_enc, ref_enc, init_box_proposal = self.transformer(
            srcs, masks, poss, self.enc_out_class_embed, self.enc_out_bbox_embed,
            self.bbox_embed, dn_refpoint, dn_tgt, query_group)
        n_dec = hs.shape[0]
        delta = self.bbox_embed(hs).float()
        outputs_coord = (delta + inverse_sigmoid(references[:n_dec])).sigmoid()
        outputs_class = self.class_embed(hs).float()
        interm_class = self.enc_out_class_embed(hs_enc[-1]).float()
        out = {}
        if use_cdn:
            pad = meta.pad_size
            dn_class, dn_coord = outputs_class[:, :, :pad], outputs_coord[:, :, :pad]
            outputs_class, outputs_coord = outputs_class[:, :, pad:], outputs_coord[:, :, pad:]
            out["dn_meta"] = meta
            out["dn_outputs"] = {
                "pred_logits": dn_class[-1], "pred_boxes": dn_coord[-1],
                "aux_outputs": [{"pred_logits": dn_class[i], "pred_boxes": dn_coord[i]}
                                for i in range(n_dec - 1)]}
        out.update({
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
            "aux_outputs": [{"pred_logits": outputs_class[i],
                             "pred_boxes": outputs_coord[i]} for i in range(n_dec - 1)],
            "interm_outputs": {"pred_logits": interm_class,
                               "pred_boxes": ref_enc[-1]},
            "interm_outputs_for_matching_pre": {"pred_logits": interm_class,
                                                "pred_boxes": init_box_proposal},
        })
        return out


def build_dino(cfg: DinoConfig = FLAGSHIP, num_classes: int = 65,
               device: str = "cuda") -> DINO:
    """The model in eval mode on ``device``; raises if that is CUDA and
    no card is present."""
    return DINO(cfg, num_classes).to(resolve_device(device)).eval()
