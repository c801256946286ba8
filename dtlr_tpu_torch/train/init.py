"""Fresh parameters for a model trained from scratch (counterpart of
``Trainer.init_params``, dtlr_tpu/train/engine.py:155-182, which takes
flax's initializers), as the flat ``params/...`` tree in flax layouts
that ``checkpoints.load_params_npz`` returns, so that a fresh start, a
warm start (``checkpoints.merge_params_npz``), the class-head surgery and
``Trainer.build`` all take one form.

Leaf families, by the JAX module that makes each:
- ``Dense``, ``Conv`` and ``DenseGeneral`` kernels: lecun-normal, a normal
  of std sqrt(1 / fan_in) truncated at two of its own std (flax's
  ``variance_scaling(1, "fan_in", "truncated_normal")``). The fan-in is
  the product of the input axes: a Conv's in-channels times its window;
  a ``DenseGeneral`` kernel is drawn flattened to (inputs, features), so
  the attention projections' q/k/v (C, M, D), ``out_proj`` (M, D, C) and
  the windowed encoder's ``qk`` (C, 2, C) all have fan-in C. In the
  port's (out, in...) layouts that is the product of every axis but the
  first.
- biases zero; GroupNorm and LayerNorm scales one;
- zero: the windowed encoder's ``mix_up`` and ``mix_down`` kernels
  (dtlr_tpu/models/windowed_encoder.py:139-141), the box heads' last
  layer (dtlr_tpu/models/dino.py:80-81), ``ca_box_gamma``
  (dtlr_tpu/models/transformer.py:219), and in ``MSDeformAttn`` the
  ``sampling_offsets`` kernel and the ``attention_weights`` kernel and
  bias (dtlr_tpu/models/layers.py:96-110);
- the ring: ``sampling_offsets``' bias, head (or offset group) h pointing
  at the angle 2*pi*h/groups, normalized to the unit Linf ball, point p
  scaled by p + 1, the same for every level
  (dtlr_tpu/models/layers.py:39-57);
- FrozenBatchNorm: ``scale`` (the port's ``weight``) and ``var`` one,
  ``bias`` and ``mean`` zero (dtlr_tpu/models/resnet.py:43-46);
- normal(1): ``level_embed`` and ``tgt_embed`` (transformer.py:309,358)
  and the CDN label encoder ``label_enc`` (dino.py:202-204);
- the class heads' biases: the focal prior -log(0.99 / 0.01) (dino.py:61);
- Swin's ``relative_position_bias_table``: flax's ``truncated_normal(0.02)``,
  a unit normal truncated at +-2 times 0.02 (no rescaling: its std is
  0.02 * 0.8796), dtlr_tpu/models/swin.py:56-60;
- ConvNeXt's layer scale ``gamma``: the constant 1e-6
  (dtlr_tpu/models/convnext.py:28); the backbones' LayerNorms take the
  norm family (scale one, bias zero) and their kernels lecun-normal.

The draws come from an explicit ``torch.Generator``, leaf by leaf in the
model's parameter order; the model is built on the meta device, so
nothing is initialized twice.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..models.convnext import LAYER_SCALE
from ..models.dino import DINO, DinoConfig
from .checkpoints import params_to_flax

#: flax's truncated_normal std correction: the std of a unit normal
#: truncated at +-2
TRUNCATED_STD = 0.87962566103423978
FOCAL_PRIOR = -math.log((1 - 0.01) / 0.01)
#: parameters that start at zero, by a part of their name
ZERO = ("mix_up.weight", "mix_down.weight", "bbox_embed.layers_2.", "ca_box_gamma",
        "sampling_offsets.weight", "attention_weights.")
#: parameters drawn from normal(1), by their last name
UNIT_NORMAL = ("level_embed", "tgt_embed", "label_enc")
#: the std of flax's truncated_normal for Swin's position bias tables
BIAS_TABLE_STD = 0.02


def family(name: str, ndim: int) -> str:
    """The initializer family of a port parameter: ``zero``, ``normal``,
    ``prior``, ``ring``, ``one``, ``table`` (truncated_normal(0.02)),
    ``layer_scale`` or ``lecun``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "relative_position_bias_table":
        return "table"
    if leaf == "gamma" and "backbone_net" in name:
        return "layer_scale"
    if any(z in name for z in ZERO):
        return "zero"
    if name.endswith("sampling_offsets.bias"):
        return "ring"
    if "FrozenBatchNorm" in name:
        return "one" if leaf in ("weight", "var") else "zero"
    if leaf in UNIT_NORMAL:
        return "normal"
    if name.endswith("class_embed.fc.bias"):
        return "prior"
    if leaf == "bias":
        return "zero"
    if ndim == 1:  # a norm's scale
        return "one"
    return "lecun"


def lecun_std(shape) -> float:
    """The untruncated std of a lecun-normal draw for a port weight of
    ``shape`` ((out, in) or (out, in, kh, kw))."""
    return math.sqrt(1.0 / int(np.prod(shape[1:]))) / TRUNCATED_STD


def ring_bias(groups: int, levels: int, points: int) -> torch.Tensor:
    """``sampling_offsets``' initial bias, (groups * levels * points * 2,)
    float32, as dtlr_tpu/models/layers.py:39-57 computes it."""
    thetas = torch.arange(groups, dtype=torch.float32) * (2.0 * math.pi / groups)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].expand(groups, levels, points, 2)
    scales = torch.arange(1, points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scales).reshape(-1)


def draw(name: str, shape, gen: torch.Generator, cfg: DinoConfig) -> torch.Tensor:
    kind = family(name, len(shape))
    if kind == "ring":
        points = cfg.enc_n_points if ".encoder_layer_" in name else cfg.dec_n_points
        return ring_bias(1 if cfg.shared_offsets else cfg.nheads, cfg.num_feature_levels,
                         points)
    if kind == "zero":
        return torch.zeros(shape)
    if kind == "one":
        return torch.ones(shape)
    if kind == "prior":
        return torch.full(shape, FOCAL_PRIOR)
    if kind == "normal":
        return torch.randn(shape, generator=gen)
    if kind == "layer_scale":
        return torch.full(shape, LAYER_SCALE)
    if kind == "table":
        s = BIAS_TABLE_STD
        return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, s, -2 * s, 2 * s,
                                           generator=gen)
    std = lecun_std(shape)
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                       generator=gen)


def init_params(model_cfg: DinoConfig, num_classes: int,
                gen: torch.Generator) -> Dict[str, np.ndarray]:
    """Fresh float32 parameters of the model of ``model_cfg`` with
    ``num_classes`` classes (its label encoder sized by
    ``model_cfg.dn_labelbook_size``), as a flat ``params/...`` tree."""
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in DINO(model_cfg, num_classes).named_parameters()}
    return params_to_flax({n: draw(n, s, gen, model_cfg) for n, s in shapes.items()},
                          model_cfg.nheads)
