"""The reference's torch checkpoints (``.pth``) in and out (counterpart of
dtlr_tpu/train/torch_import.py and ``checkpoints.import_torch_checkpoint``,
dtlr_tpu/train/checkpoints.py:291-303).

The reference names its modules as torch's DINO builds them
(``backbone.0.body...``, ``transformer.encoder.layers.<i>...``,
``class_embed.<i>``); ``build_name_map`` maps those names to the flat
``params/...`` tree in flax layouts that the port loads
(``weights.load_into``), as JAX's map does:
- Linear: torch (out, in) -> kernel (in, out);
- Conv2d: OIHW -> HWIO;
- LayerNorm and GroupNorm weight and bias -> scale and bias;
- FrozenBatchNorm2d weight, bias, running_mean, running_var -> scale,
  bias, mean, var;
- the decoder self-attention's ``nn.MultiheadAttention``:
  ``in_proj_weight`` (3C, C) and ``in_proj_bias`` split into the q, k and
  v kernels (C, M, D) and biases (M, D); ``out_proj`` (C, C) -> (M, D, C);
- the decoder's class and box heads are shared (index 0 is mapped, and
  an export writes the same head at every index).
The map covers the reference's architecture (FrozenBN ResNet, deformable
encoder and decoder), as JAX's does; a ``.pth`` loads into a model of
that architecture (``load_params_file``) or warm-starts another
(``merge_torch_state``), whose leaves without a torch name stay fresh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.dino import DINO
from ..models.resnet import STAGES
from .checkpoints import _flax_leaf, load_params_npz, merge_params_npz

Entry = Tuple[str, str, str]  # (torch name, flax key, layout kind)
_FROZEN_LEAVES = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                  ("running_var", "var"))
TORCH_SUFFIXES = (".pth", ".pt")


def build_name_map(n_enc: int = 6, n_dec: int = 6, n_levels: int = 4,
                   backbone: str = "resnet50") -> List[Entry]:
    """[(torch name, flax key, kind)] with kind one of lin, conv, raw,
    qkv_q|k|v, qkvb_q|k|v, mha_out (dtlr_tpu/train/torch_import.py:36-150)."""
    out: List[Entry] = []

    def A(tname, fpath, kind):
        out.append((tname, "/".join(("params",) + fpath), kind))

    bb, fx = "backbone.0.body", ("backbone_net",)
    A(f"{bb}.conv1.weight", fx + ("conv1", "kernel"), "conv")
    for suffix, leaf in _FROZEN_LEAVES:
        A(f"{bb}.bn1.{suffix}", fx + ("FrozenBatchNorm_0", leaf), "raw")
    for st, blocks in enumerate(STAGES[backbone]):
        for b in range(blocks):
            tb, fb = f"{bb}.layer{st + 1}.{b}", fx + (f"layer{st + 1}_{b}",)
            for ci in (1, 2, 3):
                A(f"{tb}.conv{ci}.weight", fb + (f"conv{ci}", "kernel"), "conv")
                for suffix, leaf in _FROZEN_LEAVES:
                    A(f"{tb}.bn{ci}.{suffix}", fb + (f"FrozenBatchNorm_{ci - 1}", leaf), "raw")
            if b == 0:  # the projection shortcut
                A(f"{tb}.downsample.0.weight", fb + ("downsample", "kernel"), "conv")
                for suffix, leaf in _FROZEN_LEAVES:
                    A(f"{tb}.downsample.1.{suffix}", fb + ("FrozenBatchNorm_3", leaf), "raw")

    for i in range(n_levels):
        A(f"input_proj.{i}.0.weight", (f"input_proj_{i}_conv", "kernel"), "conv")
        A(f"input_proj.{i}.0.bias", (f"input_proj_{i}_conv", "bias"), "raw")
        A(f"input_proj.{i}.1.weight", (f"input_proj_{i}_norm", "scale"), "raw")
        A(f"input_proj.{i}.1.bias", (f"input_proj_{i}_norm", "bias"), "raw")

    T = ("transformer",)
    A("transformer.level_embed", T + ("level_embed",), "raw")
    A("transformer.tgt_embed.weight", T + ("tgt_embed",), "raw")
    A("transformer.enc_output.weight", T + ("enc_output", "kernel"), "lin")
    A("transformer.enc_output.bias", T + ("enc_output", "bias"), "raw")
    A("transformer.enc_output_norm.weight", T + ("enc_output_norm", "scale"), "raw")
    A("transformer.enc_output_norm.bias", T + ("enc_output_norm", "bias"), "raw")
    A("transformer.decoder.norm.weight", T + ("decoder_norm", "scale"), "raw")
    A("transformer.decoder.norm.bias", T + ("decoder_norm", "bias"), "raw")
    for j in range(2):
        A(f"transformer.decoder.ref_point_head.layers.{j}.weight",
          T + ("ref_point_head", f"layers_{j}", "kernel"), "lin")
        A(f"transformer.decoder.ref_point_head.layers.{j}.bias",
          T + ("ref_point_head", f"layers_{j}", "bias"), "raw")

    def deform_attn(tprefix, fprefix):
        for mod in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            A(f"{tprefix}.{mod}.weight", fprefix + (mod, "kernel"), "lin")
            A(f"{tprefix}.{mod}.bias", fprefix + (mod, "bias"), "raw")

    def norms_and_ffn(tp, fp, norms):
        for ln in norms:
            A(f"{tp}.{ln}.weight", fp + (ln, "scale"), "raw")
            A(f"{tp}.{ln}.bias", fp + (ln, "bias"), "raw")
        for lin in ("linear1", "linear2"):
            A(f"{tp}.{lin}.weight", fp + (lin, "kernel"), "lin")
            A(f"{tp}.{lin}.bias", fp + (lin, "bias"), "raw")

    for i in range(n_enc):
        tp, fp = f"transformer.encoder.layers.{i}", T + (f"encoder_layer_{i}",)
        deform_attn(f"{tp}.self_attn", fp + ("self_attn",))
        norms_and_ffn(tp, fp, ("norm1", "norm2"))

    for i in range(n_dec):
        tp, fp = f"transformer.decoder.layers.{i}", T + (f"decoder_layer_{i}",)
        deform_attn(f"{tp}.cross_attn", fp + ("cross_attn",))
        for c in "qkv":
            A(f"{tp}.self_attn.in_proj_weight", fp + ("self_attn", f"{c}_proj", "kernel"),
              f"qkv_{c}")
        for c in "qkv":
            A(f"{tp}.self_attn.in_proj_bias", fp + ("self_attn", f"{c}_proj", "bias"),
              f"qkvb_{c}")
        A(f"{tp}.self_attn.out_proj.weight", fp + ("self_attn", "out_proj", "kernel"), "mha_out")
        A(f"{tp}.self_attn.out_proj.bias", fp + ("self_attn", "out_proj", "bias"), "raw")
        norms_and_ffn(tp, fp, ("norm1", "norm2", "norm3"))

    A("class_embed.0.weight", ("class_embed", "fc", "kernel"), "lin")
    A("class_embed.0.bias", ("class_embed", "fc", "bias"), "raw")
    for j in range(3):
        A(f"bbox_embed.0.layers.{j}.weight", ("bbox_embed", f"layers_{j}", "kernel"), "lin")
        A(f"bbox_embed.0.layers.{j}.bias", ("bbox_embed", f"layers_{j}", "bias"), "raw")
    A("transformer.enc_out_class_embed.weight", ("enc_out_class_embed", "fc", "kernel"), "lin")
    A("transformer.enc_out_class_embed.bias", ("enc_out_class_embed", "fc", "bias"), "raw")
    for j in range(3):
        A(f"transformer.enc_out_bbox_embed.layers.{j}.weight",
          ("enc_out_bbox_embed", f"layers_{j}", "kernel"), "lin")
        A(f"transformer.enc_out_bbox_embed.layers.{j}.bias",
          ("enc_out_bbox_embed", f"layers_{j}", "bias"), "raw")
    A("label_enc.weight", ("label_enc",), "raw")
    return out


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _convert(kind: str, w, n_heads: int, d_model: int) -> np.ndarray:
    """A torch tensor in the flax layout of ``kind``."""
    w = np.asarray(w)
    D = d_model // n_heads
    if kind == "raw":
        return w
    if kind == "lin":
        return _t(w)
    if kind == "conv":
        return np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    if kind == "mha_out":
        return _t(w).reshape(n_heads, D, d_model)
    rows = slice("qkv".index(kind[-1]) * d_model, ("qkv".index(kind[-1]) + 1) * d_model)
    if kind.startswith("qkv_"):
        return _t(w[rows]).reshape(d_model, n_heads, D)
    if kind.startswith("qkvb_"):
        return w[rows].reshape(n_heads, D)
    raise ValueError(kind)


def _invert(kind: str, w, d_model: int) -> np.ndarray:
    """A flax leaf in the torch layout of ``kind`` (a q, k or v kernel as
    its third of ``in_proj_weight``)."""
    w = np.asarray(w)
    if kind == "raw":
        return w
    if kind == "lin":
        return _t(w)
    if kind == "mha_out" or kind.startswith("qkv_"):  # (C, M, D) or (M, D, C)
        return _t(w.reshape(d_model, d_model))
    if kind == "conv":
        return np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    if kind.startswith("qkvb_"):
        return w.reshape(d_model)
    raise ValueError(kind)


def structure(tree: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """The name map's sizes read from a flat tree: encoder and decoder
    layers, levels, the backbone (by its third stage's blocks) and the
    model width."""
    keys = [k.split("/") for k in tree]
    count = lambda pred: len({p for p in keys for p in [pred(p)] if p})
    n_enc = count(lambda p: p[2] if p[1] == "transformer" and p[2].startswith("encoder_layer_")
                  else None)
    n_dec = count(lambda p: p[2] if p[1] == "transformer" and p[2].startswith("decoder_layer_")
                  else None)
    n_levels = count(lambda p: p[1] if p[1].startswith("input_proj_") and
                     p[1].endswith("_conv") else None)
    stage3 = count(lambda p: p[2] if p[1] == "backbone_net" and p[2].startswith("layer3_")
                   else None)
    backbone = next((name for name, st in STAGES.items() if st[2] == stage3), "resnet50")
    d_model = int(np.shape(tree["params/transformer/level_embed"])[-1])
    return {"n_enc": n_enc, "n_dec": n_dec, "n_levels": n_levels, "backbone": backbone,
            "d_model": d_model}


def import_torch_state(params: Mapping[str, np.ndarray], torch_sd: Mapping[str, object],
                       n_heads: int = 8, strict: bool = False):
    """Fill a flat ``params/...`` tree (its structure and shapes are the
    template) from a reference state dict. Returns (new tree, the torch
    names the map asked for and the state dict lacks, the count of leaves
    left unfilled); raises on a shape that does not fit, and with
    ``strict`` on a missing name."""
    st = structure(params)
    name_map = build_name_map(st["n_enc"], st["n_dec"], st["n_levels"], st["backbone"])
    out = dict(params)
    missing, filled = [], set()
    for tname, fkey, kind in name_map:
        if tname not in torch_sd:
            missing.append(tname)
            continue
        w = _convert(kind, _numpy(torch_sd[tname]), n_heads, st["d_model"])
        if fkey not in out or tuple(w.shape) != tuple(np.shape(out[fkey])):
            raise ValueError(f"{tname} -> {fkey}: shape {w.shape}, the tree has "
                             f"{np.shape(out.get(fkey)) if fkey in out else 'no such leaf'}")
        out[fkey] = w.astype(np.asarray(out[fkey]).dtype)
        filled.add(fkey)
    if strict and missing:
        raise KeyError(f"missing torch keys: {missing[:10]} ({len(missing)})")
    return out, missing, len(set(out) - filled)


def export_torch_state(params: Mapping[str, np.ndarray], n_heads: int = 8) -> Dict[str, np.ndarray]:
    """A flat tree of the reference's architecture as a reference-named
    state dict; the decoder's shared heads at every decoder index."""
    st = structure(params)
    name_map = build_name_map(st["n_enc"], st["n_dec"], st["n_levels"], st["backbone"])
    d = st["d_model"]
    out: Dict[str, np.ndarray] = {}
    parts: Dict[str, Dict[str, np.ndarray]] = {}
    for tname, fkey, kind in name_map:
        w = np.asarray(params[fkey])
        if kind.startswith("qkv"):
            parts.setdefault(tname, {})[kind[-1]] = _invert(kind, w, d)
        else:
            out[tname] = _invert(kind, w, d)
    for tname, qkv in parts.items():
        out[tname] = np.concatenate([qkv[c] for c in "qkv"], axis=0)
    for i in range(1, st["n_dec"]):
        for k in [k for k in out if k.startswith(("class_embed.0.", "bbox_embed.0."))]:
            out[k.replace(".0.", f".{i}.", 1)] = out[k]
    return out


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` as a numpy state dict: the ``model`` entry if
    the file holds one, ``module.`` prefixes stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k.removeprefix("module."): _numpy(v) for k, v in sd.items()}


def save_torch_checkpoint(params: Mapping[str, np.ndarray], path: str, n_heads: int) -> None:
    """``export_torch_state`` of a flat tree saved as the reference saves
    its checkpoints (``{"model": state_dict}``)."""
    sd = export_torch_state(params, n_heads)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)


def is_torch_checkpoint(path: str) -> bool:
    return path.endswith(TORCH_SUFFIXES)


def template(model_cfg, num_classes: int) -> Dict[str, np.ndarray]:
    """Zeros in the shapes of the flat tree of ``model_cfg`` with
    ``num_classes`` classes."""
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in DINO(model_cfg, num_classes).named_parameters()}
    out = {}
    for name, shape in shapes.items():
        key, x = _flax_leaf(name, np.zeros(shape, np.float32), model_cfg.nheads)
        out[key] = x
    return out


def params_from_torch(torch_sd: Mapping[str, object], model_cfg) -> Dict[str, np.ndarray]:
    """The flat tree of ``model_cfg``'s model from a reference state dict,
    its class count and label book read from the state dict; raises
    unless every leaf comes from it."""
    num_classes = int(np.shape(torch_sd["class_embed.0.weight"])[0])
    labelbook = int(np.shape(torch_sd["label_enc.weight"])[0]) - 1
    cfg = dataclasses.replace(model_cfg, dn_labelbook_size=labelbook)
    try:
        tree, missing, unfilled = import_torch_state(template(cfg, num_classes), torch_sd,
                                                     cfg.nheads)
    except ValueError as err:  # a leaf the architecture lacks, or of another shape
        missing, unfilled = [str(err)], -1
    if missing or unfilled:
        raise KeyError(f"the torch state does not fill the model of this architecture "
                       f"(encoder {cfg.encoder_type}, decoder {cfg.decoder_ca}, norm "
                       f"{cfg.norm_kind}): {len(missing)} names missing {missing[:4]}, "
                       f"{unfilled} leaves unfilled")
    return tree


def load_params_file(path: str, model_cfg) -> Dict[str, np.ndarray]:
    """The flat float32 tree of a parameter file: an npz of ``params/...``
    leaves, or a reference ``.pth`` for ``model_cfg``'s architecture."""
    if is_torch_checkpoint(path):
        return {k: v.astype(np.float32) for k, v in
                params_from_torch(load_torch_checkpoint(path), model_cfg).items()}
    return load_params_npz(path)


def merge_torch_state(tree: Mapping[str, np.ndarray], path: str, n_heads: int):
    """The warm start from a reference ``.pth`` (as ``merge_params_npz``
    from an npz): each mapped torch tensor whose leaf is in ``tree`` with
    the same shape is copied, the other leaves keep their fresh values.
    Returns the merged tree and the counts ``copied``, ``fresh`` and
    ``unused`` (torch tensors not taken; the decoder's shared heads at
    indices past 0 are copies of index 0 and count with it)."""
    torch_sd = load_torch_checkpoint(path)
    st = structure(tree)
    out = dict(tree)
    copied, used = 0, set()
    for tname, fkey, kind in build_name_map(st["n_enc"], st["n_dec"], st["n_levels"],
                                            st["backbone"]):
        if tname not in torch_sd or fkey not in out:
            continue
        w = _convert(kind, torch_sd[tname], n_heads, st["d_model"])
        if tuple(w.shape) == tuple(np.shape(out[fkey])):
            out[fkey] = w.astype(np.float32)
            copied += 1
            used.add(tname)
    shared = lambda k: k.startswith(("class_embed.", "bbox_embed.")) and \
        k.replace(k.split(".")[1], "0", 1) in used
    unused = sum(1 for k in torch_sd if k not in used and not shared(k))
    return out, {"copied": copied, "fresh": len(out) - copied, "unused": unused}


def merge_params_file(tree: Mapping[str, np.ndarray], path: str, n_heads: int):
    """``merge_params_npz`` for an npz, ``merge_torch_state`` for a ``.pth``."""
    if is_torch_checkpoint(path):
        return merge_torch_state(tree, path, n_heads)
    return merge_params_npz(tree, path)

