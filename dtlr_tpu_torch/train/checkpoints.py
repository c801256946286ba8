"""Parameter snapshots, the class-head surgery and train-state
checkpoints (counterpart of dtlr_tpu/train/checkpoints.py:106-263).

- ``export_params_npz`` / ``load_params_npz``: one compressed npz of the
  parameters with the JAX package's flat ``params/...`` keys and flax
  layouts, so that each package loads the other's exports
  (``weights.load_into`` carries a loaded tree into a model).
- ``merge_params_npz``: the warm start, an npz's leaves that fit copied
  into a fresh tree.
- ``smart_mapping_rows`` / ``surgery_class_heads``: new class heads and
  label-encoder rows for another charset, rows of characters that the
  old charset has copied, the others drawn anew from an explicit
  generator.
- ``save_checkpoint`` / ``latest_step`` / ``restore_checkpoint``: the
  whole train state (parameters, optimizer state, step, EMA, epoch) with
  ``torch.save``, one file per step under a directory, the newest
  ``max_to_keep`` kept (in place of JAX's orbax manager); ``state_sha256``
  hashes one, so that data-parallel ranks can show they hold the same.
"""

from __future__ import annotations

import hashlib
import math
import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..weights import OUT_PROJECTIONS

#: attention projections whose flax kernels are DenseGeneral over heads:
#: DINO's, and the LM rescorer's flax MultiHeadDotProductAttention
_HEAD_PROJ = re.compile(r"(self_attn|cross_attn|attn_\d+)\."
                        r"(q_proj|k_proj|v_proj|out_proj|query|key|value|out)\.")


def _flax_leaf(name: str, x: np.ndarray, n_heads: int):
    """One port parameter -> (flax key, array in flax layout)."""
    *mod, leaf = name.split(".")
    head = _HEAD_PROJ.search(name + ".") if leaf in ("weight", "bias") else None
    if leaf == "weight" and x.ndim == 4:  # conv OIHW -> HWIO
        leaf, x = "kernel", x.transpose(2, 3, 1, 0)
    elif leaf == "weight" and x.ndim == 2:  # dense (out, in) -> (in, out)
        leaf, x = "kernel", x.T
        if head is not None and head.group(2) in OUT_PROJECTIONS:
            x = x.reshape(n_heads, -1, x.shape[1])          # (M, D, C)
        elif head is not None:
            x = x.reshape(x.shape[0], n_heads, -1)          # (C, M, D)
        elif mod[-1] == "qk":
            x = x.reshape(x.shape[0], 2, -1)                # (C, 2, C)
    elif leaf == "weight":  # norm
        leaf = "scale"
    elif leaf == "bias" and head is not None and head.group(2) not in OUT_PROJECTIONS:
        x = x.reshape(n_heads, -1)                          # (M, D)
    elif leaf == "bias" and mod[-1] == "qk":
        x = x.reshape(2, -1)                                # (2, C)
    return "/".join(["params"] + mod + [leaf]), np.ascontiguousarray(x)


def params_to_flax(params: Mapping[str, torch.Tensor],
                   n_heads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The port's parameters by name -> the flat ``params/...`` tree in
    flax layouts (the inverse of ``weights.load_jax_params``). The
    attention projections' kernels are split by head: ``n_heads``, else
    the size of ``ca_box_gamma`` (the flagship's); a tree with attention
    projections and neither raises."""
    if n_heads is None:
        gammas = [v for k, v in params.items() if k.endswith("ca_box_gamma")]
        if gammas:
            n_heads = int(gammas[0].numel())
        elif any(_HEAD_PROJ.search(k) for k in params):
            raise ValueError("params_to_flax needs n_heads: the tree has attention "
                             "projections and no ca_box_gamma")
    out = {}
    for name, t in params.items():
        key, x = _flax_leaf(name, t.detach().float().cpu().numpy(), n_heads)
        out[key] = x
    return out


def export_params_npz(model: nn.Module, out_path: str, dtype: Optional[str] = "float16") -> int:
    """Write a model's parameters to one compressed npz in the JAX
    package's format; floating leaves are cast to ``dtype`` (float16, as
    the shipped checkpoints; None keeps float32). Returns the file's size
    in bytes."""
    flat = params_to_flax(dict(model.named_parameters()), model.cfg.nheads)
    if dtype is not None:
        flat = {k: v.astype(dtype) for k, v in flat.items()}
    np.savez_compressed(out_path, **flat)
    return os.path.getsize(out_path)


def load_params_npz(path: str, dtype: str = "float32") -> Dict[str, np.ndarray]:
    """An npz of either package as the flat ``params/...`` tree, floating
    leaves cast to ``dtype`` (fp32 master weights for training)."""
    with np.load(path) as npz:
        return {k: (npz[k].astype(dtype) if np.issubdtype(npz[k].dtype, np.floating)
                    else npz[k]) for k in npz.files}


def merge_params_npz(tree: Mapping[str, np.ndarray], path: str,
                     dtype: str = "float32"):
    """The tolerant warm start (dtlr_tpu/train/checkpoints.py:166-199):
    every npz leaf whose key is in ``tree`` with the same shape is copied
    (floating leaves cast to ``dtype``), every other leaf of ``tree``
    keeps its fresh value. Returns the merged tree (a new dict; a fresh
    leaf is the same object as in ``tree``) and the counts ``copied``,
    ``fresh`` (in ``tree``, not taken from the npz) and ``unused`` (npz
    leaves not taken)."""
    out = dict(tree)
    copied = unused = 0
    with np.load(path) as npz:
        for key in npz.files:
            arr = npz[key]
            if key in out and tuple(arr.shape) == tuple(np.shape(out[key])):
                out[key] = arr.astype(dtype) if np.issubdtype(arr.dtype, np.floating) else arr
                copied += 1
            else:
                unused += 1
    return out, {"copied": copied, "fresh": len(out) - copied, "unused": unused}


# ---------------------------------------------------------------- surgery

def smart_mapping_rows(old_charset: Sequence[str], new_charset: Sequence[str]) -> np.ndarray:
    """new index -> old index, or -1 where the old charset lacks the
    character."""
    old_index = {c: i for i, c in enumerate(old_charset)}
    return np.asarray([old_index.get(c, -1) for c in new_charset], np.int32)


def _reinit(gen: torch.Generator, shape) -> np.ndarray:
    return (torch.randn(shape, generator=gen) * 0.02).numpy()


def surgery_class_heads(tree: Mapping[str, np.ndarray], old_charset: Sequence[str],
                        new_charset: Sequence[str], gen: torch.Generator,
                        smart_mapping: bool = True) -> Dict[str, np.ndarray]:
    """New ``class_embed`` and ``enc_out_class_embed`` heads and
    ``label_enc`` rows for ``new_charset`` in a flat ``params/...`` tree.
    Kernel columns are drawn as N(0, 0.02) from ``gen`` and biases set to
    the focal prior -log(99); with ``smart_mapping`` the columns, biases
    and label rows of characters the old charset has are copied.
    ``label_enc`` gets K_new + 2 rows (the last two always drawn anew).
    Returns a new tree; the input is not changed."""
    mapping = smart_mapping_rows(old_charset, new_charset) if smart_mapping else None
    k_new = len(new_charset)
    out = dict(tree)
    prior = -math.log((1 - 0.01) / 0.01)
    for head in ("class_embed", "enc_out_class_embed"):
        kkey, bkey = f"params/{head}/fc/kernel", f"params/{head}/fc/bias"
        if kkey not in out:
            continue
        kernel, bias = np.asarray(out[kkey]), np.asarray(out[bkey])
        new_kernel = _reinit(gen, (kernel.shape[0], k_new)).astype(kernel.dtype)
        new_bias = np.full((k_new,), prior, bias.dtype)
        if mapping is not None:
            valid = mapping >= 0
            src = np.clip(mapping, 0, None)
            new_kernel = np.where(valid[None, :], kernel[:, src], new_kernel)
            new_bias = np.where(valid, bias[src], new_bias)
        out[kkey], out[bkey] = new_kernel, new_bias
    if "params/label_enc" in out:
        emb = np.asarray(out["params/label_enc"])
        new_emb = _reinit(gen, (k_new + 2, emb.shape[1])).astype(emb.dtype)
        if mapping is not None:
            valid = mapping >= 0
            src = np.clip(mapping, 0, None)
            new_emb[:k_new] = np.where(valid[:, None], emb[src], new_emb[:k_new])
        out["params/label_enc"] = new_emb
    return out


# ---------------------------------------------------------- train states

def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"state_{step:08d}.pt")


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"state_(\d{8})\.pt", f)))


def save_checkpoint(ckpt_dir: str, step: int, state: Mapping, max_to_keep: int = 5) -> str:
    """``torch.save`` of ``state`` (tensors moved to the CPU) as the
    step's file in ``ckpt_dir``, written to a temporary name and renamed;
    older files past ``max_to_keep`` are removed. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def state_sha256(state) -> str:
    """sha256 of a train state (``save_checkpoint``'s dict): every tensor's
    bytes and every other leaf's repr, keys in sorted order, so that two
    states hash alike exactly when they are equal bit for bit."""
    h = hashlib.sha256()

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            h.update(str(obj.dtype).encode())
            h.update(obj.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(obj, Mapping):
            for k in sorted(obj):
                h.update(repr(k).encode())
                walk(obj[k])
        else:
            h.update(repr(obj).encode())

    walk(state)
    return h.hexdigest()


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Optional[dict]:
    """The saved state of ``step`` (default the newest), on the CPU; None
    if there is none."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)
