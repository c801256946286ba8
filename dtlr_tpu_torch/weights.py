"""Carry a flax parameter tree into the port's modules (counterpart of
dtlr_tpu/train/checkpoints.py:149 ``load_params_npz``).

Every ``params/...`` leaf maps to the module of the same dotted name.
Layouts: flax ``Dense`` kernels are (in, out) and ``nn.Linear`` weights
(out, in); ``DenseGeneral`` kernels are reshaped to (in, out) first -
q/k/v (C, M, D), ``out_proj`` (M, D, C), the windowed ``qk`` (C, 2, C);
``Conv`` kernels are HWIO and torch's OIHW; norm ``scale`` is ``weight``.
Leaves are cast to float32 (the checkpoints store float16).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

#: DenseGeneral output projections, whose kernels are (M, D, C)
OUT_PROJECTIONS = ("out_proj", "out")


def params_from_npz(path: str) -> Dict[str, np.ndarray]:
    """The npz's ``params/...`` leaves as a flat {path: array} dict."""
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if not isinstance(tree, Mapping):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def load_jax_params(tree) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict or flat '/'-joined paths, with or without
    the leading ``params``) -> the port's state dict, float32."""
    sd = {}
    for path, arr in _flatten(tree).items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        *mod, leaf = parts
        x = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
        if leaf == "kernel" and x.dim() == 4:  # conv HWIO -> OIHW
            x, leaf = x.permute(3, 2, 0, 1), "weight"
        elif leaf == "kernel":  # dense: reshape to (in, out), transpose
            n_in = (x.shape[0] * x.shape[1] if (x.dim() == 3 and mod[-1] in OUT_PROJECTIONS)
                    else x.shape[0])
            x, leaf = x.reshape(n_in, -1).t(), "weight"
        elif leaf == "bias":
            x = x.reshape(-1)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mod + [leaf])] = x.contiguous()
    return sd


def load_into(model: nn.Module, tree) -> None:
    """Load a flax tree into ``model``; raises on a missing leaf, an
    unused leaf or a shape that does not fit."""
    sd = load_jax_params(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise KeyError(f"checkpoint does not fit the model: missing {missing[:8]} "
                       f"({len(missing)}), unused {unused[:8]} ({len(unused)})")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in own.items()
           if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (name, checkpoint, model): {bad[:8]}")
    model.load_state_dict(sd, strict=True)
