"""Dynamic row gather (counterpart of the Pallas probe kernel ``kernel``
in ``main()`` of scripts/pallas_probe.py).

``row_gather(val, idx)`` computes ``val[idx] * 2``: on CUDA tensors it
launches the hand-written kernel of ``csrc/row_gather.cu``, built with
``nvcc`` at first use (``_build.py``) and bound with ctypes; on CPU
tensors it runs ``row_gather_reference``, the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _build

SOURCE = os.path.join(_build.CSRC, "row_gather.cu")

#: the key of ``row_gather.launches``
KERNELS = ("row_gather",)


def row_gather_reference(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``val.index_select(0, idx) * 2``."""
    return val.index_select(0, idx.long()) * 2


def row_gather(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (Q, C) = val[idx] * 2 for val (S, C) float32 and idx (Q,) int32
    in [0, S). CPU tensors take the plain version (which raises IndexError
    on an index outside [0, S)); CUDA tensors launch the kernel or raise,
    and an index outside [0, S) trips the kernel's device-side assert,
    which the next synchronizing call reports and which leaves the CUDA
    context unusable, as with ``index_select``. The kernel sits at the
    launch floor (csrc/row_gather.cu), so the host's work per call is what
    a caller waits for, and the launch path is lean: the checks are one
    expression (``_refuse`` spells out a failure), the device context is
    entered only if another device is current (``_build.launch_on``), and
    nothing here waits for the device."""
    dev = val.device
    if (dev.type == "cuda" and idx.device == dev and val.dtype is torch.float32
            and idx.dtype is torch.int32 and val.dim() == 2 and idx.dim() == 1
            and val.is_contiguous() and idx.is_contiguous()):
        S, C = val.shape
        Q = idx.shape[0]
        out = val.new_empty((Q, C))
        err = _build.launch_on(dev, load_library().dtlr_row_gather, val.data_ptr(),
                               idx.data_ptr(), out.data_ptr(), S, C, Q)
        if err != 0:
            raise RuntimeError(f"row_gather kernel launch failed with CUDA error {err}")
        row_gather.launches["row_gather"] += 1
        return out
    if dev.type == "cpu" and idx.device.type == "cpu":
        return row_gather_reference(val, idx)
    _refuse(val, idx)


def _refuse(val: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise ValueError for what ``row_gather`` does not take on the card."""
    if val.device.type != "cuda" or idx.device != val.device:
        raise ValueError(f"row_gather runs on one cuda device, got val on {val.device} "
                         f"and idx on {idx.device}")
    if val.dtype != torch.float32 or val.dim() != 2 or not val.is_contiguous():
        raise ValueError(f"val must be a contiguous (S, C) float32 tensor, got "
                         f"{val.dtype} {tuple(val.shape)}")
    raise ValueError(f"idx must be a contiguous (Q,) int32 tensor, got "
                     f"{idx.dtype} {tuple(idx.shape)}")


#: launches of the CUDA kernel; the plain version is never counted
row_gather.launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    row_gather.launches["row_gather"] = 0


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.dtlr_row_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
