"""Fused multi-head attention with the Gaussian box prior (counterpart of
dtlr_tpu/ops/flash_attn.py).

``flash_mha`` is the decoder's attention core. On a CUDA tensor it
launches the hand-written kernel of ``csrc/box_attn.cu`` (the port of the
Pallas kernels ``_mha_box_kernel`` and, with ``prior=None``,
``_mha_kernel``, the latter also under the CDN group mask of a detection
training step's self-attention, which JAX runs materialized,
dtlr_tpu/models/layers.py:184-195); on a CPU tensor it runs
``dense_reference``, the plain PyTorch version of the same math. bf16
inputs run on the tensor cores, fp32 inputs on the CUDA cores. The kernel reads q, k and v through their
batch, head and row strides (``kernel_strides``), so the decoder hands it
its projections without copies. It is compiled with ``nvcc`` for sm_90a
at first use into ``dtlr_tpu_torch/build/`` and bound with ctypes
(``_build.py``).

Gradients: on CUDA the kernel runs inside ``RecomputeGrad``, whose
backward recomputes the attention through ``dense_reference`` and
differentiates that, as the JAX custom VJP ``_flash_mha_bwd`` does
(dtlr_tpu/ops/flash_attn.py:348). Gradients reach q, k, v and the
prior's float fields (cx, cy, ihw, ihh and gamma, which carries the
learned ``ca_box_gamma``); key_bias, level, px and py take none.

What bounds the kernel on an H100, and what its design does about it,
is written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

SOURCE = os.path.join(_build.CSRC, "box_attn.cu")
HEAD_DIM = 32  # the kernel's compiled head dimension
MAX_LEVELS = 8

#: the kernel's instantiations, the keys of ``flash_mha.launches``: with
#: the box prior (the decoder's cross-attention), without it (the
#: self-attention), and without it under the CDN group mask (the
#: self-attention of a detection training step)
KERNELS = ("mha_box", "mha", "mha_masked")


class BoxPrior(NamedTuple):
    """Per-query Gaussian locality prior, before the level select.

    cx, cy: (B, Q, L) box centres in padded-frame fractions.
    ihw, ihh: (B, Q, L) reciprocals of the clamped box half-extents.
    level: (S,) int32 feature level of each flattened key.
    px, py: (S,) pixel-centre coordinates of each key.
    gamma: (M,) per-head sharpness, exp(ca_box_gamma).
    """

    cx: torch.Tensor
    cy: torch.Tensor
    ihw: torch.Tensor
    ihh: torch.Tensor
    level: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    gamma: torch.Tensor


def make_box_prior(reference_points_input: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   gamma: torch.Tensor) -> BoxPrior:
    """Split the dense box prior into per-query and per-key arrays: for a
    level-l key pixel p and query box b, d2 = ((px-cx_l)/hw_l)^2 +
    ((py-cy_l)/hh_l)^2 with hw, hh the half-extents clamped at 1e-3."""
    box = reference_points_input.float()  # (B, Q, L, 4)
    dev = box.device
    pxs, pys, lvls = [], [], []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        pys.append(ys[:, None].expand(h, w).reshape(-1))
        pxs.append(xs[None, :].expand(h, w).reshape(-1))
        lvls.append(torch.full((h * w,), lvl, dtype=torch.int32, device=dev))
    return BoxPrior(
        cx=box[..., 0].contiguous(),
        cy=box[..., 1].contiguous(),
        ihw=1.0 / (box[..., 2] * 0.5).clamp(min=1e-3),
        ihh=1.0 / (box[..., 3] * 0.5).clamp(min=1e-3),
        level=torch.cat(lvls),
        px=torch.cat(pxs),
        py=torch.cat(pys),
        gamma=gamma.float().contiguous(),
    )


def group_blocked(query_group: torch.Tensor) -> torch.Tensor:
    """(Q, Q) bool, True where row r may not see key c: ``group[c] >= 0
    and group[c] != group[r]`` (the CDN mask, models/cdn.py)."""
    g = query_group.long()
    return (g[None, :] >= 0) & (g[None, :] != g[:, None])


def dense_reference(qh, kh, vh, key_bias, prior: Optional[BoxPrior],
                    query_group: Optional[torch.Tensor] = None):
    """The kernel's math with the (B, M, Q, S) scores materialized: the
    kernel's plain version and the CPU path. qh (B, M, Q, D), kh/vh
    (B, M, S, D), key_bias (B, S) additive, query_group (Q,) int32 with
    Q = S: a blocked score takes float32's lowest value, as JAX's
    materialized masked attention does (dtlr_tpu/models/layers.py:184-195).
    Returns (B, M, Q, D) fp32."""
    D = qh.shape[-1]
    logits = qh.float() @ kh.float().transpose(-1, -2) / math.sqrt(D)
    if prior is not None:
        lvl = prior.level.long()
        dx = (prior.px - prior.cx[..., lvl]) * prior.ihw[..., lvl]  # (B, Q, S)
        dy = (prior.py - prior.cy[..., lvl]) * prior.ihh[..., lvl]
        d2 = dx * dx + dy * dy
        logits = logits - (0.5 * prior.gamma)[None, :, None, None] * d2[:, None]
    logits = logits + key_bias.float()[:, None, None, :]
    if query_group is not None:
        logits = logits.masked_fill(group_blocked(query_group), torch.finfo(torch.float32).min)
    return logits.softmax(-1) @ vh.float()


def _check(name, t, shape, dtypes, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_strides(name: str, t: torch.Tensor, shape, dtypes, device) -> Tuple[int, int, int]:
    """Check one of the kernel's 4-d operands (qh, kh, vh or the output):
    device, dtype and shape, a unit stride on D, a 16-byte aligned start,
    and batch, head and row strides that are whole multiples of 16 bytes
    (8 bf16 or 4 fp32 elements) wherever the axis has more than one entry,
    so that every row starts 16-byte aligned, and rows of one (batch, head)
    that span less than 2^31 elements (the kernel's 32-bit row offsets).
    Returns those three element strides; raises ValueError (TypeError for
    the dtype) otherwise."""
    _check(name, t, shape, dtypes, device, contiguous=False)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last axis, got stride {t.stride(-1)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    unit = 16 // t.element_size()
    for axis, what in enumerate(("batch", "head", "row")):
        if t.shape[axis] > 1 and t.stride(axis) % unit:
            raise ValueError(f"{name}'s {what} stride {t.stride(axis)} is not a multiple "
                             f"of {unit} elements")
    if (t.shape[2] - 1) * t.stride(2) + t.shape[3] >= 2 ** 31:
        raise ValueError(f"{name}'s rows span 2^31 elements or more")
    return t.stride(0), t.stride(1), t.stride(2)


def _launch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
            key_bias: torch.Tensor, prior: Optional[BoxPrior],
            query_group: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the CUDA inputs and launch the kernel once. qh/kh/vh may be
    strided views (the decoder's (B, S, M, D) projections transposed);
    the result is a (B, M, Q, D) view of a (B, Q, M, D) fp32 tensor."""
    B, M, Q, D = qh.shape
    S = kh.shape[2]
    dev = qh.device
    if D != HEAD_DIM:
        raise ValueError(f"the kernel is compiled for head dim {HEAD_DIM}, got {D}")
    io_types = (torch.float32, torch.bfloat16)
    out = torch.empty((B, Q, M, D), dtype=torch.float32, device=dev).transpose(1, 2)
    strides = (kernel_strides("qh", qh, (B, M, Q, D), io_types, dev)
               + kernel_strides("kh", kh, (B, M, S, D), (qh.dtype,), dev)
               + kernel_strides("vh", vh, (B, M, S, D), (qh.dtype,), dev)
               + kernel_strides("out", out, (B, M, Q, D), (torch.float32,), dev))
    _check("key_bias", key_bias, (B, S), (torch.float32,), dev)
    if query_group is not None:
        if prior is not None:
            raise ValueError("the kernel takes the group mask without the box prior only")
        if Q != S:
            raise ValueError(f"the group mask is the self-attention's: Q = S, got {Q} and {S}")
        _check("query_group", query_group, (Q,), (torch.int32,), dev)
    f32 = (torch.float32,)
    if prior is not None:
        L = prior.cx.shape[-1]
        if not 1 <= L <= MAX_LEVELS:
            raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {L}")
        for name in ("cx", "cy", "ihw", "ihh"):
            _check(name, getattr(prior, name), (B, Q, L), f32, dev)
        _check("level", prior.level, (S,), (torch.int32,), dev)
        _check("px", prior.px, (S,), f32, dev)
        _check("py", prior.py, (S,), f32, dev)
        _check("gamma", prior.gamma, (M,), f32, dev)
        box_ptrs = [t.data_ptr() for t in prior]
    else:
        L = 1
        box_ptrs = [None] * 8
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.dtlr_box_attn_fwd(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), key_bias.data_ptr(),
            *box_ptrs, None if query_group is None else query_group.data_ptr(),
            out.data_ptr(), B, M, Q, S, D, L,
            int(qh.dtype == torch.bfloat16), int(prior is not None),
            (ctypes.c_longlong * 12)(*strides), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"box_attn kernel launch failed with CUDA error {err}")
    name = "mha_box" if prior is not None else "mha" if query_group is None else "mha_masked"
    flash_mha.launches[name] += 1
    return out


#: positions of qh, kh, vh and the prior's cx, cy, ihw, ihh, gamma among
#: (qh, kh, vh, key_bias, query_group, *BoxPrior): the inputs that take a
#: gradient
_DIFFERENTIABLE = (0, 1, 2, 5, 6, 7, 8, 12)


class RecomputeGrad(torch.autograd.Function):
    """``fwd(qh, kh, vh, key_bias, prior, query_group)`` (the kernel) in the
    forward; the backward recomputes through ``dense_reference`` and
    differentiates it (JAX's ``_flash_mha_bwd``). Call as
    ``RecomputeGrad.apply(fwd, qh, kh, vh, key_bias, query_group, *prior)``
    with ``query_group`` None without the CDN mask and no prior fields
    without the prior (the groups take no gradient)."""

    @staticmethod
    def forward(ctx, fwd, qh, kh, vh, key_bias, query_group, *prior):
        ctx.save_for_backward(qh, kh, vh, key_bias, query_group, *prior)
        return fwd(qh, kh, vh, key_bias, BoxPrior(*prior) if prior else None, query_group)

    #: backward calls since ``reset_launches`` (each recomputes once)
    backwards = 0

    @staticmethod
    def backward(ctx, grad_out):
        RecomputeGrad.backwards += 1
        saved = ctx.saved_tensors
        want = [i for i in _DIFFERENTIABLE
                if i < len(saved) and ctx.needs_input_grad[1 + i]]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(i in want)
                      for i, t in enumerate(saved)]
            prior = BoxPrior(*leaves[5:]) if len(leaves) > 5 else None
            out = dense_reference(*leaves[:4], prior, leaves[4])
            grads = torch.autograd.grad(out, [leaves[i] for i in want], grad_out) if want else ()
        result = [None] * len(saved)
        for i, g in zip(want, grads):
            result[i] = g
        return (None, *result)


def flash_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              key_bias: torch.Tensor, prior: Optional[BoxPrior] = None,
              query_group: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention: out (B, M, Q, D) fp32 from qh (B, M, Q, D), kh/vh
    (B, M, S, D) in fp32 or bf16, additive key_bias (B, S) fp32 (-1e9 at
    padded keys), an optional BoxPrior, or (self-attention, Q = S, no
    prior) an optional (Q,) int32 ``query_group`` that blocks row r from
    key c where ``group[c] >= 0 and group[c] != group[r]`` (the CDN mask).
    CPU tensors take ``dense_reference``; CUDA tensors launch the kernel,
    differentiably (``RecomputeGrad``), or raise. On CUDA qh/kh/vh may be
    strided views (``kernel_strides`` says which), and the result is a
    view whose storage is laid out as (B, Q, M, D)."""
    if qh.device.type == "cpu":
        return dense_reference(qh, kh, vh, key_bias, prior, query_group)
    if qh.device.type != "cuda":
        raise ValueError(f"flash_mha runs on cuda or cpu, got {qh.device}")
    inputs = (qh, kh, vh, key_bias, *(prior or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return RecomputeGrad.apply(_launch, qh, kh, vh, key_bias, query_group, *(prior or ()))
    return _launch(qh, kh, vh, key_bias, prior, query_group)  # nothing to differentiate


#: launches of the CUDA kernel by instantiation; the plain version is
#: never counted
flash_mha.launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    """Zero the launch counts and ``RecomputeGrad.backwards``."""
    for name in KERNELS:
        flash_mha.launches[name] = 0
    RecomputeGrad.backwards = 0


def build_library() -> dict:
    """Compile csrc/box_attn.cu (``_build.build``): the library's path,
    nvcc's seconds and the ptxas report."""
    return _build.build([SOURCE])[0]


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.dtlr_box_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dtlr_box_attn_bf16_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dtlr_box_attn_bf16_smem.restype = ctypes.c_int
    return lib
