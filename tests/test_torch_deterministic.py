"""Runs that repeat bit for bit on the card (``dtlr_tpu_torch.set_deterministic``,
``pretrain --deterministic``): the switches it sets, and the windowed
encoder's antialiased resize, whose CUDA backward (a scatter of atomic
adds) has no deterministic form in PyTorch. The encoder takes
``_MatrixResize``: its forward is ``F.interpolate``'s bit for bit
and its backward (the transpose of the two one-axis weight matrices)
torch's own gradient within float32 rounding (1e-6 of the gradient's
scale; measured 4e-7), at the flagship's level sizes, both ways."""

import subprocess
import sys

import pytest
import torch

from dtlr_tpu_torch.models.windowed_encoder import _MatrixResize, _interpolate

LEVELS = [(16, 128), (8, 64), (4, 32), (2, 16)]


@pytest.mark.parametrize("src,dst", [(a, b) for a in LEVELS for b in LEVELS])
def test_resize_backward_is_the_adjoint(src, dst):
    gen = torch.Generator().manual_seed(src[0] * 100 + dst[0])
    x = torch.randn(2, 3, *src, generator=gen, requires_grad=True)
    gy = torch.randn(2, 3, *dst, generator=gen)
    want_y = _interpolate(x, *dst)
    got_y = _MatrixResize.apply(x, *dst)
    assert torch.equal(got_y, want_y)
    want, = torch.autograd.grad(want_y, x, gy)
    got, = torch.autograd.grad(got_y, x, gy)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_set_deterministic_switches():
    code = ("import os, torch, dtlr_tpu_torch; dtlr_tpu_torch.set_deterministic(); "
            "print(torch.are_deterministic_algorithms_enabled(), "
            "torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, "
            "os.environ['CUBLAS_WORKSPACE_CONFIG'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert out == ["True", "True", "False", ":4096:8"]
