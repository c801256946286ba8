"""The port's CUDA kernels (dtlr_tpu_torch/csrc/box_attn.cu and
csrc/row_gather.cu) against their plain PyTorch versions, on the card. Imports no JAX, so that it runs on a
GPU host without it (``--noconftest`` skips tests/conftest.py, which
imports JAX): ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.

Both instantiations, fp32 and bf16 inputs, ragged Q and S (the last key
tile and the last query tile partly filled), 20% of keys padded.
Tolerances: 1e-4 in fp32 (summation order) and 2e-2 with bf16 inputs,
as tests/test_flash_attn.py holds the Pallas kernel. Gradients through
the kernel path recompute through the plain version, so they match its
autograd gradients to 1e-5 of their scale (fp32) or 1e-2 (bf16 inputs
and gradients). The row gather is exact.
"""

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.ops import flash_attn as tfa
from dtlr_tpu_torch.ops import gather

B, M, D = 2, 4, 32
SPATIAL = {200: ((8, 10), (4, 10), (2, 20), (2, 20)),
           145: ((8, 13), (4, 7), (2, 5), (1, 3)),
           2720: ((16, 128), (8, 64), (4, 32), (2, 16))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(S, Q, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    qh, kh, vh = (x.to(dtype) for x in (t(B, M, Q, D), t(B, M, S, D), t(B, M, S, D)))
    pad = torch.from_numpy(rng.uniform(size=(B, S)) < 0.2).to(dev)
    key_bias = torch.zeros(B, S, device=dev).masked_fill(pad, -1e9)
    ref = torch.from_numpy(rng.uniform(0.05, 0.9, (B, Q, 4, 4)).astype(np.float32)).to(dev)
    prior = tfa.make_box_prior(ref, SPATIAL[S], torch.exp(0.3 * t(M)))
    return qh, kh, vh, key_bias, prior


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,Q", [(200, 70), (145, 70), (2720, 900)])
def test_kernel_matches_plain(cuda, S, Q, dtype, tol):
    qh, kh, vh, key_bias, prior = inputs(S, Q, dtype, cuda)
    for name, pr in (("mha_box", prior), ("mha", None)):
        before = tfa.flash_mha.launches[name]
        got = tfa.flash_mha(qh, kh, vh, key_bias, pr)
        torch.cuda.synchronize()
        assert tfa.flash_mha.launches[name] == before + 1
        want = tfa.dense_reference(qh, kh, vh, key_bias, pr)
        assert float((got - want).abs().max()) <= tol, name


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    qh, kh, vh, key_bias, prior = inputs(145, 70, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_mha(qh.transpose(2, 3).contiguous().transpose(2, 3), kh, vh, key_bias)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_mha(qh[..., :16].contiguous(), kh[..., :16].contiguous(),
                      vh[..., :16].contiguous(), key_bias)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_mha(qh, kh.bfloat16(), vh, key_bias)
    with pytest.raises(ValueError, match="on cpu"):
        tfa.flash_mha(qh, kh, vh, key_bias.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
def test_kernel_gradients_match_plain(cuda, prior, dtype, tol):
    qh, kh, vh, key_bias, box = inputs(145, 70, dtype, cuda, seed=1)
    w = torch.randn(qh.shape, generator=torch.Generator().manual_seed(2)).to(cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
        fields = [t.clone().requires_grad_(t.is_floating_point()) for t in box] if prior else []
        out = fn(*leaves, key_bias, tfa.BoxPrior(*fields) if prior else None)
        (out * w).sum().backward()
        return [t.grad for t in leaves + fields[:4] + fields[7:]]  # cx..ihh, gamma

    name = "mha_box" if prior else "mha"
    before = tfa.flash_mha.launches[name]
    got = grads(tfa.flash_mha)
    torch.cuda.synchronize()
    assert tfa.flash_mha.launches[name] == before + 1
    want = grads(tfa.dense_reference)
    for g, r in zip(got, want):
        scale = max(1.0, float(r.abs().max()))
        assert float((g.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("S,C,Q", [(1024, 64, 128), (333, 7, 1000)])
def test_row_gather_matches_plain(cuda, S, C, Q):
    rng = np.random.default_rng(0)
    val = torch.from_numpy(rng.standard_normal((S, C)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, S, Q).astype(np.int32)).to(cuda)
    before = gather.row_gather.launches["row_gather"]
    got = gather.row_gather(val, idx)
    torch.cuda.synchronize()
    assert gather.row_gather.launches["row_gather"] == before + 1
    assert torch.equal(got, gather.row_gather_reference(val, idx))


@pytest.mark.gpu
def test_row_gather_rejects_what_it_does_not_take(cuda):
    val = torch.zeros(16, 4, device=cuda)
    idx = torch.tensor([0, 15], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        gather.row_gather(val, idx + 1)
    with pytest.raises(IndexError):
        gather.row_gather(val, idx - 1)
    with pytest.raises(ValueError, match="int32"):
        gather.row_gather(val, idx.long())
    with pytest.raises(ValueError, match="float32"):
        gather.row_gather(val.bfloat16(), idx)
    with pytest.raises(ValueError, match="cuda"):
        gather.row_gather(val, idx.cpu())
