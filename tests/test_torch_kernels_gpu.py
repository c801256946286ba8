"""The port's CUDA kernels (dtlr_tpu_torch/csrc/box_attn.cu and
csrc/row_gather.cu) against their plain PyTorch versions, on the card. Imports no JAX, so that it runs on a
GPU host without it (``--noconftest`` skips tests/conftest.py, which
imports JAX): ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.

Both instantiations, fp32 and bf16 inputs, ragged Q and S (the last key
tile and the last query tile partly filled; Q=900 leaves 4 rows in the
last 64-query tile), 20% of keys padded; S=3570, whose levels start at
keys 2688, 3360 and 3528, so two 64-key tiles mix levels; the decoder's
strided (B, S, M, D) projection views; a fully masked row. The
self-attention's CDN group mask (``query_group``) on the no-prior
instantiations: the flagship step's layout (a 128-query denoising prefix
before 900 matching queries, Q = S = 1028, so the matching rows' first
two 64-key tiles are blocked whole), several denoising groups, ragged
shapes, strided views, and the gradient through ``RecomputeGrad``. The
fp32 kernel (3xTF32) on V rows that ramp over the key index (its key
order in P.V) and against a float64 reference (within twice the plain
fp32 version's error). An out-of-range gather index fails the kernel's
device-side assert, which is checked in a child process.
Tolerances: 1e-4 in fp32 (summation order) and 2e-2 with bf16 inputs,
as tests/test_flash_attn.py holds the Pallas kernel. Gradients through
the kernel path recompute through the plain version, so they match its
autograd gradients to 1e-5 of their scale (fp32) or 1e-2 (bf16 inputs
and gradients). The row gather is exact.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.models.cdn import CdnMeta, cdn_num_groups, cdn_query_groups
from dtlr_tpu_torch.ops import flash_attn as tfa
from dtlr_tpu_torch.ops import gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, M, D = 2, 4, 32
SPATIAL = {200: ((8, 10), (4, 10), (2, 20), (2, 20)),
           145: ((8, 13), (4, 7), (2, 5), (1, 3)),
           2720: ((16, 128), (8, 64), (4, 32), (2, 16)),
           3570: ((16, 168), (8, 84), (4, 42), (2, 21))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(S, Q, dtype, dev, seed=0, strided=False):
    """Heads (B, M, L, D): contiguous, or with ``strided`` the (B, M, L, D)
    view of a (B, L, M*D) projection, as the decoder passes them."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    if strided:
        qh, kh, vh = (t(B, n, M * D).to(dtype).view(B, n, M, D).transpose(1, 2)
                      for n in (Q, S, S))
    else:
        qh, kh, vh = (x.to(dtype) for x in (t(B, M, Q, D), t(B, M, S, D), t(B, M, S, D)))
    pad = torch.from_numpy(rng.uniform(size=(B, S)) < 0.2).to(dev)
    key_bias = torch.zeros(B, S, device=dev).masked_fill(pad, -1e9)
    ref = torch.from_numpy(rng.uniform(0.05, 0.9, (B, Q, 4, 4)).astype(np.float32)).to(dev)
    prior = tfa.make_box_prior(ref, SPATIAL[S], torch.exp(0.3 * t(M)))
    return qh, kh, vh, key_bias, prior


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,Q", [(200, 70), (145, 70), (2720, 900), (3570, 900)])
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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,Q", [(145, 70), (2720, 900), (3570, 900)])
def test_kernel_reads_strided_views(cuda, S, Q, dtype, tol):
    """The decoder's (B, S, M, D) projections, transposed, without copies;
    the result is laid out as (B, Q, M, D)."""
    qh, kh, vh, key_bias, prior = inputs(S, Q, dtype, cuda, seed=4, strided=True)
    assert not kh.is_contiguous()
    for name, pr in (("mha_box", prior), ("mha", None)):
        got = tfa.flash_mha(qh, kh, vh, key_bias, pr)
        torch.cuda.synchronize()
        assert got.transpose(1, 2).is_contiguous()
        want = tfa.dense_reference(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                   key_bias, pr)
        assert float((got - want).abs().max()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
def test_fully_masked_row_is_uniform(cuda, dtype, tol):
    """Every key of line 0 carries -1e9: its output is the mean of the
    values, finite (the prior with gamma 0 keeps the row uniform)."""
    qh, kh, vh, key_bias, prior = inputs(2720, 900, dtype, cuda, seed=5, strided=True)
    key_bias[0] = -1e9
    prior = prior._replace(gamma=torch.zeros_like(prior.gamma))
    mean = vh[0].float().mean(1, keepdim=True).expand(M, 900, D)
    for name, pr in (("mha_box", prior), ("mha", None)):
        got = tfa.flash_mha(qh, kh, vh, key_bias, pr)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), name
        assert float((got[0] - mean).abs().max()) <= tol, name
        want = tfa.dense_reference(qh, kh, vh, key_bias, pr)
        assert float((got - want).abs().max()) <= tol, name


def dense_f64(qh, kh, vh, key_bias, prior, group=None):
    """``dense_reference``'s math in float64."""
    logits = qh.double() @ kh.double().transpose(-1, -2) / math.sqrt(D)
    if prior is not None:
        lvl = prior.level.long()
        dx = (prior.px.double() - prior.cx.double()[..., lvl]) * prior.ihw.double()[..., lvl]
        dy = (prior.py.double() - prior.cy.double()[..., lvl]) * prior.ihh.double()[..., lvl]
        logits = logits - (0.5 * prior.gamma.double())[None, :, None, None] * (dx * dx + dy * dy)[:, None]
    logits = logits + key_bias.double()[:, None, None, :]
    if group is not None:
        logits = logits.masked_fill(tfa.group_blocked(group), torch.finfo(torch.float64).min)
    return logits.softmax(-1) @ vh.double()


def ramp_values(vh):
    """V rows that ramp over the key index, 0 to 1 across each 64-key tile,
    plus d/32 over the head dims: a key or dim that the kernel pairs with
    another's probability moves the output."""
    S = vh.shape[2]
    s = torch.arange(S, device=vh.device, dtype=torch.float32) % 64 / 63
    d = torch.arange(D, device=vh.device, dtype=torch.float32) / 32
    return (s[:, None] + d).expand(vh.shape).to(vh.dtype).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("name,S,Q", [("mha_box", 3570, 900), ("mha_box", 2720, 900),
                                      ("mha", 900, 900), ("mha_masked", 1028, 1028)])
def test_fp32_ramp_values_keep_key_order(cuda, name, S, Q):
    """The fp32 kernel feeds the score fragment's key columns 2t, 2t+1 to
    P.V as k indices t, t+4 and reads V's rows and dims in that permuted
    order. On V rows that ramp over the key index, under peaked attention
    (q times 4), swapping each key pair's values moves the plain output by
    far more than the tolerance, and the kernel keeps 1e-4."""
    if name == "mha_box":
        qh, kh, vh, key_bias, prior = inputs(S, Q, torch.float32, cuda, seed=7, strided=True)
        group = None
    else:
        group = cdn_groups(100, 64, 900, cuda) if name == "mha_masked" else None
        qh, kh, vh = self_inputs(Q, torch.float32, cuda, seed=7, strided=True)
        key_bias, prior = torch.zeros(B, Q, device=cuda), None
    qh, vh = qh * 4, ramp_values(vh)
    got = tfa.flash_mha(qh, kh, vh, key_bias, prior, group)
    torch.cuda.synchronize()
    want = tfa.dense_reference(qh, kh, vh, key_bias, prior, group)
    swapped = vh.unflatten(2, (-1, 2)).flip(3).flatten(2, 3)
    moved = tfa.dense_reference(qh, kh, swapped, key_bias, prior, group)
    assert float((moved - want).abs().max()) > 10 * 1e-4
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name,S,Q", [("mha_box", 2720, 900), ("mha", 900, 900),
                                      ("mha_masked", 1028, 1028)])
def test_fp32_kernel_keeps_fp32_accuracy(cuda, name, S, Q):
    """3xTF32 on the decoder's strided views at its shapes: against a
    float64 reference the kernel's error stays within twice the plain
    fp32 version's and far inside 1e-4 (a single TF32 product would not,
    tests/test_torch_tf32x3.py)."""
    if name == "mha_box":
        qh, kh, vh, key_bias, prior = inputs(S, Q, torch.float32, cuda, seed=8, strided=True)
        group = None
    else:
        group = cdn_groups(100, 64, 900, cuda) if name == "mha_masked" else None
        qh, kh, vh = self_inputs(Q, torch.float32, cuda, seed=8, strided=True)
        key_bias, prior = torch.zeros(B, Q, device=cuda), None
    got = tfa.flash_mha(qh, kh, vh, key_bias, prior, group)
    torch.cuda.synchronize()
    exact = dense_f64(qh, kh, vh, key_bias, prior, group)
    plain = tfa.dense_reference(qh, kh, vh, key_bias, prior, group)
    err = float((got.double() - exact).abs().max())
    assert torch.isfinite(got).all()
    assert err <= 2 * float((plain.double() - exact).abs().max())
    assert err <= 1e-5


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
def test_kernel_rejects_misaligned_rows(cuda):
    """bf16 rows must start 16-byte aligned: a (B, S, M*D + 4) buffer's
    first M*D columns are refused, its 16-byte aligned copy is not."""
    qh, kh, vh, key_bias, prior = inputs(145, 70, torch.bfloat16, cuda)
    wide = torch.zeros(B, 145, M * D + 4, dtype=torch.bfloat16, device=cuda)
    bad = wide[..., :M * D].unflatten(-1, (M, D)).transpose(1, 2)
    with pytest.raises(ValueError, match="is not a multiple of"):
        tfa.flash_mha(qh, bad, vh, key_bias, prior)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(kh.numel() + 1, dtype=torch.bfloat16, device=cuda)
        tfa.flash_mha(qh, flat[1:].view(kh.shape), vh, key_bias, prior)


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


def self_inputs(Q, dtype, dev, seed=0, strided=False):
    """q, k, v heads (B, M, Q, D) of a self-attention, contiguous or as
    the strided views of (B, Q, M*D) projections."""
    rng = np.random.default_rng(seed)
    heads = []
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((B, Q, M * D)).astype(np.float32)).to(dev)
        x = x.to(dtype).view(B, Q, M, D).transpose(1, 2)
        heads.append(x if strided else x.contiguous())
    return heads


def cdn_groups(dn_number, n_max, num_queries, dev):
    """The (pad + num_queries,) query groups of a CDN layout."""
    G = cdn_num_groups(dn_number, n_max)
    return cdn_query_groups(num_queries, CdnMeta(G * 2 * n_max, G, n_max), dev)


#: (dn_number, n_max, matching queries): the flagship step's layout (one
#: group of 2 x 64, Q = 1028), twelve groups of 2 x 8 (Q = 1092), and a
#: small ragged one (two groups of 2 x 5, Q = 90)
CDN_LAYOUTS = [(100, 64, 900), (100, 8, 900), (12, 5, 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", CDN_LAYOUTS, ids=["flagship", "twelve_groups", "small"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_masked_kernel_matches_plain(cuda, layout, dtype, tol, strided):
    """The group mask against the plain version's (Q, Q) mask, and the
    matching rows against attention over the matching keys alone (which
    the mask must amount to)."""
    group = cdn_groups(*layout, cuda)
    Q = group.numel()
    qh, kh, vh = self_inputs(Q, dtype, cuda, seed=6, strided=strided)
    key_bias = torch.zeros(B, Q, device=cuda)
    before = dict(tfa.flash_mha.launches)
    got = tfa.flash_mha(qh, kh, vh, key_bias, None, group)
    torch.cuda.synchronize()
    assert tfa.flash_mha.launches["mha_masked"] == before["mha_masked"] + 1
    assert tfa.flash_mha.launches["mha"] == before["mha"]
    assert torch.isfinite(got).all()
    want = tfa.dense_reference(qh, kh, vh, key_bias, None, group)
    assert float((got - want).abs().max()) <= tol
    pad = int((group >= 0).sum())
    alone = tfa.dense_reference(qh[:, :, pad:], kh[:, :, pad:], vh[:, :, pad:],
                                key_bias[:, pad:], None)
    assert float((got[:, :, pad:] - alone).abs().max()) <= tol
    # and the mask matters: without it the outputs move by 0.25 to 0.95
    # (the plain version on these inputs)
    plain = tfa.flash_mha(qh, kh, vh, key_bias, None)
    assert float((plain - want).abs().max()) > 5 * tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["fp32", "bf16"])
def test_masked_kernel_gradients_match_plain(cuda, dtype, tol):
    """Through RecomputeGrad, which recomputes under the same mask."""
    group = cdn_groups(12, 5, 70, cuda)
    Q = group.numel()
    qh, kh, vh = self_inputs(Q, dtype, cuda, seed=9)
    key_bias = torch.zeros(B, Q, device=cuda)
    w = torch.randn(qh.shape, generator=torch.Generator().manual_seed(3)).to(cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
        (fn(*leaves, key_bias, None, group) * w).sum().backward()
        return [t.grad for t in leaves]

    before = tfa.flash_mha.launches["mha_masked"]
    backwards = tfa.RecomputeGrad.backwards
    got = grads(tfa.flash_mha)
    torch.cuda.synchronize()
    assert tfa.flash_mha.launches["mha_masked"] == before + 1
    assert tfa.RecomputeGrad.backwards == backwards + 1
    for g, r in zip(got, grads(tfa.dense_reference)):
        scale = max(1.0, float(r.abs().max()))
        assert float((g.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_masked_kernel_rejects_what_it_does_not_take(cuda):
    qh, kh, vh, key_bias, prior = inputs(145, 70, torch.float32, cuda)
    group = torch.full((70,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="Q = S"):
        tfa.flash_mha(qh, kh, vh, key_bias, None, group)
    square, bias = kh[:, :, :70], key_bias[:, :70].contiguous()
    with pytest.raises(ValueError, match="without the box prior"):
        tfa.flash_mha(qh, square, square, bias, prior, group)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_mha(qh, square, square, bias, None, group.long())


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


def _gather_in_child(indices):
    """row_gather of a (16, 4) table at ``indices`` on the card in a child
    process (a failed device-side assert leaves the CUDA context
    unusable), then a synchronize: (return code, stdout + stderr)."""
    code = (f"import sys, torch; sys.path.insert(0, {REPO!r})\n"
            "from dtlr_tpu_torch.ops import gather\n"
            "val = torch.zeros(16, 4, device='cuda')\n"
            f"idx = torch.tensor({list(indices)!r}, dtype=torch.int32, device='cuda')\n"
            "gather.row_gather(val, idx)\n"
            "print('returned without a sync', flush=True)\n"
            "torch.cuda.synchronize()\n"
            "print('synchronized', flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.mark.gpu
def test_row_gather_rejects_what_it_does_not_take(cuda):
    """An index outside [0, S) fails the kernel's device-side assert: the
    call itself returns without waiting for the card, and the next
    synchronize raises."""
    rc, out = _gather_in_child([0, 15])
    assert rc == 0 and "synchronized" in out, out
    for bad in ([0, 16], [-1, 3]):
        rc, out = _gather_in_child(bad)
        assert rc != 0 and "returned without a sync" in out and "synchronized" not in out, out
        assert "device-side assert" in out, out
    val = torch.zeros(16, 4, device=cuda)
    idx = torch.tensor([0, 15], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        gather.row_gather(val, idx.long())
    with pytest.raises(ValueError, match="float32"):
        gather.row_gather(val.bfloat16(), idx)
    with pytest.raises(ValueError, match="cuda"):
        gather.row_gather(val, idx.cpu())
