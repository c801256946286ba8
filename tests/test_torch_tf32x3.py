"""The arithmetic of the fp32 attention kernel (dtlr_tpu_torch/csrc/box_attn.cu,
namespace f32), emulated on the CPU: 3xTF32 products on the tensor cores.

Each fp32 operand x is split into big = tf32(x) and small = tf32(x - big)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10 stored
mantissa bits), and every product of the two matrix products is formed as
small.big + big.small + big.big by ``mma.m16n8k8`` with fp32 accumulators.
Each mma is emulated with its products exact and their sum with the
accumulator exact, then rounded to fp32: to nearest (the accumulator's
nominal precision), or toward zero, as earlier tensor cores were measured
to round (Fasi et al., "Numerical behavior of NVIDIA tensor cores",
2021). The kernel's structure is kept: 64-key tiles, the online softmax
in fp32, the row sums in fp32, each tile's P.V in a fresh accumulator
joined to O by one fp32 FMA.

At the decoder's value ranges (D = 32, the 1/sqrt(D) scale, q and k rows
of unit scale, softmax weights times V rows of unit scale) and against a
float64 reference: 3xTF32 stays within twice plain fp32's own error
(``dense_reference`` in fp32) and far inside the kernel's 1e-4 tolerance;
a single TF32 product (one mma of tf32(a).tf32(b)) does not. And why each
tile starts its own P.V accumulator: with sums rounded toward zero, one
accumulator chained over all 2720 keys of the cross-attention drifts far
more than the per-tile ones (on an H100 a chain over all keys of the
kernel's self-attention measured several times the error of a chain per
tile).
"""

import math

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.ops.flash_attn import dense_reference

D, BK = 32, 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
SCALE = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
# the k-steps of q.k: the kernel's k index t of k-step ks is dim 8t + 2ks
# (and t + 4 the next dim), so k-step ks sums these eight dims
QK_STEPS = [[8 * t + 2 * ks + h for t in range(4) for h in range(2)] for ks in range(4)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 bit patterns: add half of the 13
    dropped bits' unit to the magnitude, then clear them (a tie rounds
    away from zero; a carry moves into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma(c, a, b, rz=False):
    """c (fp32) + a @ b, products and sum exact, rounded to fp32 (toward
    zero with ``rz``)."""
    exact = c.double() + a.double() @ b.double()
    return round_toward_zero(exact) if rz else exact.float()


def products_3xtf32(c, steps, rz=False):
    """c plus the products of ``steps`` [(a, b), ...] (one k-step each) in
    3xTF32, in the kernel's order: per step small.big, big.small, big.big."""
    for a, b in steps:
        (ab, as_), (bb, bs) = split(a), split(b)
        c = mma(mma(mma(c, as_, bb, rz), ab, bs, rz), ab, bb, rz)
    return c


def products_1xtf32(c, steps, rz=False):
    """The same with a single TF32 product per step."""
    for a, b in steps:
        c = mma(c, tf32(a), tf32(b), rz)
    return c


def fma(a, b, c):
    """fp32 a * b + c with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def emulated_attention(q, k, v, products=products_3xtf32, per_tile=True, rz=False):
    """The kernel's forward on fp32 (B, M, Q, D) q and (B, M, S, D) k, v
    (no prior, no padding): 64-key tiles, scores by ``products`` over
    k-steps of 8 dims, online softmax in fp32 (exponents by exp2, the
    kernel's ex2), P.V over k-steps of 8 keys into a fresh accumulator per
    tile (``per_tile``) or into one chained over all keys; the tensor
    cores' sums rounded toward zero with ``rz``."""
    B, M, Q, _ = q.shape
    S = k.shape[2]
    mrow = torch.full((B, M, Q), -1e30, dtype=torch.float32)
    mlog = mrow * LOG2E
    lsum = torch.zeros(B, M, Q)
    o = torch.zeros(B, M, Q, D)
    for s0 in range(0, S, BK):
        kt, vt = k[:, :, s0:s0 + BK], v[:, :, s0:s0 + BK]
        sc = products(torch.zeros(B, M, Q, kt.shape[2]),
                      [(q[..., dims], kt[..., dims].transpose(-1, -2)) for dims in QK_STEPS], rz)
        t = fma(sc, SCALE, torch.zeros(()))
        mnew = torch.maximum(mrow, t.max(-1).values)
        mlnew = mnew * LOG2E
        alpha = torch.exp2(mlog - mlnew)
        mrow, mlog = mnew, mlnew
        p = torch.exp2(fma(t, LOG2E, -mlog[..., None]))
        lsum = fma(lsum, alpha, p.sum(-1))
        pv = products(torch.zeros(B, M, Q, D) if per_tile else o * alpha[..., None],
                      [(p[..., j:j + 8], vt[:, :, j:j + 8]) for j in range(0, kt.shape[2], 8)], rz)
        o = fma(o, alpha[..., None], pv) if per_tile else pv
    return o / lsum[..., None]


def exact_attention(q, k, v):
    return ((q.double() @ k.double().transpose(-1, -2)) / math.sqrt(D)).softmax(-1) @ v.double()


@pytest.fixture(scope="module")
def decoder_inputs():
    """q, k, v heads of unit scale at the decoder's self-attention length
    (S = 900) and its cross-attention's (S = 2720), a few heads and
    queries."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {S: (t(1, 2, 32, D), t(1, 2, S, D), t(1, 2, S, D)) for S in (900, 2720)}


def errors(q, k, v):
    exact = exact_attention(q, k, v)
    err = lambda out: float((out.double() - exact).abs().max())
    return {"fp32": err(dense_reference(q, k, v, torch.zeros(q.shape[0], k.shape[2]), None)),
            "3xtf32": err(emulated_attention(q, k, v)),
            "1xtf32": err(emulated_attention(q, k, v, products=products_1xtf32)),
            "3xtf32_rz": err(emulated_attention(q, k, v, rz=True)),
            "3xtf32_rz_one_chain": err(emulated_attention(q, k, v, per_tile=False, rz=True))}


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's unit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + ulp / 2 + 2 ** -23, 2 - 2 ** -23, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 2.0, 3.0, 0.0]
    assert tf32(x).tolist() == want
    # the split keeps x to 2^-22 of its size: the small part carries the
    # next 11 bits
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    big, small = split(x)
    assert (tf32(big) == big).all() and (tf32(small) == small).all()
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0 ** -22
    assert ((big.double() - x.double()).abs() / x.double().abs()).max() > 2.0 ** -12


@pytest.mark.parametrize("S", [900, 2720])
def test_3xtf32_keeps_fp32_accuracy(decoder_inputs, S):
    e = errors(*decoder_inputs[S])
    assert e["3xtf32"] <= 2 * e["fp32"], e
    assert e["3xtf32"] <= 1e-6, e  # far inside the kernel's 1e-4
    # a single TF32 product does not
    assert e["1xtf32"] > 10 * e["fp32"] and e["1xtf32"] > 1e-5, e


def test_per_tile_accumulator_beats_one_chain(decoder_inputs):
    """Tensor-core sums rounded toward zero, chained through every key of
    the cross-attention's 2720, drift further than the per-tile
    accumulators', which stay far inside 1e-4."""
    e = errors(*decoder_inputs[2720])
    assert e["3xtf32_rz_one_chain"] > 10 * e["3xtf32_rz"], e
    assert e["3xtf32_rz"] <= 1e-6, e
