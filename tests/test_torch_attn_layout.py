"""The layout the attention kernel reads, and the rounding its bf16
tensor-core design adds (dtlr_tpu_torch/ops/flash_attn.py,
csrc/box_attn.cu), checked on the CPU.

- ``kernel_strides``: the decoder's projection views, (B, S, M, D)
  transposed to (B, M, S, D), pass with their strides; a last axis that
  is not unit-stride, a misaligned start or a misaligned row is refused.
- ``MultiHeadAttention`` on those views equals its old result on
  contiguous copies, and matches dtlr_tpu's ``MultiHeadAttention``
  (``use_flash=True``: the Pallas kernel in interpret mode) at ``TINY``'s
  widths; ``RecomputeGrad`` accepts a forward that returns a view, as the
  CUDA path's (B, Q, M, D)-laid-out result is.
- An emulation of the bf16 kernel's arithmetic (fp32 logits per 64-key
  tile, running max, unnormalized probabilities rounded to bf16 before
  P.V, row sums of the same rounded probabilities) stays within the bf16
  tolerance 2e-2 of ``dense_reference`` at the decoder's shapes, so the
  tolerance is met by design. It is a plain model of the kernel's
  rounding; the kernel itself is held to ``dense_reference`` on the card
  (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.layers import MultiHeadAttention as JaxMHA
from dtlr_tpu.ops import flash_attn as jfa
from dtlr_tpu_torch.models.layers import MultiHeadAttention
from dtlr_tpu_torch.ops import flash_attn as tfa
from dtlr_tpu_torch.weights import load_into

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the flagship's decoder and its eval bucket's levels (S = 2720)
M, D = 8, 32
LEVELS_2720 = ((16, 128), (8, 64), (4, 32), (2, 16))
# ``ca_box_gamma`` of the flagship checkpoint's decoder layers 0 and 5
# (artifacts/r4ft_params.npz): the prior's sharpness is exp of these
CA_BOX_GAMMA = {0: (0.2737, 0.407, 0.2913, 0.95, 0.79, 0.0744, 0.9814, 0.1917),
                5: (0.04004, -0.04996, -0.005516, -0.03958, 0.00825, 0.3345, 0.02805,
                    -0.02965)}
BF16_TOL = 2e-2


def projection_heads(B, n, dtype, rng):
    """(B, M, n, D) view of a (B, n, M*D) projection, as the decoder builds it."""
    x = torch.from_numpy(rng.standard_normal((B, n, M * D)).astype(np.float32)).to(dtype)
    return x.view(B, n, M, D).transpose(1, 2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_strides_take_the_projection_views(dtype):
    rng = np.random.default_rng(0)
    B, S, Q = 2, 145, 70
    kh = projection_heads(B, S, DTYPES[dtype], rng)
    assert not kh.is_contiguous()
    got = tfa.kernel_strides("kh", kh, (B, M, S, D), (DTYPES[dtype],), kh.device)
    assert got == (S * M * D, D, M * D)
    out = torch.empty((B, Q, M, D), dtype=torch.float32).transpose(1, 2)
    assert tfa.kernel_strides("out", out, (B, M, Q, D), (torch.float32,),
                              out.device) == (Q * M * D, D, M * D)
    # contiguous heads pass too
    assert tfa.kernel_strides("kh", kh.contiguous(), (B, M, S, D), (DTYPES[dtype],),
                              kh.device) == (M * S * D, S * D, D)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_strides_refuse_what_the_kernel_does_not_take(dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    B, S = 2, 145
    kh = projection_heads(B, S, dt, rng)
    shape, dev = (B, M, S, D), kh.device
    check = lambda t: tfa.kernel_strides("kh", t, shape, (dt,), dev)
    with pytest.raises(ValueError, match="contiguous"):  # D not unit-stride
        check(kh.transpose(2, 3).contiguous().transpose(2, 3))
    flat = torch.zeros(B * S * M * D + 1, dtype=dt)
    with pytest.raises(ValueError, match="16-byte"):  # starts one element in
        check(flat[1:].view(B, S, M, D).transpose(1, 2))
    unit = 16 // flat.element_size()
    wide = torch.zeros(B, S, M * D + unit // 2, dtype=dt)  # rows half a unit too long
    with pytest.raises(ValueError, match="is not a multiple of"):
        check(wide[..., :M * D].unflatten(-1, (M, D)).transpose(1, 2))
    with pytest.raises(TypeError, match="dtype"):
        tfa.kernel_strides("kh", kh.float() if dt == torch.bfloat16 else kh.bfloat16(),
                           shape, (dt,), dev)
    with pytest.raises(ValueError, match="shape"):
        check(kh[:, :, :-1])


def old_forward(mha, q, k, v, key_bias, prior):
    """MultiHeadAttention.forward as it was, with contiguous head copies."""
    B, Lq, C = q.shape
    S = k.shape[1]
    Dh = C // mha.n_heads
    qh = mha.q_proj(q).view(B, Lq, mha.n_heads, Dh).transpose(1, 2).contiguous()
    kh = mha.k_proj(k).view(B, S, mha.n_heads, Dh).transpose(1, 2).contiguous()
    vh = mha.v_proj(v).view(B, S, mha.n_heads, Dh).transpose(1, 2).contiguous()
    out = tfa.flash_mha(qh, kh, vh, key_bias, prior)
    return mha.out_proj(out.to(mha.compute_dtype).transpose(1, 2).reshape(B, Lq, C))


def tiny_mha_inputs(seed, C, n_heads, Q=24, S=145):
    spatial = ((8, 13), (4, 7), (2, 5), (1, 3))
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k = f32(2, Q, C), f32(2, S, C)
    key_bias = np.where(rng.uniform(size=(2, S)) < 0.2, -1e9, 0.0).astype(np.float32)
    ref = rng.uniform(0.05, 0.9, (2, Q, 4, 4)).astype(np.float32)
    gamma = np.exp(0.3 * f32(n_heads))
    return q, k, key_bias, ref, gamma, spatial


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
def test_mha_on_strided_views_equals_contiguous(prior, dtype):
    torch.manual_seed(0)
    C, n_heads = M * D, M
    mha = MultiHeadAttention(C, n_heads, DTYPES[dtype])
    q, k, key_bias, ref, gamma, spatial = tiny_mha_inputs(0, C, n_heads)
    box = (tfa.make_box_prior(torch.from_numpy(ref), spatial, torch.from_numpy(gamma))
           if prior else None)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
            torch.from_numpy(key_bias), box)
    with torch.no_grad():
        got = mha(*args)
        want = old_forward(mha, *args)
    assert got.dtype == want.dtype == DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
def test_mha_matches_jax_at_tiny(prior):
    """The port's MultiHeadAttention (strided heads into the plain version)
    against dtlr_tpu's with ``use_flash=True`` (Pallas kernel in interpret
    mode) at TINY's widths (hidden 32, 4 heads), the same weights and
    inputs. Tolerance 2e-5 as tests/test_torch_flash_attn.py."""
    C, n_heads = 32, 4
    q, k, key_bias, ref, gamma, spatial = tiny_mha_inputs(1, C, n_heads)
    jm = JaxMHA(d_model=C, n_heads=n_heads)
    jp = jfa.make_box_prior(jnp.asarray(ref), spatial, jnp.asarray(gamma)) if prior else None
    call = lambda p, *a: jm.apply(p, *a, key_bias=jnp.asarray(key_bias), box_prior=jp,
                                  use_flash=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                     key_bias=jnp.asarray(key_bias), box_prior=jp, use_flash=True)
    want = np.asarray(call(params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)))

    mha = MultiHeadAttention(C, n_heads)
    load_into(mha, params)
    tp = (tfa.make_box_prior(torch.from_numpy(ref), spatial, torch.from_numpy(gamma))
          if prior else None)
    with torch.no_grad():
        got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                  torch.from_numpy(key_bias), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_recompute_grad_takes_a_view_from_the_forward():
    """The CUDA forward returns a (B, M, Q, D) view of (B, Q, M, D) storage;
    autograd takes it, and the gradients are the plain version's."""
    rng = np.random.default_rng(2)
    qh, kh, vh = (projection_heads(2, n, torch.float32, rng) for n in (24, 145, 145))
    key_bias = torch.zeros(2, 145)
    w = torch.from_numpy(rng.standard_normal((2, M, 24, D)).astype(np.float32))

    def as_kernel_lays_out(*a):
        out = tfa.dense_reference(*a)
        return out.transpose(1, 2).contiguous().transpose(1, 2)

    grads = []
    for fwd in (as_kernel_lays_out, None):
        leaves = [t.detach().clone().requires_grad_() for t in (qh, kh, vh)]
        if fwd is None:
            out = tfa.dense_reference(*leaves, key_bias, None)
        else:
            out = tfa.RecomputeGrad.apply(fwd, *leaves, key_bias, None)
            assert not out.is_contiguous()
        (out * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def emulate_bf16_kernel(qh, kh, vh, key_bias, prior, tile=64):
    """The bf16 kernel's arithmetic, dense per key tile: q.k^T of bf16
    inputs summed in fp32, logits in fp32, a running max per row, the
    unnormalized probabilities 2^(t log2e - m log2e) rounded to bf16 as the
    operand of P.V and of the row sums (the kernel's P times a column of
    ones), summed in fp32, one rescale per tile."""
    Bq, Mq, Qq, Dq = qh.shape
    S = kh.shape[2]
    log2e = 1.4426950408889634
    q, k, v = qh.float(), kh.float(), vh.float()
    acc = torch.zeros(Bq, Mq, Qq, Dq)
    mlog = torch.full((Bq, Mq, Qq, 1), -1e30 * log2e)
    mrow = torch.full((Bq, Mq, Qq, 1), -1e30)
    lsum = torch.zeros(Bq, Mq, Qq, 1)
    for s0 in range(0, S, tile):
        sl = slice(s0, min(S, s0 + tile))
        t = q @ k[:, :, sl].transpose(-1, -2) * (1 / math.sqrt(Dq))
        t = t + key_bias[:, None, None, sl]
        if prior is not None:
            lvl = prior.level[sl].long()
            dx = (prior.px[sl] - prior.cx[..., lvl]) * prior.ihw[..., lvl]
            dy = (prior.py[sl] - prior.cy[..., lvl]) * prior.ihh[..., lvl]
            t = t - (0.5 * prior.gamma)[None, :, None, None] * (dx * dx + dy * dy)[:, None]
        mnew = torch.maximum(mrow, t.amax(-1, keepdim=True))
        mlnew = mnew * log2e
        alpha = torch.exp2(mlog - mlnew)
        p = torch.exp2(t * log2e - mlnew).bfloat16().float()
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ v[:, :, sl]
        mrow, mlog = mnew, mlnew
    return acc / lsum


@pytest.mark.parametrize("case", ["wide_boxes", "char_boxes", "sharp_logits", "no_prior"])
@pytest.mark.parametrize("layer", sorted(CA_BOX_GAMMA))
def test_bf16_kernel_rounding_meets_the_tolerance(case, layer):
    """At the decoder's shapes (one line, 8 heads, Q=900, S=2720, the eval
    bucket's levels, 20% of keys padded) and its prior's sharpness, the
    emulated bf16 kernel stays within 2e-2 of dense_reference; and the
    emulation is no coarser than the bf16 rounding it models (each
    probability off by at most 2^-9 of itself)."""
    rng = np.random.default_rng(layer)
    B, Q, S = 1, 900, 2720
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    qh, kh, vh = (f(B, M, n, D).bfloat16() for n in (Q, S, S))
    if case == "sharp_logits":  # q.k / sqrt(D) with a spread of about 4
        qh = (qh.float() * 4).bfloat16()
    key_bias = torch.from_numpy(np.where(rng.uniform(size=(B, S)) < 0.2, -1e9, 0.0)
                                .astype(np.float32))
    prior = None
    if case != "no_prior":
        cxy = rng.uniform(0.02, 0.98, (B, Q, 4, 2))
        if case == "char_boxes":  # a character of a 1024-wide line: w 0.5-5%, h 30-90%
            wh = np.stack([rng.uniform(0.005, 0.05, (B, Q, 4)),
                           rng.uniform(0.3, 0.9, (B, Q, 4))], -1)
        else:
            wh = rng.uniform(0.05, 0.9, (B, Q, 4, 2))
        ref = torch.from_numpy(np.concatenate([cxy, wh], -1).astype(np.float32))
        gamma = torch.exp(torch.tensor(CA_BOX_GAMMA[layer]))
        prior = tfa.make_box_prior(ref, LEVELS_2720, gamma)
    want = tfa.dense_reference(qh, kh, vh, key_bias, prior)
    got = emulate_bf16_kernel(qh, kh, vh, key_bias, prior)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= BF16_TOL, err
    # bound of the bf16 rounding of P: the weights p~/sum p~ differ from
    # p/sum p by at most 2 * 2^-9 of themselves, so the output by 2^-8 max |v|
    assert err <= 2.0 ** -8 * float(vh.float().abs().max()) + 1e-5, err
