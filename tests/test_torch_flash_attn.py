"""The port's box-prior attention (dtlr_tpu_torch/ops/flash_attn.py)
against dtlr_tpu/ops/flash_attn.py: the decomposed prior, the plain
version, and the Pallas kernel in interpret mode. Inputs come from a
numpy seed. Tolerance 2e-5, as tests/test_flash_attn.py holds the Pallas
kernel to its reference (float32, summed in another order).

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.ops import flash_attn as jfa
from dtlr_tpu_torch.ops import flash_attn as tfa

B, M, Q, D = 2, 4, 70, 32
TOL = 2e-5
# S = 200 fills whole 64-key tiles but the last; S = 145 leaves every
# level ragged
SPATIAL = {200: ((8, 10), (4, 10), (2, 20), (2, 20)),
           145: ((8, 13), (4, 7), (2, 5), (1, 3))}


def make_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    qh, kh, vh = f32(B, M, Q, D), f32(B, M, S, D), f32(B, M, S, D)
    key_bias = np.where(rng.uniform(size=(B, S)) < 0.2, -1e9, 0.0).astype(np.float32)
    ref = rng.uniform(0.05, 0.9, (B, Q, 4, 4)).astype(np.float32)
    gamma = np.exp(f32(M) * 0.3)
    return qh, kh, vh, key_bias, ref, gamma


def both_priors(S, ref, gamma):
    jp = jfa.make_box_prior(jnp.asarray(ref), SPATIAL[S], jnp.asarray(gamma))
    tp = tfa.make_box_prior(torch.from_numpy(ref), SPATIAL[S], torch.from_numpy(gamma))
    return jp, tp


@pytest.mark.parametrize("S", sorted(SPATIAL))
def test_make_box_prior_matches_jax(S):
    *_, ref, gamma = make_inputs(S)
    jp, tp = both_priors(S, ref, gamma)
    for name in ("cx", "cy", "ihw", "ihh", "gamma"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(tp.px.numpy(), np.asarray(jp.px)[0])
    np.testing.assert_array_equal(tp.py.numpy(), np.asarray(jp.py)[0])
    np.testing.assert_array_equal(tp.level.numpy(), np.asarray(jp.lvl_onehot).argmax(0))
    assert tp.level.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
@pytest.mark.parametrize("S", sorted(SPATIAL))
def test_dense_reference_matches_jax(S, prior, dtype):
    qh, kh, vh, key_bias, ref, gamma = make_inputs(S)
    jp, tp = both_priors(S, ref, gamma)
    jx = [jnp.asarray(a).astype(dtype) for a in (qh, kh, vh)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (qh, kh, vh)]
    want = jfa.dense_reference(*jx, jnp.asarray(key_bias), jp if prior else None)
    got = tfa.dense_reference(*tx, torch.from_numpy(key_bias), tp if prior else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
@pytest.mark.parametrize("S", sorted(SPATIAL))
def test_flash_mha_cpu_matches_pallas_interpret(S, prior):
    """On CPU tensors flash_mha is the plain version; it matches the
    Pallas kernel (``_mha_box_kernel`` / ``_mha_kernel``) in interpret
    mode, including its key-tile online softmax over a ragged S."""
    qh, kh, vh, key_bias, ref, gamma = make_inputs(S, seed=1)
    jp, tp = both_priors(S, ref, gamma)
    want = jfa.flash_mha(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh),
                         jnp.asarray(key_bias), jp if prior else None, 128, True)
    launches = dict(tfa.flash_mha.launches)
    got = tfa.flash_mha(torch.from_numpy(qh), torch.from_numpy(kh), torch.from_numpy(vh),
                        torch.from_numpy(key_bias), tp if prior else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert tfa.flash_mha.launches == launches  # the plain version is no launch


def test_fully_masked_row_is_uniform():
    """A query whose keys are all padded averages the values, as the
    dense softmax over equal -1e9 logits does in dtlr_tpu."""
    qh, kh, vh, key_bias, ref, gamma = make_inputs(145)
    key_bias[0] = -1e9
    got = tfa.dense_reference(torch.from_numpy(qh), torch.from_numpy(kh),
                              torch.from_numpy(vh), torch.from_numpy(key_bias), None)
    want = jfa.dense_reference(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh),
                               jnp.asarray(key_bias), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("prior", [True, False], ids=["box", "plain"])
def test_recompute_grad_matches_jax_grad(prior):
    """The backward of ``RecomputeGrad`` (the CUDA path's autograd
    Function), driven on the CPU with ``dense_reference`` as its forward,
    against ``jax.grad`` through ``dtlr_tpu.ops.flash_attn.flash_mha``
    (Pallas kernel in interpret mode, custom VJP). Gradients of q, k, v
    and of the prior's cx, cy, ihw, ihh and gamma; key_bias, level, px
    and py take none. Tolerance 1e-4 of each gradient's scale: float32
    on both sides, the same recompute summed in other orders."""
    S = 145
    qh, kh, vh, key_bias, ref, gamma = make_inputs(S, seed=2)
    jp, tp = both_priors(S, ref, gamma)
    w = np.random.default_rng(3).standard_normal(qh.shape).astype(np.float32)

    def jax_loss(q, k, v, pr):
        return jnp.sum(jfa.flash_mha(q, k, v, jnp.asarray(key_bias), pr, 128, True) * w)

    args = [jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh)]
    if prior:
        jq, jk, jv, jpr = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*args, jp)
        want = [jq, jk, jv, jpr.cx, jpr.cy, jpr.ihw, jpr.ihh, jpr.gamma]
    else:
        want = list(jax.grad(lambda q, k, v: jax_loss(q, k, v, None), argnums=(0, 1, 2))(*args))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (qh, kh, vh)]
    kb = torch.from_numpy(key_bias).requires_grad_()
    fields = []
    if prior:
        fields = [t.clone().requires_grad_(t.is_floating_point()) for t in tp]
        leaves += [fields[i] for i in (0, 1, 2, 3, 7)]  # cx, cy, ihw, ihh, gamma
    launches = dict(tfa.flash_mha.launches)
    out = tfa.RecomputeGrad.apply(tfa.dense_reference, *leaves[:3], kb, None, *fields)
    (out * torch.from_numpy(w)).sum().backward()
    assert tfa.flash_mha.launches == launches
    assert kb.grad is None
    assert all(fields[i].grad is None for i in (4, 5, 6) if prior)  # level, px, py
    for name, got, exp in zip(("q", "k", "v", "cx", "cy", "ihw", "ihh", "gamma"),
                              leaves, want):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got.grad.numpy(), exp, rtol=0, err_msg=name,
                                   atol=1e-4 * max(1.0, float(np.abs(exp).max())))
