"""The port's multi-scale deformable sampling cores
(dtlr_tpu_torch/ops/deform_attn.py) against dtlr_tpu.ops.deform_attn.

Both cores, the per-head ``deform_attn`` (against ``deform_attn_xla``
with its packed quads, and its plain per-corner path) and the head-shared
``deform_attn_shared`` (against ``deform_attn_xla_shared``), on seeded
values, on locations drawn over [-0.25, 1.25] so that many samples have
corners (or all four) outside their level, on four levels of uneven
sizes, with softmaxed attention weights:
- float32: the output, and the gradients in the value, the locations
  and the attention weights of a seeded cotangent, 1e-5 of each
  tensor's scale (its largest magnitude, at least 1);
- bfloat16 values (the compute dtype's value rows; locations and
  weights float32, as both modules hand them over): the output and the
  gradients in the locations and weights at 1e-5 too (measured at most
  9e-8 and 2e-7; the shared core rounds its folded weight to bf16 on
  both sides); the gradient in the bf16 value at BF16_TOL: it is a bf16
  tensor, which the port sums in float32 and rounds once, while JAX
  rounds each gathered sample's cotangent to bf16 and scatter-adds in
  bf16 (measured 1.95e-3 per head, 3.91e-3 shared: one or two bf16
  steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.ops import deform_attn as J
from dtlr_tpu_torch.ops import deform_attn as T
from test_torch_model import assert_close

SHAPES = ((6, 10), (3, 5), (2, 3), (1, 2))
B, LQ, M, D, P = 2, 7, 2, 4, 3
TOL, BF16_TOL = 1e-5, 1e-2


def inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    if dtype == "bfloat16":  # bf16-representable values, held as float32
        value = torch.from_numpy(value).bfloat16().float().numpy()
    loc = rng.uniform(-0.25, 1.25, (B, LQ, M, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, LQ, M, L * P)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    attn = attn.reshape(B, LQ, M, L, P).astype(np.float32)
    cot = rng.standard_normal((B, LQ, M * D)).astype(np.float32)
    return value, loc, attn, cot


def jax_per_head(value, loc, attn, dtype, packed):
    return J.deform_attn_xla(value.astype(dtype), SHAPES, loc, attn, packed=packed)


def jax_shared(value, loc, attn, dtype):
    return J.deform_attn_xla_shared(value.reshape(B, -1, M * D).astype(dtype), SHAPES,
                                    loc[:, :, 0], attn, n_heads=M)


def port_per_head(value, loc, attn, dtype):
    return T.deform_attn(value.to(dtype), SHAPES, loc, attn)


def port_shared(value, loc, attn, dtype):
    return T.deform_attn_shared(value.reshape(B, -1, M * D).to(dtype), SHAPES,
                                loc[:, :, 0], attn, M)


def jax_run(fn, arrays, cot, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    f = lambda v, l, a: fn(v, l, a, jdt)
    out, vjp = jax.vjp(f, *arrays)
    grads = vjp(jnp.asarray(cot, out.dtype))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def port_run(fn, arrays, cot, dtype):
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts, tdt)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


CASES = {
    "per_head_packed": (lambda *a: jax_per_head(*a, packed=True), port_per_head),
    "per_head_corners": (lambda *a: jax_per_head(*a, packed=False), port_per_head),
    "shared": (jax_shared, port_shared),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_core_and_its_gradients_match_jax(case, dtype):
    jfn, pfn = CASES[case]
    value, loc, attn, cot = inputs(dtype)
    # samples with corners outside their level, and wholly outside it
    assert ((loc < 0) | (loc > 1)).any(-1).mean() > 0.2
    jout, jgrads = jax_run(jfn, (value, loc, attn), cot, dtype)
    pout, pgrads = port_run(pfn, (value, loc, attn), cot, dtype)
    assert_close(pout, jout, f"{case} {dtype} output", TOL)
    for name, g, w in zip(("value", "locations", "weights"), pgrads, jgrads):
        assert_close(g, w, f"{case} {dtype} d{name}",
                     BF16_TOL if (dtype == "bfloat16" and name == "value") else TOL)


def test_level_splits():
    assert T.level_splits(SHAPES) == J.level_splits(SHAPES) == ([60, 15, 6, 2], [0, 60, 75, 81])


def test_shapes_that_do_not_fit_raise():
    value, loc, attn, _ = inputs("float32")
    with pytest.raises(ValueError, match="do not fit"):
        T.deform_attn(torch.from_numpy(value[:, 1:]), SHAPES, torch.from_numpy(loc),
                      torch.from_numpy(attn))
