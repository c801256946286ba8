"""The self-attention LM rescorer (dtlr_tpu_torch/models/lm_rescorer.py)
against the JAX package's (dtlr_tpu/models/lm_rescorer.py) on the CPU in
float32: the x-centre position encoding, and the logits with one seeded
tree in both, its names and shapes JAX's (``weights.py`` reshapes flax's
``DenseGeneral`` q/k/v (C, M, D) and ``out`` (M, D, C) kernels), without a
padding mask and with one that pads part of a line and the whole of
another (flax's float32-lowest fill: that row attends uniformly).
Tolerance 1e-5 of the logits' scale (measured: under 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.lm_rescorer import SelfAttentionRescorer as JaxRescorer
from dtlr_tpu.models.lm_rescorer import box_x_positional_encoding as jax_pe
from dtlr_tpu_torch.models.lm_rescorer import SelfAttentionRescorer, box_x_positional_encoding
from dtlr_tpu_torch.weights import load_into
from flax.traverse_util import flatten_dict
from test_torch_backbones import seeded_tree
from test_torch_deform_fixture import nested
from test_torch_model import assert_close

B, N, C_IN, K = 3, 10, 48, 7
WIDTHS = dict(d_model=32, n_heads=4, n_layers=2, d_ffn=64)
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, N, C_IN)).astype(np.float32)
    xc = rng.uniform(size=(B, N)).astype(np.float32)
    pad = np.zeros((B, N), bool)
    pad[0, 6:] = True
    pad[2, :] = True
    jm = JaxRescorer(num_classes=K, **WIDTHS)
    port = SelfAttentionRescorer(C_IN, K, **WIDTHS)
    tree = seeded_tree(port, n_heads=WIDTHS["n_heads"])
    # the flax names and shapes, by JAX's init traced (not run)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats, xc, pad)
    assert {k: v.shape for k, v in tree.items()} == {
        "params/" + k: tuple(v.shape) for k, v in flatten_dict(shapes["params"], sep="/").items()}
    load_into(port, tree)
    return jm, nested(tree), port, feats, xc, pad


def test_position_encoding_matches_jax():
    xc = np.random.default_rng(1).uniform(size=(2, 5)).astype(np.float32)
    np.testing.assert_allclose(box_x_positional_encoding(torch.from_numpy(xc), 32).numpy(),
                               np.asarray(jax_pe(jnp.asarray(xc), 32)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "pad_mask"])
def test_logits_match_jax(pair, masked):
    jm, params, port, feats, xc, pad = pair
    mask = pad if masked else None
    want = np.asarray(jax.jit(jm.apply)(params, feats, xc, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(xc),
                   None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, N, K) and np.isfinite(got.numpy()).all()
    assert_close(got.numpy(), want, f"logits masked={masked}", tol=TOL)
