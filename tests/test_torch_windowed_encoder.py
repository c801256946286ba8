"""The port's windowed encoder layer against dtlr_tpu's: both shift
parities, ragged padded columns, and a window whose keys are all padding
(``finfo.min`` logits softmax to uniform weights, never NaN). The
cross-level mix resizes with ``jax.image.resize``'s antialiasing, held
here at integer and non-integer ratios. Weights: the flax init perturbed
from a numpy seed (the zero-initialized mix projections included).
Tolerance 1e-5: float32, one layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.windowed_encoder import WindowedEncoderLayer as JaxLayer
from dtlr_tpu_torch.models.windowed_encoder import WindowedEncoderLayer, _resize
from dtlr_tpu_torch.weights import load_into

C, HEADS, WIN, FFN = 32, 4, 8, 64
SHAPES = ((4, 20), (2, 10), (1, 5), (1, 3))
TOL = 1e-5


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    src = rng.standard_normal((2, S, C)).astype(np.float32)
    pos = rng.standard_normal((2, S, C)).astype(np.float32)
    # line 0 is whole; line 1 has 6 of 20 columns at level 0, so its
    # windows past column 8 hold padding only
    masks = []
    for h, w in SHAPES:
        cols = np.arange(w)[None, None, :]
        valid_w = np.asarray([w, max(1, (6 * w) // 20)])[:, None, None]
        masks.append(np.broadcast_to(cols >= valid_w, (2, h, w)).reshape(2, -1))
    return src, pos, np.concatenate(masks, axis=1)


@pytest.mark.parametrize("shift", [False, True], ids=["even", "shifted"])
def test_layer_matches_jax(shift):
    src, pos, mask = make_inputs()
    jl = JaxLayer(C, FFN, HEADS, 4, win=WIN, shift=shift)
    params = jl.init(jax.random.PRNGKey(0), src, pos, SHAPES, mask)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(np.float32), params)
    want = np.asarray(jl.apply(params, src, pos, SHAPES, mask))

    layer = WindowedEncoderLayer(C, FFN, HEADS, win=WIN, shift=shift)
    load_into(layer, params)
    with torch.no_grad():
        got = layer(torch.from_numpy(src), torch.from_numpy(pos), SHAPES,
                    torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("src_hw,dst_hw", [((4, 20), (2, 10)), ((5, 7), (3, 4)),
                                           ((2, 10), (4, 20)), ((3, 4), (5, 7)),
                                           ((1, 3), (1, 5))])
def test_resize_matches_jax_image_resize(src_hw, dst_hw):
    x = np.random.default_rng(2).standard_normal((2, *src_hw, C)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst_hw, C), "bilinear")
    got = _resize(torch.from_numpy(x), *dst_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
