"""The port's input levels against dtlr_tpu: pixel preparation, the
full-depth GroupNorm ResNet-50 on small ragged lines, and per level the
projected ``srcs``, the pad ``masks`` and the sine position encodings.
Weights are the flax init perturbed from a numpy seed, carried across by
weights.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.dino import level_pad_mask as jax_level_pad_mask
from dtlr_tpu.models.position_encoding import (
    gen_sineembed_for_position as jax_gen_sineembed,
    sine_position_embedding_hw as jax_sine_pe)
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models.dino import build_dino, level_pad_mask
from dtlr_tpu_torch.models.position_encoding import (
    gen_sineembed_for_position, sine_position_embedding_hw)
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.weights import load_into
# assert_close: 1e-4 of each tensor's scale. float32 through 50
# convolutions that XLA and oneDNN sum in different orders leaves about
# 1e-5 of the scale on the backbone's features (measured). The projected
# levels get 3e-4: at 64x128 the last level is 1x2, so its GroupNorm(32)
# normalizes 2 values per group, y = +-d / sqrt(d^2 + eps), which turns
# that noise into 2.5e-4 where the two values are close (measured).
LEVEL_TOL = 3e-4
from test_torch_model import (NUM_CLASSES, TINY, assert_close, default_threads, jax_tiny,
                              make_lines, perturbed_params)


@pytest.fixture(scope="module", autouse=True)
def module_threads(default_threads):
    """Every test here at torch's default intra-op threads."""
    yield


def test_prep_images_matches_jax():
    images, valid_hw = make_lines()
    got = prep_images(torch.from_numpy(images), torch.from_numpy(valid_hw)).numpy()
    want = np.asarray(jax_prep_images(jnp.asarray(images), jnp.asarray(valid_hw)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 16), (3, 7), (1, 2)])
def test_level_mask_and_sine_pe(shape):
    h, w = shape
    valid_hw = np.asarray([[64, 128], [50, 93]], np.int32)
    m = level_pad_mask(torch.from_numpy(valid_hw), h, w, 64, 128)
    jm = jax_level_pad_mask(jnp.asarray(valid_hw), h, w, 64, 128)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    pe = sine_position_embedding_hw(m, num_pos_feats=16)
    jpe = jax_sine_pe(jm, num_pos_feats=16)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), atol=1e-5, rtol=0)


def test_gen_sineembed_for_position():
    pos = np.random.default_rng(3).uniform(0, 1, (2, 5, 4)).astype(np.float32)
    got = gen_sineembed_for_position(torch.from_numpy(pos), dim=16).numpy()
    want = np.asarray(jax_gen_sineembed(jnp.asarray(pos), dim=16))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_levels(m, images, valid_hw):
    feats = m.backbone_net(images)
    srcs = []
    for lvl in range(4):
        conv, norm = m.input_projs[lvl]
        x = feats[lvl] if lvl < len(feats) else (feats[-1] if lvl == len(feats) else srcs[-1])
        srcs.append(norm(conv(x)))
    return feats, srcs


def test_backbone_and_levels_match_jax():
    images, valid_hw = make_lines()
    params = perturbed_params(jax_tiny(False), images, valid_hw)
    x = jax_prep_images(jnp.asarray(images), jnp.asarray(valid_hw))
    jfeats, jsrcs = jax.jit(lambda p, im: jax_tiny(False).apply(
        p, im, valid_hw, method=_jax_levels))(params, x)

    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, params)
    vh = torch.from_numpy(valid_hw)
    pim = prep_images(torch.from_numpy(images), vh)
    with torch.no_grad():
        feats = port.backbone_net(pim.permute(0, 3, 1, 2))
        srcs, masks, poss = port.levels(pim, vh)
    assert len(feats) == 3 and len(srcs) == 4
    for f, jf in zip(feats, jfeats):
        assert_close(f.permute(0, 2, 3, 1).numpy(), jf, "backbone feature")
    for lvl, (s, js) in enumerate(zip(srcs, jsrcs)):
        assert_close(s.numpy(), js, f"level {lvl}", tol=LEVEL_TOL)
        h, w = s.shape[1:3]
        jm = jax_level_pad_mask(jnp.asarray(valid_hw), h, w, 64, 128)
        np.testing.assert_array_equal(masks[lvl].numpy(), np.asarray(jm))
        np.testing.assert_allclose(poss[lvl].numpy(),
                                   np.asarray(jax_sine_pe(jm, num_pos_feats=16)),
                                   atol=1e-5, rtol=0)
