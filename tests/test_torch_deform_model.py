"""The reference-faithful architectures of the port (deformable encoder,
deformable or dense cross-attention without the prior, FrozenBatchNorm
backbone, head-shared offsets) against dtlr_tpu at the tiny geometry
(``TINY`` of test_torch_model.py).

The forward is parametrised so that every value of each switch runs:
``encoder_type`` (deformable, windowed), ``decoder_ca`` (deform, dense
with and without the box prior), ``shared_offsets`` (off, on) and the
backbone's norm (group, FrozenBatchNorm2d). The weights are the port's
fresh init (JAX's initializers, test_torch_init.py) with seeded noise on
every leaf (so the zero-initialized sampling
offsets and attention-weight kernels make the locations depend on the
query, and the FrozenBN statistics are not the identity); the two lines
have different valid widths, so the padded levels and the encoder's
reference points differ between them (128x256 lines). Tolerance: 1e-4 of each tensor's
scale, test_torch_model.py's.

The first detection step of these architectures is in
test_torch_deform_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.train.init import init_params
from dtlr_tpu_torch.train.optim import label_params
from dtlr_tpu_torch.weights import load_into
from test_torch_model import NUM_CLASSES, TINY, assert_close, run_port, _pairs

#: (encoder_type, decoder_ca, dense_box_bias, shared_offsets, norm_kind)
ARCHS = {
    "latin": ("deformable", "deform", False, False, "FrozenBatchNorm2d"),
    "deformable_shared_group": ("deformable", "deform", False, True, "group"),
    "deformable_dense": ("deformable", "dense", False, False, "FrozenBatchNorm2d"),
    "windowed_deform_shared": ("windowed", "deform", False, True, "FrozenBatchNorm2d"),
    "windowed_deform_group": ("windowed", "deform", False, False, "group"),
    "deformable_dense_box_bias": ("deformable", "dense", True, True, "group"),
}


def port_cfg(arch, **kw):
    enc, ca, bias, shared, norm = ARCHS[arch]
    return dataclasses.replace(TINY, encoder_type=enc, decoder_ca=ca, dense_box_bias=bias,
                               shared_offsets=shared, norm_kind=norm, **kw)


def jax_model(arch, **kw) -> JaxDINO:
    enc, ca, bias, shared, norm = ARCHS[arch]
    kw = {"use_dn": False, **kw}
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=TINY.num_queries, hidden_dim=TINY.hidden_dim,
        n_heads=TINY.nheads, num_encoder_layers=TINY.enc_layers,
        num_decoder_layers=TINY.dec_layers, d_ffn=TINY.dim_feedforward,
        num_feature_levels=4, dn_labelbook_size=NUM_CLASSES + 1, norm_kind=norm,
        encoder_type=enc, encoder_win=TINY.encoder_win, decoder_ca=ca,
        dense_box_bias=bias, shared_offsets=shared, dtype=jnp.float32, **kw)


def nested(flat):
    """A flat ``params/...`` tree as flax's nested dict."""
    out = {}
    for key, x in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def seeded_params(arch, seed=1):
    """The port's fresh init (JAX's families, names and shapes,
    test_torch_init.py) with normal(0, 0.05) noise on every leaf, as a
    nested flax tree; the FrozenBN variances stay positive (1 + noise)."""
    flat = init_params(dataclasses.replace(port_cfg(arch), dn_labelbook_size=NUM_CLASSES + 1),
                       NUM_CLASSES, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    return nested({k: x + rng.normal(0.0, 0.05, x.shape).astype(np.float32)
                   for k, x in sorted(flat.items())})


@pytest.fixture(scope="module")
def lines():
    """Two random 128x256 lines of different valid sizes. At 64x128 the
    last level is 1x2, where a GroupNorm group of one channel over two
    pixels amplifies the backbone's float noise (test_torch_dtype.py);
    here it is 2x4."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 128, 256, 3), dtype=np.uint8)
    return images, np.asarray([[128, 256], [100, 181]], np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(lines, arch):
    images, valid_hw = lines
    assert valid_hw[0, 1] != valid_hw[1, 1]  # the levels' valid widths differ
    jmodel = jax_model(arch)
    params = seeded_params(arch)
    jout = jax.jit(lambda p, im, vh: jmodel.apply(
        p, jax_prep_images(im, vh), vh, None, train=False))(params, images, valid_hw)
    port = build_dino(port_cfg(arch), NUM_CLASSES, device="cpu")
    load_into(port, params)
    pout, seen = run_port(port, images, valid_hw)

    jsel = np.asarray(jout["interm_outputs_for_matching_pre"]["pred_boxes"])
    psel = pout["interm_outputs_for_matching_pre"]["pred_boxes"].numpy()
    if not np.allclose(jsel, psel, atol=1e-6):
        s = np.sort(seen["scores"].numpy(), axis=1)[:, ::-1]
        gap = np.diff(s[:, :TINY.num_queries + 1], axis=1).min()
        pytest.fail(f"top-k selection differs; smallest score gap {-gap:.3g}")
    for name, j, p in _pairs(jout, pout):
        for key in ("pred_logits", "pred_boxes"):
            assert p[key].shape == j[key].shape, (name, key)
            assert_close(p[key].numpy(), j[key], f"{arch} {name} {key}")


def test_frozen_norm_leaves_are_labelled_frozen():
    port = build_dino(port_cfg("latin"), NUM_CLASSES, device="cpu")
    labels = label_params([n for n, _ in port.named_parameters()])
    frozen = sorted(n for n, g in labels.items() if g == "frozen")
    # the stem's and each of the 16 bottlenecks' 3 or 4 norms, 4 leaves each
    assert len(frozen) == 4 * (1 + 16 * 3 + 4)
    assert all(n.startswith("backbone_net.") and "FrozenBatchNorm_" in n for n in frozen)

