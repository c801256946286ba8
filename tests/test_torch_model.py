"""The port's whole DINO forward against dtlr_tpu at a tiny geometry.

The same random weights (the flax init, perturbed from a numpy seed so
that no zero-initialized head hides a path) go into both packages; the
same uint8 lines with ragged valid sizes go through both. The JAX model
runs once with the materialized cross-attention and once with its
Pallas kernel in interpret mode; the port runs its plain path on the
CPU. Tolerance 1e-4 of each tensor's scale (its largest magnitude, at
least 1): float32 on both sides, but XLA and oneDNN sum the convolutions
of the full-depth ResNet-50 in different orders, which leaves noise of
about 1e-5 to 4e-5 of the scale in the backbone's outputs (measured, see
test_torch_backbone.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models import transformer as port_transformer
from dtlr_tpu_torch.models.dino import DinoConfig, build_dino
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.weights import load_into

TOL = 1e-4
TINY = DinoConfig(num_queries=24, hidden_dim=32, nheads=4, enc_layers=2,
                  dec_layers=2, dim_feedforward=64, encoder_win=8,
                  compute_dtype="float32")
NUM_CLASSES = 12


def jax_tiny(flash: bool) -> JaxDINO:
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=TINY.num_queries,
        hidden_dim=TINY.hidden_dim, n_heads=TINY.nheads,
        num_encoder_layers=TINY.enc_layers, num_decoder_layers=TINY.dec_layers,
        d_ffn=TINY.dim_feedforward, num_feature_levels=4, use_dn=False,
        dn_labelbook_size=NUM_CLASSES + 1, norm_kind="group",
        encoder_type="windowed", encoder_win=TINY.encoder_win,
        decoder_ca="dense", dense_box_bias=True, flash_attn=flash,
        dtype=jnp.float32)


def assert_close(got, want, what: str, tol: float = TOL):
    """|got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=what,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def make_lines(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(2, 64, 128, 3), dtype=np.uint8)
    valid_hw = np.asarray([[64, 128], [50, 93]], np.int32)
    return images, valid_hw


def perturbed_params(model, images, valid_hw, seed=1):
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jax_prep_images(images, valid_hw), valid_hw, None,
                        train=False)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.05, x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    images, valid_hw = make_lines()
    params = perturbed_params(jax_tiny(False), images, valid_hw)
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, params)
    return images, valid_hw, params, port


def run_port(port, images, valid_hw):
    seen = {}

    def recording_top_k(scores, k):
        idx = orig(scores, k)
        seen["scores"], seen["idx"] = scores, idx
        return idx

    orig = port_transformer.top_k_stable
    port_transformer.top_k_stable = recording_top_k
    try:
        vh = torch.from_numpy(valid_hw)
        with torch.no_grad():
            out = port(prep_images(torch.from_numpy(images), vh), vh)
    finally:
        port_transformer.top_k_stable = orig
    return out, seen


def _pairs(jo, po):
    yield "final", jo, po
    for i, (ja, pa) in enumerate(zip(jo["aux_outputs"], po["aux_outputs"])):
        yield f"aux{i}", ja, pa
    yield "interm", jo["interm_outputs"], po["interm_outputs"]
    yield ("interm_pre", jo["interm_outputs_for_matching_pre"],
           po["interm_outputs_for_matching_pre"])


@pytest.mark.parametrize("flash", [False, True], ids=["materialized", "pallas_interpret"])
def test_forward_matches_jax(setup, flash):
    images, valid_hw, params, port = setup
    jout = jax.jit(lambda p, im, vh: jax_tiny(flash).apply(
        p, jax_prep_images(im, vh), vh, None, train=False))(params, images, valid_hw)
    pout, seen = run_port(port, images, valid_hw)

    # the two-stage selection must pick the same proposals in the same
    # order: report the closest scores if it does not
    jsel = np.asarray(jout["interm_outputs_for_matching_pre"]["pred_boxes"])
    psel = pout["interm_outputs_for_matching_pre"]["pred_boxes"].numpy()
    if not np.allclose(jsel, psel, atol=1e-6):
        s = np.sort(seen["scores"].numpy(), axis=1)[:, ::-1]
        gap = np.diff(s[:, :TINY.num_queries + 1], axis=1).min()
        pytest.fail(f"top-k selection differs; smallest score gap {-gap:.3g}")

    assert len(jout["aux_outputs"]) == len(pout["aux_outputs"]) == TINY.dec_layers - 1
    for name, j, p in _pairs(jout, pout):
        for key in ("pred_logits", "pred_boxes"):
            assert p[key].shape == j[key].shape, (name, key)
            assert_close(p[key].numpy(), j[key], f"{name} {key}")
