"""The port's gradients against ``jax.grad`` at the tiny geometry
(``TINY``, float32): every leaf's gradient of one scalar of the model's
outputs, the same random weights and lines on both sides.

The scalar weighs every ``pred_logits`` and ``pred_boxes`` the model
returns (final, auxiliary, two-stage) with seeded random weights. JAX
stops the gradient at the decoder's initial reference points and
between its layers (dtlr_tpu/models/transformer.py:423,469) while the
outputs keep the undetached boxes; without those stops the boxes' loss
reaches each layer's box head, the query positions and the box prior
through every later layer, and the box heads' gradients differ by far
more than the tolerance.

The weights: the flagship checkpoint's trained ResNet-50 (the backbone
is the same at every geometry) and the flax init with seeded noise on
every other leaf (no zero-initialized head hides a path); the lines:
two 128x256 crops of the committed fixture lines. With the backbone's
random init, or random pixels, or 64x128 lines (whose 1x2 last level
has a GroupNorm over two values), the backbone's gradient is float noise
amplified, and even JAX's own gradients move by tens of percent from one
compilation to another. Tolerances, per leaf, as a fraction of that
leaf's largest gradient magnitude (at least 1e-3 of the largest over all
leaves, so that a leaf whose gradient is near zero, such as the key
projections' biases that softmax cancels, is held to the model's scale):
- 2e-3 for every leaf outside the backbone and the input projections'
  convolutions (measured 2.5e-4);
- 5e-2 for the backbone and the input projections' convolutions
  (measured 2.6e-2): flipping the lowest bit of one input pixel moves
  JAX's own gradients of these leaves by 3.1e-2 of their scale
  (measured; ``test_backbone_gradients_are_within_jax_own_noise``).
float32 on both sides; XLA and oneDNN sum in other orders.
"""

import jax
import numpy as np
import pytest
import torch

from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.weights import load_into, params_from_npz
from test_torch_model import NUM_CLASSES, TINY, default_threads, jax_tiny, make_lines
from test_torch_smoke_fixture import FIXTURE, PARAMS


@pytest.fixture(scope="module", autouse=True)
def module_threads(default_threads):
    """Every test here at torch's default intra-op threads."""
    yield


TOL, BACKBONE_TOL, FLOOR = 2e-3, 5e-2, 1e-3
#: leaves held to BACKBONE_TOL
CHAOTIC = ("params/backbone_net/", "params/input_proj_0_conv/", "params/input_proj_1_conv/",
           "params/input_proj_2_conv/", "params/input_proj_3_conv/")


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def outputs_list(out):
    """Every (pred_logits, pred_boxes) pair of a model output dict."""
    pairs = [out] + list(out["aux_outputs"]) + [out["interm_outputs"],
                                                 out["interm_outputs_for_matching_pre"]]
    return [(p["pred_logits"], p["pred_boxes"]) for p in pairs]


def scalar_weights(seed=7):
    rng = np.random.default_rng(seed)
    n_pairs = TINY.dec_layers + 2
    B, nq = 2, TINY.num_queries
    return [(rng.normal(size=(B, nq, NUM_CLASSES)).astype(np.float32),
             rng.normal(size=(B, nq, 4)).astype(np.float32)) for _ in range(n_pairs)]


def jax_grad_fn(weights):
    """grads(params, images, valid_hw) of the scalar, jitted once."""
    model = jax_tiny(False)

    def scalar(p, images, valid_hw):
        out = model.apply(p, jax_prep_images(images, valid_hw), valid_hw, None, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return sum((lg * wl).sum() + (bx * wb).sum()
                   for (lg, bx), (wl, wb) in zip(outputs_list(out), weights))

    grad = jax.jit(jax.grad(scalar))
    return lambda params, images, valid_hw: flat(grad(params, images, valid_hw))


def port_grads(params, images, valid_hw, weights):
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, params)
    port.train()
    vh = torch.from_numpy(valid_hw)
    out = port(prep_images(torch.from_numpy(images), vh), vh)
    s = sum((lg * torch.from_numpy(wl)).sum() + (bx * torch.from_numpy(wb)).sum()
            for (lg, bx), (wl, wb) in zip(outputs_list(out), weights))
    s.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in port.named_parameters()}
    return params_to_flax(grads)


def line_crops(picks=(1, 5), x0=100, width=256):
    """Two 128 x ``width`` crops of the committed fixture lines, one of
    them padded to 100 x 186 (ragged valid sizes)."""
    lines = load_lines(FIXTURE)
    images = np.ascontiguousarray(lines["images"][list(picks), :, x0:x0 + width])
    return images, np.asarray([[128, width], [100, 186]], np.int32)


def trained_backbone_params(seed=1):
    """TINY's weights: the flagship checkpoint's trained ResNet-50 and, on
    every other leaf, the flax init with N(0, 0.05) noise from a numpy
    seed."""
    params = head_perturbed_params(*make_lines(), seed=seed)
    trained = params_from_npz(PARAMS)

    def take(path, x):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        return trained[key].astype(np.float32) if "/backbone_net/" in key else x

    return jax.tree_util.tree_map_with_path(take, params)


def head_perturbed_params(images, valid_hw, seed=1):
    """The flax init, with N(0, 0.05) noise from a numpy seed on every leaf
    outside the backbone (no zero-initialized head hides a path)."""
    params = jax_tiny(False).init({"params": jax.random.PRNGKey(0)},
                                  jax_prep_images(images, valid_hw), valid_hw, None,
                                  train=False)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        if any(getattr(k, "key", None) == "backbone_net" for k in path):
            return x
        return x + rng.normal(0.0, 0.05, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def grads():
    """JAX's gradients, the port's, and JAX's again with the lowest bit of
    one input pixel flipped."""
    images, valid_hw = line_crops()
    params = trained_backbone_params()
    weights = scalar_weights()
    jax_grads = jax_grad_fn(weights)
    flipped = images.copy()
    flipped[0, 10, 10, 0] ^= 1
    return (jax_grads(params, images, valid_hw), port_grads(params, images, valid_hw, weights),
            jax_grads(params, flipped, valid_hw))


def relative_errors(got, want):
    """Per leaf, max |got - want| over the leaf's scale (its largest
    gradient magnitude, at least FLOOR of the largest over all leaves)."""
    top = max(float(np.abs(g).max()) for g in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), FLOOR * top)
            for k, w in want.items()}


def test_every_leaf_gradient_matches_jax(grads):
    want, got, _ = grads
    assert set(got) == set(want)
    rel = relative_errors(got, want)
    bad = [(k, r) for k, r in rel.items()
           if not r <= (BACKBONE_TOL if k.startswith(CHAOTIC) else TOL)]
    assert not bad, f"{len(bad)} leaves differ (key, relative error): {bad[:10]}"


def test_backbone_gradients_are_within_jax_own_noise(grads):
    """Why the backbone's leaves get BACKBONE_TOL: flipping the lowest bit
    of one input pixel moves JAX's own gradients of those leaves by about
    as much as the port's differ from JAX's (at most twice as much
    allowed), while the other leaves barely move."""
    want, got, flipped = grads
    rel_port, rel_self = relative_errors(got, want), relative_errors(flipped, want)
    port = max(r for k, r in rel_port.items() if k.startswith(CHAOTIC))
    jax_self = max(r for k, r in rel_self.items() if k.startswith(CHAOTIC))
    assert port < 2 * jax_self, (port, jax_self)
    assert max(r for k, r in rel_self.items() if not k.startswith(CHAOTIC)) < TOL


def test_box_heads_take_gradient_only_from_their_own_layer(grads):
    """What the stops decide, leaf by leaf: the shared box head and the
    two-stage box head get JAX's gradients, ``ca_box_gamma`` of every
    decoder layer gets one, and the CDN label encoder none."""
    want, got, _ = grads
    for key in ("params/bbox_embed/layers_2/kernel", "params/enc_out_bbox_embed/layers_2/kernel",
                "params/transformer/ref_point_head/layers_0/kernel"):
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        assert float(np.abs(got[key] - want[key]).max()) <= TOL * scale, key
    for i in range(TINY.dec_layers):
        g = got[f"params/transformer/decoder_layer_{i}/ca_box_gamma"]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, i
    assert not np.abs(got["params/label_enc"]).any()


def test_train_mode_changes_nothing():
    """At dropout 0 the forward in train mode equals the eval forward."""
    images, valid_hw = line_crops()
    params = trained_backbone_params()
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, params)
    vh = torch.from_numpy(valid_hw)
    x = prep_images(torch.from_numpy(images), vh)
    with torch.no_grad():
        ev = port.eval()(x, vh)
        tr = port.train()(x, vh)
    for (a, b), (c, d) in zip(outputs_list(ev), outputs_list(tr)):
        assert torch.equal(a, c) and torch.equal(b, d)
