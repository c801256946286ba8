"""The port's detection training step (dtlr_tpu_torch/train/train_step.py
``make_detection_train_step``) against dtlr_tpu's at the tiny geometry
(``TINY`` of test_torch_model.py with contrastive denoising on).

Both sides use the weights and lines of test_torch_grad_stops.py (the
flagship's trained ResNet-50, the flax init with seeded noise
elsewhere; 128x256 crops of the fixture lines) with seeded targets, the
CDN noise set to zero (``dn_label_noise_ratio = dn_box_noise_scale =
0``: the denoising queries are then the targets themselves in both
frameworks, while the DN prefix, its mask and every DN loss term still
run; two groups, so the prefix holds 24 queries before the 24 matching
ones), and the exact Hungarian matcher (``matcher_impl="scipy"``) on
both sides, so that both match the same queries. JAX's scipy matcher is
a ``pure_callback``, which ``jax.grad`` refuses to differentiate
through even though its integer result carries no gradient; the JAX
side here stops the gradient at the matcher's inputs (``jax_loss_fn``),
which changes no value and no gradient.

Held, float32 on both sides:
- the forward with its denoising outputs, 1e-4 of each tensor's scale
  (test_torch_model.py's tolerance);
- the loss and its terms, 1e-5 relative;
- every leaf's gradient against ``jax.grad`` of JAX's loss, at
  test_torch_grad_stops.py's tolerances (2e-3 of the leaf's scale, 5e-2
  for the backbone and the input projections' convolutions); the label
  encoder's gradient is non-zero exactly in the rows of the targets'
  labels;
- the parameters and EMA after two steps against
  ``make_detection_train_step``, at test_torch_train_step.py's 1e-6, with
  the detection recipe's optimizer (clip 0.1, weight decay 1e-4, EMA
  0.9997) at that file's learning rates (lr 1e-5, backbone 1e-10) and no
  warmup (the recipe's 200 warmup steps start from a learning rate of 0);
  the input projections' convolutions, whose gradients are amplified
  float noise, within twice what one bit of one input value moves JAX's
  own two steps by;
- the masked self-attention on the CPU (``query_group``) against JAX's
  materialized masked path (``attn_mask``, dtlr_tpu/models/layers.py:184-195),
  1e-5 of scale.
The read path (no targets, or not training) is bit for bit the forward
without CDN.
"""

import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtlr_tpu.losses.criterion as jax_criterion
from dtlr_tpu.models.cdn import CdnMeta as JaxCdnMeta
from dtlr_tpu.models.cdn import cdn_attn_mask as jax_cdn_attn_mask
from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.models.layers import MultiHeadAttention as JaxMHA
from dtlr_tpu.train import optim as jax_optim
from dtlr_tpu.train.train_step import init_train_state as jax_init_train_state
from dtlr_tpu.train.train_step import make_detection_train_step as jax_make_step
from dtlr_tpu_torch.models.cdn import CdnMeta, cdn_query_groups
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.models.layers import MultiHeadAttention
from dtlr_tpu_torch.train import optim
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.train.config import RECIPE_DETECTION
from dtlr_tpu_torch.train.engine import detection_weight_dict
from dtlr_tpu_torch.train.train_step import init_train_state, make_detection_train_step
from dtlr_tpu_torch.weights import load_into
from test_torch_grad_stops import (BACKBONE_TOL, CHAOTIC, TOL, flat, relative_errors,
                                   trained_backbone_params)
from test_torch_model import NUM_CLASSES, TINY, assert_close
from test_torch_optim import JaxCfg
from test_torch_train_step import PARAM_TOL, batches as ctc_batches

N_TARGETS, DN_NUMBER = 6, 12
DN = dataclasses.replace(TINY, use_dn=True, dn_number=DN_NUMBER, dn_box_noise_scale=0.0,
                         dn_label_noise_ratio=0.0)
CFG = dataclasses.replace(RECIPE_DETECTION, lr=1e-5, lr_backbone=1e-10, warmup_steps=0,
                          matcher_impl="scipy", max_targets=N_TARGETS)
WEIGHTS = detection_weight_dict(CFG, DN)
LOSS_REL, MHA_TOL = 1e-5, 1e-5


def jax_dn_model() -> JaxDINO:
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=DN.num_queries, hidden_dim=DN.hidden_dim,
        n_heads=DN.nheads, num_encoder_layers=DN.enc_layers, num_decoder_layers=DN.dec_layers,
        d_ffn=DN.dim_feedforward, num_feature_levels=4, use_dn=True, dn_number=DN_NUMBER,
        dn_box_noise_scale=0.0, dn_label_noise_ratio=0.0, dn_labelbook_size=NUM_CLASSES + 1,
        max_targets=N_TARGETS, norm_kind="group", encoder_type="windowed",
        encoder_win=DN.encoder_win, decoder_ca="dense", dense_box_bias=True, flash_attn=False,
        dtype=jnp.float32)


def batches(n=2, seed=10):
    """test_torch_train_step.py's crops (host-normalized) with seeded
    character boxes inside each line's valid area, cxcywh in [0, 1]."""
    out = []
    for i, b in enumerate(ctc_batches(n, seed)):
        rng = np.random.default_rng(seed + 100 + i)
        labels = rng.integers(0, NUM_CLASSES, (2, N_TARGETS)).astype(np.int32)
        frac = b["valid_hw"][:, None, ::-1] / np.asarray([256.0, 128.0])  # (w, h) fractions
        cx = rng.uniform(0.1, 0.9, (2, N_TARGETS)) * frac[:, :, 0]
        cy = rng.uniform(0.3, 0.7, (2, N_TARGETS)) * frac[:, :, 1]
        w = rng.uniform(0.02, 0.1, (2, N_TARGETS))
        h = rng.uniform(0.2, 0.5, (2, N_TARGETS))
        boxes = np.stack([cx, cy, w, h], -1).astype(np.float32)
        out.append({**b, "labels": labels, "boxes": boxes})
    return out


@contextmanager
def jax_matcher_without_gradient():
    """JAX's ``detection_loss`` with the gradient stopped at the matcher's
    inputs: the scipy matcher's ``pure_callback`` has no JVP rule."""
    match = jax_criterion.hungarian_match

    def stopped(logits, boxes, *args, **kw):
        return match(jax.lax.stop_gradient(logits), jax.lax.stop_gradient(boxes), *args, **kw)

    jax_criterion.hungarian_match = stopped
    try:
        yield
    finally:
        jax_criterion.hungarian_match = match


def jax_loss_fn(model):
    """make_detection_train_step's loss_fn (dtlr_tpu/train/train_step.py:65-81)."""

    def loss_fn(params, batch):
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        key = jax.random.PRNGKey(0)
        out = model.apply(params, batch["images"], batch["valid_hw"], targets, train=True,
                          rngs={"dn": key, "dropout": jax.random.fold_in(key, 1)})
        return jax_criterion.detection_loss(out, targets, NUM_CLASSES, WEIGHTS,
                                            matcher_impl="scipy")

    return loss_fn


def port_model(params):
    model = build_dino(DN, NUM_CLASSES, device="cpu")
    load_into(model, params)
    return model


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    return trained_backbone_params()


@pytest.fixture(scope="module")
def first_step(setup):
    """JAX's loss, terms and gradients of the first batch, and the
    port's."""
    b = batches(1)[0]
    with jax_matcher_without_gradient():
        (jtotal, jterms), jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jax_dn_model()),
                                                              has_aux=True))(setup, b)
    model = port_model(setup)
    model.train()
    step = make_detection_train_step(NUM_CLASSES, WEIGHTS, matcher_impl="scipy")
    total, terms = step.loss_fn(model, to_torch(b))
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return ((float(jtotal), {k: float(v) for k, v in jterms.items()}, flat(jgrads)),
            (float(total.detach()), {k: float(v.detach()) for k, v in terms.items()},
             params_to_flax(grads)), b)


def test_forward_with_denoising_matches_jax(setup):
    b = batches(1)[0]
    targets = {k: b[k] for k in ("labels", "boxes", "valid")}
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda p, b, t: jax_dn_model().apply(
        p, b["images"], b["valid_hw"], t, train=True, rngs={"dn": key, "dropout": key}))(
        setup, b, targets)
    t = to_torch(b)
    with torch.no_grad():
        got = port_model(setup)(t["images"], t["valid_hw"],
                                {k: t[k] for k in ("labels", "boxes", "valid")}, train=True)
    assert tuple(got["dn_meta"]) == tuple(want["dn_meta"]) == (24, 2, N_TARGETS)
    pairs = [(got, want), (got["dn_outputs"], want["dn_outputs"])]
    pairs += list(zip(got["aux_outputs"], want["aux_outputs"]))
    pairs += list(zip(got["dn_outputs"]["aux_outputs"], want["dn_outputs"]["aux_outputs"]))
    pairs += [(got["interm_outputs"], want["interm_outputs"])]
    for i, (g, w) in enumerate(pairs):
        for k in ("pred_logits", "pred_boxes"):
            assert_close(g[k].numpy(), np.asarray(w[k]), f"{i} {k}")


def test_loss_terms_match_jax(first_step):
    (jtotal, jterms, _), (total, terms, _), _ = first_step
    assert set(terms) == set(jterms)
    assert {"loss_ce_dn", "loss_bbox_dn_0", "loss_giou_interm", "loss_ce_0"} <= set(terms)
    for k, want in jterms.items():
        assert abs(terms[k] - want) <= LOSS_REL * max(abs(want), 1e-6), (k, terms[k], want)
    assert abs(total - jtotal) <= LOSS_REL * abs(jtotal)


def test_every_leaf_gradient_matches_jax(first_step):
    (_, _, want), (_, _, got), b = first_step
    assert set(got) == set(want)
    rel = relative_errors(got, want)
    bad = [(k, r) for k, r in rel.items()
           if not r <= (BACKBONE_TOL if k.startswith(CHAOTIC) else TOL)]
    assert not bad, f"{len(bad)} leaves differ (key, relative error): {bad[:10]}"
    # the label encoder learns in the rows of the targets' labels, and only there
    rows = np.flatnonzero(np.abs(got["params/label_enc"]).sum(-1) > 0)
    assert set(rows) == set(b["labels"][b["valid"]].tolist())
    for i in range(DN.dec_layers):
        assert np.abs(got[f"params/transformer/decoder_layer_{i}/ca_box_gamma"]).max() > 0


def jax_two_steps(setup, steps):
    tx = jax_optim.build_optimizer(JaxCfg(CFG), setup)
    jstep = jax_make_step(jax_dn_model().apply, tx, NUM_CLASSES, WEIGHTS, matcher_impl="scipy",
                          ema_decay=CFG.ema_decay)
    jstate = jax_init_train_state(setup, tx, use_ema=True)
    jmetrics = []
    with jax_matcher_without_gradient():
        for b in steps:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.PRNGKey(0))
            jmetrics.append({k: float(v) for k, v in m.items()})
    return jstate, jmetrics


def test_two_steps_match_jax(setup):
    """Every parameter and EMA leaf within PARAM_TOL of JAX's after two
    steps, but the backbone's and the input projections' convolutions
    (CHAOTIC, whose gradients are float noise amplified, see
    test_torch_grad_stops.py): those within twice what the lowest bit of
    one input value moves JAX's own two steps by (measured: the port's
    1.19e-6 on input_proj_0_conv's bias, JAX's own 1.02e-6)."""
    steps = batches()
    jstate, jmetrics = jax_two_steps(setup, steps)
    flipped = [dict(b) for b in steps]
    image = flipped[0]["images"].copy()
    image[0, 10, 10, 0] = np.nextafter(image[0, 10, 10, 0], np.float32(10))
    flipped[0]["images"] = image
    jnoise, _ = jax_two_steps(setup, flipped)
    model = port_model(setup)
    state = init_train_state(model, optim.build_optimizer(CFG, dict(model.named_parameters())),
                             use_ema=True)
    step = make_detection_train_step(NUM_CLASSES, WEIGHTS, matcher_impl="scipy",
                                     ema_decay=CFG.ema_decay)
    for b, jm in zip(steps, jmetrics):
        state, m = step(state, to_torch(b))
        assert float(m["skipped"]) == jm["skipped"] == 0.0
        assert set(jm) <= set(m)
        for k in ("loss", "loss_ce", "loss_bbox_dn", "loss_giou_interm"):
            assert abs(float(m[k]) - jm[k]) <= LOSS_REL * abs(jm[k]), (k, float(m[k]), jm[k])
    start = flat(setup)
    for want, noise, got in ((flat(jstate.params), flat(jnoise.params),
                              params_to_flax(dict(model.named_parameters()))),
                             (flat(jstate.ema_params), flat(jnoise.ema_params),
                              params_to_flax(state.ema))):
        assert set(got) == set(want)
        moved = [k for k in want if np.abs(want[k] - start[k]).max() > 10 * PARAM_TOL]
        assert len(moved) > len(want) // 3, len(moved)
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        chaotic_noise = max(float(np.abs(noise[k] - want[k]).max()) for k in want
                            if k.startswith(CHAOTIC))
        bad = [(k, e) for k, e in err.items()
               if not e <= (max(PARAM_TOL, 2 * chaotic_noise) if k.startswith(CHAOTIC)
                            else PARAM_TOL)]
        assert not bad, (bad[:10], chaotic_noise)
    assert state.step == int(jstate.step) == 2 and state.optimizer.state["count"] == 2


def test_step_marks_its_phases_in_order(setup):
    """``mark`` is called once as each phase ends, in the step's order,
    and changes nothing: the step with it equals the step without."""
    phases, results = [], []
    for mark in (phases.append, None):
        model = port_model(setup)
        state = init_train_state(model, optim.build_optimizer(
            CFG, dict(model.named_parameters())), use_ema=True)
        step = make_detection_train_step(NUM_CLASSES, WEIGHTS, matcher_impl="scipy",
                                         ema_decay=CFG.ema_decay)
        state, m = step(state, to_torch(batches(1)[0]), mark=mark)
        results.append((m, params_to_flax(dict(model.named_parameters()))))
    assert phases == ["forward", "matching", "loss", "backward", "update"]
    (m1, p1), (m2, p2) = results
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)


@pytest.mark.parametrize("dn_number,n_max,nq", [(12, 6, 24), (100, 64, 30)])
def test_masked_self_attention_matches_jax(dn_number, n_max, nq):
    """The decoder's self-attention with the CDN mask: the port's plain
    path with ``query_group`` against JAX's materialized path with the
    (Q, Q) ``attn_mask``, the same weights."""
    C, M, B = 32, 4, 2
    G = max(1, (2 * dn_number) // (2 * n_max))
    pad = G * 2 * n_max
    Q = pad + nq
    rng = np.random.default_rng(n_max)
    q = rng.standard_normal((B, Q, C)).astype(np.float32)
    v = rng.standard_normal((B, Q, C)).astype(np.float32)
    jmha = JaxMHA(C, M, dtype=jnp.float32)
    params = jmha.init(jax.random.PRNGKey(1), q, q, v)
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(
        np.float32), params)
    mask = jax_cdn_attn_mask(nq, JaxCdnMeta(pad, G, n_max))
    want = np.asarray(jmha.apply(params, q, q, v, mask))
    port = MultiHeadAttention(C, M)
    load_into(port, params["params"])
    groups = cdn_query_groups(nq, CdnMeta(pad, G, n_max))
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v),
                   query_group=groups).numpy()
    assert_close(got, want, "masked self-attention", MHA_TOL)
    unmasked = np.asarray(jmha.apply(params, q, q, v))
    assert np.abs(unmasked - want).max() > 100 * MHA_TOL  # the mask matters here


def test_read_path_is_unchanged(setup):
    """Without targets, or outside training, or with CDN off, the forward
    is the one without denoising queries, bit for bit."""
    b = to_torch(batches(1)[0])
    targets = {k: b[k] for k in ("labels", "boxes", "valid")}
    model = port_model(setup)
    no_dn = build_dino(dataclasses.replace(DN, use_dn=False), NUM_CLASSES, device="cpu")
    load_into(no_dn, setup)
    with torch.no_grad():
        read = model(b["images"], b["valid_hw"])
        runs = [model(b["images"], b["valid_hw"], targets, train=False),
                model(b["images"], b["valid_hw"], None, train=True),
                no_dn(b["images"], b["valid_hw"], targets, train=True)]
    assert "dn_outputs" not in read
    for out in runs:
        assert set(out) == set(read)
        for k in ("pred_logits", "pred_boxes"):
            assert torch.equal(out[k], read[k])
            for a, c in zip(out["aux_outputs"], read["aux_outputs"]):
                assert torch.equal(a[k], c[k])
            assert torch.equal(out["interm_outputs"][k], read["interm_outputs"][k])
