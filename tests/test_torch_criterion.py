"""The port's detection loss (dtlr_tpu_torch/losses/criterion.py) against
dtlr_tpu/losses/criterion.py, and the detection recipe's settings
(dtlr_tpu_torch/train/config.py) against the JAX package's configs.

Seeded model outputs (final layer, two auxiliary layers, the two-stage
output and the denoising outputs of two groups with their auxiliary
layers) and padded targets go through both ``detection_loss``s, with
the auction and with the scipy matcher. Both match the same outputs to
the same queries (tests/test_torch_matcher.py holds the matchers
exactly), so every term, the DN and auxiliary ones included, and the
total agree to 1e-5 relative (float32 on both sides, summed in other
orders). ``build_weight_dict`` is identical to JAX's for Latin.py and
Latin_TPU.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.config import load_config
from dtlr_tpu.losses.criterion import build_weight_dict as jax_build_weight_dict
from dtlr_tpu.losses.criterion import detection_loss as jax_detection_loss
from dtlr_tpu.models.cdn import CdnMeta as JaxCdnMeta
from dtlr_tpu_torch.losses import criterion
from dtlr_tpu_torch.models.cdn import CdnMeta
from dtlr_tpu_torch.models.dino import FLAGSHIP
from dtlr_tpu_torch.ops import matcher
from dtlr_tpu_torch.train.config import RECIPE_DETECTION
from dtlr_tpu_torch.train.engine import detection_weight_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "dtlr_tpu", "configs")
REL = 1e-5
B, NQ, K, N, N_AUX, DN_NUMBER = 2, 30, 12, 6, 2, 12


def raw_outputs(seed):
    """numpy outputs: (logits, boxes) pairs of the final layer, N_AUX
    auxiliary layers, the two-stage output, and the DN prefix per layer."""
    rng = np.random.default_rng(seed)
    G = max(1, (2 * DN_NUMBER) // (2 * N))
    pad = G * 2 * N

    def pair(nq):
        logits = (rng.standard_normal((B, nq, K)) * 2 - 2).astype(np.float32)
        boxes = np.concatenate([rng.uniform(0.1, 0.9, (B, nq, 2)),
                                rng.uniform(0.02, 0.3, (B, nq, 2))], -1).astype(np.float32)
        return logits, boxes

    labels = rng.integers(0, K, (B, N)).astype(np.int32)
    tboxes = np.concatenate([rng.uniform(0.1, 0.9, (B, N, 2)),
                             rng.uniform(0.02, 0.3, (B, N, 2))], -1).astype(np.float32)
    valid = np.zeros((B, N), bool)
    valid[0, :] = True
    valid[1, :3] = True
    return {"main": [pair(NQ) for _ in range(N_AUX + 2)], "dn": [pair(pad) for _ in
                                                                  range(N_AUX + 1)],
            "G": G, "targets": (labels, tboxes, valid)}


def as_outputs(raw, to, meta_cls):
    """The dict both packages' models return, in ``to``'s arrays."""
    d = lambda lb: {"pred_logits": to(lb[0]), "pred_boxes": to(lb[1])}
    *layers, interm = raw["main"]
    *dn_aux, dn_last = raw["dn"]
    G = raw["G"]
    return {**d(layers[-1]), "aux_outputs": [d(p) for p in layers[:-1]],
            "interm_outputs": d(interm),
            "dn_outputs": {**d(dn_last), "aux_outputs": [d(p) for p in dn_aux]},
            "dn_meta": meta_cls(G * 2 * N, G, N)}


def weight_dict():
    cfg = load_config(os.path.join(CONFIGS, "Latin.py"))
    cfg.dec_layers = N_AUX + 1
    return jax_build_weight_dict(cfg)


@pytest.mark.parametrize("impl", ["jax", "scipy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_loss_matches_jax(impl, seed):
    raw = raw_outputs(seed)
    labels, tboxes, valid = raw["targets"]
    wd = weight_dict()
    jtotal, jlosses = jax_detection_loss(
        as_outputs(raw, jnp.asarray, JaxCdnMeta),
        {"labels": jnp.asarray(labels), "boxes": jnp.asarray(tboxes),
         "valid": jnp.asarray(valid)}, K, wd, matcher_impl=impl)
    matcher.reset_stats()
    total, losses = criterion.detection_loss(
        as_outputs(raw, torch.from_numpy, CdnMeta),
        {"labels": torch.from_numpy(labels), "boxes": torch.from_numpy(tboxes),
         "valid": torch.from_numpy(valid)}, K, wd, matcher_impl=impl)
    if impl == "jax":  # the 4 matched outputs in one auction
        assert matcher.auction_assign.stats["calls"] == 1
    assert set(losses) == set(jlosses)
    assert any(k.endswith("_dn_1") for k in losses) and "loss_giou_interm" in losses
    for k, want in jlosses.items():
        want = float(want)
        assert abs(float(losses[k]) - want) <= REL * max(abs(want), 1e-6), (k, float(losses[k]),
                                                                              want)
    assert abs(float(total) - float(jtotal)) <= REL * abs(float(jtotal))


def test_given_assignments_replace_the_matching():
    raw = raw_outputs(3)
    labels, tboxes, valid = (torch.from_numpy(a) for a in raw["targets"])
    outputs = as_outputs(raw, torch.from_numpy, CdnMeta)
    targets = {"labels": labels, "boxes": tboxes, "valid": valid}
    matched = [outputs] + outputs["aux_outputs"] + [outputs["interm_outputs"]]
    assign = matcher.match_outputs(matched, labels, tboxes, valid, impl="scipy")
    wd = weight_dict()
    a = criterion.detection_loss(outputs, targets, K, wd, matcher_impl="scipy")
    b = criterion.detection_loss(outputs, targets, K, wd, assignments=assign)
    assert torch.equal(a[0], b[0])


def test_losses_take_gradients_and_logging_terms_do_not():
    raw = raw_outputs(4)
    labels, tboxes, valid = (torch.from_numpy(a) for a in raw["targets"])
    outputs = as_outputs(raw, lambda a: torch.from_numpy(a).requires_grad_(), CdnMeta)
    total, losses = criterion.detection_loss(
        outputs, {"labels": labels, "boxes": tboxes, "valid": valid}, K, weight_dict())
    for k in ("loss_xy", "loss_hw", "cardinality_error", "loss_xy_dn_0"):
        assert not losses[k].requires_grad, k
    total.backward()
    for o in [outputs, outputs["dn_outputs"]] + outputs["aux_outputs"]:
        assert float(o["pred_logits"].grad.abs().max()) > 0
        assert float(o["pred_boxes"].grad.abs().max()) > 0


@pytest.mark.parametrize("config", ["Latin.py", "Latin_TPU.py"])
def test_build_weight_dict_matches_jax(config):
    cfg = load_config(os.path.join(CONFIGS, config))
    want = jax_build_weight_dict(cfg)
    assert criterion.build_weight_dict(cfg) == want
    assert list(criterion.build_weight_dict(cfg)) == list(want)


def test_detection_recipe_is_the_configs():
    """RECIPE_DETECTION and the model's CDN settings against Latin_TPU.py
    (on Latin.py) with the round-4 launcher's overrides, and its weight
    dict against JAX's."""
    cfg = load_config(os.path.join(CONFIGS, "Latin_TPU.py"))
    with open(os.path.join(REPO, "scripts", "round4_chain.sh")) as fh:
        chain = fh.read()
    overrides = dict(re.findall(r"\b(batch_size|warmup_steps|max_targets|lr_drop|use_ema|"
                                r"lr_backbone)=(\S+)", chain))
    r = RECIPE_DETECTION
    for k in ("lr", "weight_decay", "clip_max_norm", "ema_decay", "matcher_impl",
              "set_cost_class", "set_cost_bbox", "set_cost_giou", "cls_loss_coef",
              "bbox_loss_coef", "giou_loss_coef", "focal_alpha", "multi_step_lr", "onecyclelr"):
        assert getattr(r, k) == cfg[k], k
    assert list(r.lr_drop_list) == list(cfg.lr_drop_list)
    assert r.lr_backbone == cfg.lr_backbone == float(overrides["lr_backbone"])
    assert r.batch_size == int(overrides["batch_size"])
    assert r.warmup_steps == int(overrides["warmup_steps"])
    assert r.max_targets == int(overrides["max_targets"])
    assert r.lr_drop == int(overrides["lr_drop"])
    assert r.use_ema == (overrides["use_ema"] == "True")
    for k in ("use_dn", "dn_number", "dn_box_noise_scale", "dn_label_noise_ratio"):
        assert getattr(FLAGSHIP, k) == cfg[k], k
    cfg.dec_layers = FLAGSHIP.dec_layers
    assert detection_weight_dict(r, FLAGSHIP) == jax_build_weight_dict(cfg)
