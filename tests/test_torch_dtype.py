"""The port computing in bfloat16, the recipe's compute dtype, against
dtlr_tpu's ``build_dino_from_config`` with ``compute_dtype="bfloat16"``
at the tiny geometry (``TINY``), on the same weights and seeded lines.

Two kinds of check:
- dtypes: every module that both packages name alike returns the same
  dtype in both (bf16 out of each Dense and Conv, float32 out of each
  norm, of each encoder and decoder layer and of the heads' outputs).
  This is what holds the port to flax's ``dtype`` semantics: values
  cannot, because two bf16 computations that round at the same places
  still round a few values differently and drift apart by a few bf16
  steps.
- values: the backbone's features, the encoder memory, and the final,
  auxiliary and two-stage logits and boxes. The full-depth ResNet-50
  and the 1x2 last level (a GroupNorm over 2 values) turn bf16 rounding
  into large differences at 64x128, and the two-stage top-k on bf16
  scores then picks other proposals, so past the backbone both packages
  are fed JAX's projected levels and JAX's selection. Tolerances, as
  fractions of each tensor's scale (its largest magnitude, at least 1):
  5e-2 for features, memory and logits (measured 3.0e-2, 1.6e-2 and
  1.9e-2: a few bf16 steps of 2^-8), and 1e-2 absolute on the sigmoided
  boxes (measured 4.0e-3).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dtlr_tpu.config import load_config
from dtlr_tpu.models.dino import build_dino_from_config
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models import transformer as port_transformer
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.weights import load_into
from test_torch_model import (NUM_CLASSES, TINY, assert_close, jax_tiny, make_lines,
                              perturbed_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CFG = os.path.join(REPO, "outputs", "finetune_r4b", "config_cfg.py")
TOL, BOX_TOL = 5e-2, 1e-2
BF16 = dataclasses.replace(TINY, compute_dtype="bfloat16")


def jax_recipe(flash: bool):
    """The flagship recipe's dumped config at TINY's geometry, bf16."""
    cfg = load_config(FLAGSHIP_CFG)
    for name, value in dict(num_queries=TINY.num_queries, hidden_dim=TINY.hidden_dim,
                            nheads=TINY.nheads, enc_layers=TINY.enc_layers,
                            dec_layers=TINY.dec_layers, dim_feedforward=TINY.dim_feedforward,
                            encoder_win=TINY.encoder_win, num_classes=NUM_CLASSES,
                            dn_labelbook_size=NUM_CLASSES + 1, compute_dtype="bfloat16",
                            flash_attn=flash).items():
        setattr(cfg, name, value)
    return build_dino_from_config(cfg)


@pytest.fixture(scope="module")
def setup():
    images, valid_hw = make_lines()
    params = perturbed_params(jax_tiny(False), images, valid_hw)
    port = build_dino(BF16, NUM_CLASSES, device="cpu")
    load_into(port, params)
    return images, valid_hw, params, port


def _jax_apply(model, params, images, valid_hw, names=None):
    """Outputs and captured module outputs {dotted name: first call's output}."""
    keep = (lambda mdl, _: True) if names is None else (lambda mdl, _: mdl.name in names)
    out, state = jax.jit(lambda p, im, vh: model.apply(
        p, jax_prep_images(im, vh), vh, None, train=False, capture_intermediates=keep,
        mutable=["intermediates"]))(params, images, valid_hw)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "__call__":
                flat[prefix] = v[0]
            elif isinstance(v, dict):
                walk(v, f"{prefix}.{k}" if prefix else k)

    walk(state["intermediates"], "")
    return out, flat


def _first_tensor(x):
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def test_intermediate_dtypes_match_jax(setup):
    images, valid_hw, params, port = setup
    _, jax_mods = _jax_apply(jax_recipe(False), params, images, valid_hw)
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, _first_tensor(output).dtype)
        return hook

    hooks = [mod.register_forward_hook(record(name))
             for name, mod in port.named_modules() if name]
    try:
        vh = torch.from_numpy(valid_hw)
        with torch.no_grad():
            out = port(prep_images(torch.from_numpy(images), vh), vh)
    finally:
        for h in hooks:
            h.remove()
    common = sorted(set(seen) & set(jax_mods))
    # every Dense, Conv and norm of the path, the layers, the backbone
    assert len(common) >= 150, len(common)
    bad = [(n, str(seen[n]), str(_first_tensor(jax_mods[n]).dtype)) for n in common
           if str(seen[n]).split(".")[1] != str(_first_tensor(jax_mods[n]).dtype)]
    assert not bad, bad
    kinds = {str(seen[n]) for n in common}
    assert kinds == {"torch.bfloat16", "torch.float32"}
    assert seen["transformer.encoder_layer_1"] == torch.float32  # the memory
    assert out["pred_logits"].dtype == out["pred_boxes"].dtype == torch.float32


@pytest.mark.parametrize("flash", [False, True], ids=["materialized", "pallas_interpret"])
def test_forward_bf16_matches_jax(setup, flash, monkeypatch):
    images, valid_hw, params, port = setup
    n_enc = TINY.enc_layers
    names = {f"input_proj_{i}_norm" for i in range(4)} | {f"encoder_layer_{n_enc - 1}",
                                                          "backbone_net"}
    jout, jmods = _jax_apply(jax_recipe(flash), params, images, valid_hw, names)
    jsrcs = [torch.from_numpy(np.array(jmods[f"input_proj_{i}_norm"])) for i in range(4)]
    jsel = np.asarray(jout["interm_outputs_for_matching_pre"]["pred_boxes"])

    seen = {}
    levels = port.levels

    def levels_with_jax_srcs(im, vh):
        feats = port.backbone_net(im.permute(0, 3, 1, 2))
        seen["feats"] = [f.permute(0, 2, 3, 1) for f in feats]
        _, masks, poss = levels(im, vh)
        assert all(a.shape == b.shape for a, b in zip(_, jsrcs))
        return jsrcs, masks, poss

    proposals = port_transformer.gen_encoder_output_proposals

    def recording_proposals(memory, mask, shapes):
        seen["memory"] = memory
        out = proposals(memory, mask, shapes)
        seen["anchors"] = out[1].sigmoid().numpy()
        return out

    def jax_selection(scores, k):
        """JAX's picks, found by their anchors among this run's proposals."""
        a = seen["anchors"]
        return torch.tensor([[int(np.abs(a[b] - box).max(-1).argmin()) for box in jsel[b]]
                             for b in range(len(jsel))])

    monkeypatch.setattr(port, "levels", levels_with_jax_srcs)
    monkeypatch.setattr(port_transformer, "gen_encoder_output_proposals", recording_proposals)
    monkeypatch.setattr(port_transformer, "top_k_stable", jax_selection)
    vh = torch.from_numpy(valid_hw)
    with torch.no_grad():
        pout = port(prep_images(torch.from_numpy(images), vh), vh)

    for f, jf in zip(seen["feats"], jmods["backbone_net"]):
        assert f.dtype == torch.float32 and jf.dtype == np.float32
        assert_close(f.numpy(), jf, "backbone feature", tol=TOL)
    jmem = jmods[f"transformer.encoder_layer_{n_enc - 1}"]
    assert seen["memory"].dtype == torch.float32 and jmem.dtype == np.float32
    assert_close(seen["memory"].numpy(), jmem, "encoder memory", tol=TOL)
    np.testing.assert_allclose(
        pout["interm_outputs_for_matching_pre"]["pred_boxes"].numpy(), jsel, atol=1e-6)
    pairs = [("final", jout, pout), ("interm", jout["interm_outputs"], pout["interm_outputs"])]
    pairs += [(f"aux{i}", j, p) for i, (j, p) in
              enumerate(zip(jout["aux_outputs"], pout["aux_outputs"]))]
    for name, j, p in pairs:
        assert p["pred_logits"].dtype == p["pred_boxes"].dtype == torch.float32
        assert_close(p["pred_logits"].numpy(), j["pred_logits"], f"{name} logits", tol=TOL)
        np.testing.assert_allclose(p["pred_boxes"].numpy(), np.asarray(j["pred_boxes"]),
                                   rtol=0, atol=BOX_TOL, err_msg=f"{name} boxes")
