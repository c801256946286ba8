"""The Swin and ConvNeXt backbones (dtlr_tpu_torch/models/swin.py,
convnext.py) against the JAX package's (dtlr_tpu/models/swin.py,
convnext.py), on the CPU in float32.

- Swin-T's and ConvNeXt-tiny's three features on 64x96 inputs, one
  seeded tree in both, at 1e-4 of their scale (measured: under 1e-5).
- DINO at TINY widths with a (minimal) Swin and a ConvNeXt backbone
  against JAX's DINO on lines whose width the strides do not divide, the
  port's fresh tree perturbed from a numpy seed carried across: the
  backbone's features and every output at 1e-4; the minimal backbones'
  trees in JAX's names and shapes.
- The port's fresh draws against JAX's init of a Swin window attention
  and a ConvNeXt block (names, shapes, families, constants exactly,
  random leaves within sampling bounds; the position bias table flax's
  truncated_normal(0.02), the layer scale 1e-6).
- ``same_pad`` against lax's 'SAME' convolution.
- The strides and channels of all eight variants, from shapes only (the
  port's models on the meta device, JAX's builders' channels), as
  tests/test_backbones.py checks JAX's.
- ``check_architecture`` takes the eight names and refuses an unknown one.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dtlr_tpu.models.convnext import CONVNEXT_CONFIGS as JAX_CONVNEXT
from dtlr_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from dtlr_tpu.models.convnext import ConvNeXtBlock as JaxConvNeXtBlock
from dtlr_tpu.models.convnext import build_convnext as jax_convnext
from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.models.swin import SWIN_CONFIGS as JAX_SWIN
from dtlr_tpu.models.swin import SwinTransformer as JaxSwin
from dtlr_tpu.models.swin import WindowAttention as JaxWindowAttention
from dtlr_tpu.models.swin import build_swin as jax_swin
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu.train.checkpoints import _flatten as jax_flatten
from dtlr_tpu_torch.config import loader as TL
from dtlr_tpu_torch.models.convnext import (CONVNEXT_CONFIGS, LAYER_SCALE, ConvNeXt,
                                            ConvNeXtBlock, build_convnext)
from dtlr_tpu_torch.models.dino import DINO, build_dino
from dtlr_tpu_torch.models.swin import (SWIN_CONFIGS, SwinTransformer, WindowAttention,
                                        build_swin, same_pad)
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.train import config as TC
from dtlr_tpu_torch.train.checkpoints import _flax_leaf, params_to_flax
from dtlr_tpu_torch.train.init import (BIAS_TABLE_STD, TRUNCATED_STD, draw, family,
                                       init_params)
from dtlr_tpu_torch.weights import load_into
from test_torch_deform_fixture import nested
from test_torch_init import SIGMAS, check_families, check_names_and_shapes, check_random_leaves
from test_torch_model import NUM_CLASSES, TINY, _pairs, assert_close, run_port

BACKBONES = ("swin_T_224_1k", "convnext_tiny")
ALL = tuple(SWIN_CONFIGS) + tuple(CONVNEXT_CONFIGS)
JAX_BUILD = {"swin_T_224_1k": jax_swin, "convnext_tiny": jax_convnext}


def perturb(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.05, x.shape).astype(np.float32),
        params)


def seeded_tree(module: torch.nn.Module, seed: int = 1, n_heads=None) -> dict:
    """A flat flax tree in ``module``'s names and flax layouts with no leaf
    zero: kernels normal(0, 1 / sqrt(fan_in)), norm scales 1 + normal(0,
    0.1), biases normal(0, 0.1), the rest (Swin's position bias tables,
    ConvNeXt's layer scales) normal(0, 0.5)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in module.named_parameters():
        key, x = _flax_leaf(name, np.zeros(tuple(p.shape), np.float32), n_heads)
        leaf = key.rsplit("/", 1)[-1]
        z = rng.standard_normal(x.shape, dtype=np.float32)
        if leaf == "kernel":
            tree[key] = z / np.float32(math.sqrt(int(np.prod(x.shape[:-1]))))
        elif leaf == "scale":
            tree[key] = 1 + np.float32(0.1) * z
        else:
            tree[key] = np.float32(0.1 if leaf == "bias" else 0.5) * z
    return tree


def compare_features(got, want, what):
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        assert_close(g, w, f"{what} feature {i}")


def features_against_jax(model, port, x, what):
    """JAX's module and the port's, with one seeded tree in both, on ``x``."""
    tree = seeded_tree(port)
    want = jax.jit(model.apply)(nested(tree), jnp.asarray(x))
    load_into(port, tree)
    with torch.no_grad():
        compare_features(port(torch.from_numpy(x).permute(0, 3, 1, 2)), want, what)


@pytest.mark.parametrize("name", BACKBONES)
def test_features_match_jax(name):
    """Swin-T's and ConvNeXt-tiny's three features on two 64x96 inputs."""
    model, chans = JAX_BUILD[name](name)
    port = (build_swin if name.startswith("swin") else build_convnext)(name)
    assert port.num_channels == chans
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    features_against_jax(model, port, x, name)


#: the smallest backbones with every kind of leaf: Swin's first stage has
#: a shifted block
MINIMAL = {"swin": dict(embed_dim=8, depths=(2, 1, 1, 1), num_heads=(1, 1, 2, 2)),
           "convnext": dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))}
JAX_MODULE = {"swin": JaxSwin, "convnext": JaxConvNeXt}
PORT_MODULE = {"swin": SwinTransformer, "convnext": ConvNeXt}


@pytest.mark.parametrize("kind", ["swin", "convnext"])
def test_tree_names_and_shapes_are_jax_s(kind):
    """The port's parameter tree of a whole (minimal) backbone in flax
    names and layouts is JAX's init's, by ``eval_shape`` (traced, not
    run): no leaf missing, none extra."""
    model = JAX_MODULE[kind](**MINIMAL[kind])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 45, 77, 3)))
    want = {"params/" + k: tuple(v.shape)
            for k, v in flatten_dict(shapes["params"], sep="/").items()}
    got = {k: v.shape for k, v in seeded_tree(PORT_MODULE[kind](**MINIMAL[kind])).items()}
    assert got == want


@pytest.mark.parametrize("kind", ["swin", "convnext"])
def test_init_families_match_jax(kind):
    """The port's fresh draws (train/init.py's ``family`` and ``draw``, by
    the parameters' names in DINO) against JAX's init of one Swin window
    attention or one ConvNeXt block: names, shapes, families, constants
    exactly, random leaves within sampling bounds; Swin's position bias
    table flax's truncated_normal(0.02), ConvNeXt's layer scale 1e-6."""
    if kind == "swin":
        jm, x = JaxWindowAttention(dim=64, num_heads=4, window_size=7), jnp.zeros((2, 49, 64))
        port, prefix = WindowAttention(64, 4, 7), "backbone_net.stage0_block0.attn."
    else:
        jm, x = JaxConvNeXtBlock(dim=64), jnp.zeros((1, 8, 8, 64))
        port, prefix = ConvNeXtBlock(64), "backbone_net.stage0_block0."
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    flax_prefix = "params/" + prefix.replace(".", "/")
    want = {flax_prefix + k: np.asarray(v, np.float32)
            for k, v in jax_flatten(jax.tree.map(np.asarray, jparams["params"])).items()}
    gen = torch.Generator().manual_seed(0)
    got = params_to_flax({prefix + n: draw(prefix + n, tuple(p.shape), gen, TINY)
                          for n, p in port.named_parameters()})
    check_names_and_shapes(want, got)
    new = [k for k in want if k.endswith(("relative_position_bias_table", "/gamma"))]
    assert len(new) == 1
    old = {k: v for k, v in want.items() if k not in new}
    assert check_families(old, got) == ({"zero", "lecun"} if kind == "swin"
                                        else {"one", "zero", "lecun"})
    assert check_random_leaves(old, got) == 2 if kind == "swin" else 3
    k = new[0]
    w, g = want[k], got[k]
    if kind == "convnext":
        assert family(prefix + "gamma", 1) == "layer_scale"
        assert np.array_equal(g, np.full_like(w, LAYER_SCALE))
        assert np.array_equal(w, np.full_like(w, LAYER_SCALE))
        return
    assert family(prefix + "relative_position_bias_table", 2) == "table"
    # flax's truncated_normal(0.02): a unit normal cut at +-2, times 0.02
    bound = 2 * BIAS_TABLE_STD * (1 + 1e-6)
    assert np.abs(g).max() <= bound and np.abs(w).max() <= bound
    s, n = BIAS_TABLE_STD * TRUNCATED_STD, w.size
    for v in (g, w):
        assert abs(v.std() - s) <= SIGMAS * s * math.sqrt(1.0 / n)
    assert abs(g.mean() - w.mean()) <= SIGMAS * s * math.sqrt(2.0 / n)


def test_same_pad_is_xla_s():
    """``same_pad`` then a VALID convolution is lax's 'SAME' one."""
    rng = np.random.default_rng(3)
    for h, w, k, s in ((70, 100, 4, 4), (65, 33, 4, 4), (7, 9, 2, 2), (16, 16, 4, 4)):
        x = rng.normal(size=(1, h, w, 2)).astype(np.float32)
        ker = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
        want = jax.lax.conv_general_dilated(x, ker, (s, s), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        got = torch.nn.functional.conv2d(same_pad(torch.from_numpy(x).permute(0, 3, 1, 2), k, s),
                                         torch.from_numpy(ker).permute(3, 2, 0, 1), stride=s)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ALL)
def test_strides_and_channels(name):
    """Shapes only, the port's model on the meta device: strides 8, 16 and
    32, and the channels of JAX's builder (its module is not run)."""
    if name in SWIN_CONFIGS:
        assert SWIN_CONFIGS[name] == JAX_SWIN[name]
        _, chans = jax_swin(name)
        port = build_swin
    else:
        assert CONVNEXT_CONFIGS[name] == JAX_CONVNEXT[name]
        _, chans = jax_convnext(name)
        port = build_convnext
    with torch.device("meta"):
        model = port(name)
        got = model(torch.zeros(1, 3, 64, 96))
    assert model.num_channels == chans
    assert len(got) == 3
    for g, s, c in zip(got, (8, 16, 32), chans):
        assert tuple(g.shape) == (1, c, 64 // s, 96 // s), g.shape


def jax_dino(backbone: str) -> JaxDINO:
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=TINY.num_queries,
        hidden_dim=TINY.hidden_dim, n_heads=TINY.nheads,
        num_encoder_layers=TINY.enc_layers, num_decoder_layers=TINY.dec_layers,
        d_ffn=TINY.dim_feedforward, num_feature_levels=4, use_dn=False,
        dn_labelbook_size=NUM_CLASSES + 1, backbone=backbone,
        encoder_type="windowed", encoder_win=TINY.encoder_win,
        decoder_ca="dense", dense_box_bias=True, dtype=jnp.float32)


@pytest.mark.parametrize("kind", ["swin", "convnext"])
def test_dino_with_backbone_matches_jax(kind, monkeypatch):
    """DINO at TINY widths (one encoder layer) with a Swin and with a
    ConvNeXt backbone (the minimal ones, registered in both packages'
    tables under a name of their family) against JAX's DINO, with the
    port's fresh TINY tree (train/init.py) perturbed from a numpy seed
    (ConvNeXt's layer scale and the zero leaves then hide no path): the
    backbone's features (JAX's captured inside its DINO's forward) and
    every output, at 1e-4 of their scale. Two 128x198 lines (one cut to
    100x141): a width that the strides do not divide (XLA's 'SAME'
    padding of the stems and of ConvNeXt's downsamplings, 50 -> 25 -> 13
    -> 7 columns), Swin's padding of the 32x50 patch grid to window
    multiples with the shifted-window mask on the padded size, its odd
    patch merges. Not 64x96: its last level is 1x2 cells, where the input
    projection's GroupNorm (one channel a group at TINY's width 32)
    normalizes two values and lifts float32 noise to 3e-2 in the
    encoder's proposals (measured with ConvNeXt-tiny;
    test_torch_deform_model.py met the same with FrozenBN)."""
    name = f"{kind}_minimal"
    for table in ((JAX_SWIN, SWIN_CONFIGS) if kind == "swin"
                  else (JAX_CONVNEXT, CONVNEXT_CONFIGS)):
        monkeypatch.setitem(table, name, MINIMAL[kind])
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 128, 198, 3), dtype=np.uint8)
    valid_hw = np.asarray([[128, 198], [100, 141]], np.int32)
    cfg = dataclasses.replace(TINY, backbone=name, dn_labelbook_size=NUM_CLASSES + 1,
                              enc_layers=1)
    tree = perturb(init_params(cfg, NUM_CLASSES, torch.Generator().manual_seed(0)))
    jm = jax_dino(name).clone(num_encoder_layers=1)
    is_backbone = lambda mdl, _: isinstance(mdl, (JaxSwin, JaxConvNeXt))
    jout, state = jax.jit(lambda p, im, vh: jm.apply(
        p, jax_prep_images(im, vh), vh, None, train=False, capture_intermediates=is_backbone,
        mutable=["intermediates"]))(nested(tree), images, valid_hw)
    port = build_dino(cfg, NUM_CLASSES, device="cpu")
    load_into(port, tree)
    vh = torch.from_numpy(valid_hw)
    with torch.no_grad():
        feats = port.backbone_net(prep_images(torch.from_numpy(images), vh).permute(0, 3, 1, 2))
    compare_features(feats, state["intermediates"]["backbone_net"]["__call__"][0], name)

    pout, _ = run_port(port, images, valid_hw)
    jsel = np.asarray(jout["interm_outputs_for_matching_pre"]["pred_boxes"])
    psel = pout["interm_outputs_for_matching_pre"]["pred_boxes"].numpy()
    assert np.allclose(jsel, psel, atol=1e-6), f"{name}: the two-stage selection differs"
    for what, j, p in _pairs(jout, pout):
        for key in ("pred_logits", "pred_boxes"):
            assert p[key].shape == j[key].shape, (what, key)
            assert_close(p[key].numpy(), j[key], f"{name} {what} {key}")


def test_check_architecture_takes_the_eight_backbones():
    assert len(ALL) == 8
    for name in ALL:
        cfg = TL.apply_options(TL.load_config("dtlr_tpu_torch/configs/Latin_TPU.py"),
                               TL.parse_options([f"backbone={name}"]))
        _, model_cfg, _ = TC.from_config(cfg, "pretrain")
        assert model_cfg.backbone == name
    cfg = TL.apply_options(TL.load_config("dtlr_tpu_torch/configs/Latin_TPU.py"),
                           TL.parse_options(["backbone=convnext_huge"]))
    with pytest.raises(NotImplementedError, match="backbone in"):
        TC.from_config(cfg, "pretrain")
    with torch.device("meta"):
        assert isinstance(DINO(dataclasses.replace(TINY, backbone="convnext_tiny"), 4), DINO)
