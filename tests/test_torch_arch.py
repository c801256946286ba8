"""The architecture settings that the port once refused, against dtlr_tpu
at the tiny geometry (``TINY`` of test_torch_model.py): the feature-level
count (3 and 5), the decoder layer's order of sublayers, the sine
encodings' temperatures along y and x, and dropout.

The backbone is a minimal ConvNeXt (depths 1, widths 8-64; registered
in both packages' tables for this module, as test_torch_ngram_rescore.py
does), so that each architecture's JAX compile takes seconds; the
backbone is the same module whatever these settings are. The weights are
the port's fresh init with normal(0, 0.05) noise on every leaf, the
same in both packages; the two 128x256 lines have different valid
widths. Tolerances: the forward at 1e-4 of each tensor's scale
(test_torch_model.py's); the gradients at dropout 1.0, per leaf, at
2e-3 of the leaf's largest magnitude (at least 1e-3 of the largest over
all leaves), test_torch_grad_stops.py's tolerance outside the backbone.
At rate 1.0 every site gives zeros in both packages (flax's ``Dropout``
and the port's ``Dropout``), so the train-mode forward is deterministic
and each site's placement shows: a leaf whose every path crosses a site
has a zero gradient on both sides, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dtlr_tpu.models.convnext import CONVNEXT_CONFIGS as JAX_CONVNEXT
from dtlr_tpu.models.dino import DINO as JaxDINO
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.models import transformer as port_transformer
from dtlr_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from dtlr_tpu_torch.models.dino import DINO, build_dino
from dtlr_tpu_torch.models.transformer import Dropout
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.train import config as TC
from dtlr_tpu_torch.train import torch_import as T
from dtlr_tpu_torch.train.checkpoints import params_to_flax
from dtlr_tpu_torch.train.init import init_params, ring_bias
from dtlr_tpu_torch.weights import load_into
from test_torch_backbones import MINIMAL
from test_torch_deform_model import nested
from test_torch_model import NUM_CLASSES, TINY, _pairs, assert_close, run_port

BACKBONE = "convnext_minimal"
GRAD_TOL, GRAD_FLOOR = 2e-3, 1e-3
FLAGSHIP_ARCH = dict(encoder_type="windowed", decoder_ca="dense", dense_box_bias=True,
                     shared_offsets=True)
LATIN_ARCH = dict(encoder_type="deformable", decoder_ca="deform", dense_box_bias=False,
                  shared_offsets=False)
#: the forward's cases: (architecture, settings); every order of the
#: decoder's sublayers is in test_decoder_layer_orders_match_jax
CASES = {
    "levels5_ca_sa_ffn_temperature_h": (FLAGSHIP_ARCH, dict(
        num_feature_levels=5, decoder_module_seq=("ca", "sa", "ffn"),
        pe_temperature_h=10000.0, pe_temperature_w=20.0)),
    "deformable_levels3_ffn_ca_sa_temperature_w": (LATIN_ARCH, dict(
        num_feature_levels=3, decoder_module_seq=("ffn", "ca", "sa"),
        pe_temperature_h=20.0, pe_temperature_w=10000.0)),
}


@pytest.fixture(scope="module", autouse=True)
def minimal_backbone():
    with pytest.MonkeyPatch.context() as mp:
        for table in (JAX_CONVNEXT, CONVNEXT_CONFIGS):
            mp.setitem(table, BACKBONE, MINIMAL["convnext"])
        yield


def port_cfg(arch, **settings):
    return dataclasses.replace(TINY, backbone=BACKBONE, dn_labelbook_size=NUM_CLASSES + 1,
                               **arch, **settings)


def jax_model(cfg, use_dn=False) -> JaxDINO:
    return JaxDINO(
        num_classes=NUM_CLASSES, num_queries=cfg.num_queries, hidden_dim=cfg.hidden_dim,
        n_heads=cfg.nheads, num_encoder_layers=cfg.enc_layers,
        num_decoder_layers=cfg.dec_layers, d_ffn=cfg.dim_feedforward, dropout=cfg.dropout,
        num_feature_levels=cfg.num_feature_levels, backbone=cfg.backbone,
        module_seq=tuple(cfg.decoder_module_seq), use_dn=use_dn,
        dn_labelbook_size=NUM_CLASSES + 1, shared_offsets=cfg.shared_offsets,
        encoder_type=cfg.encoder_type, encoder_win=cfg.encoder_win,
        decoder_ca=cfg.decoder_ca, dense_box_bias=cfg.dense_box_bias,
        pe_temperature_h=cfg.pe_temperature_h, pe_temperature_w=cfg.pe_temperature_w,
        dtype=jnp.float32)


def seeded_flat(cfg, seed=1):
    flat = init_params(cfg, NUM_CLASSES, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    return {k: x + rng.normal(0.0, 0.05, x.shape).astype(np.float32)
            for k, x in sorted(flat.items())}


@pytest.fixture(scope="module")
def lines():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 128, 256, 3), dtype=np.uint8)
    return images, np.asarray([[128, 256], [100, 181]], np.int32)


def check_outputs(jout, pout, what):
    for name, j, p in _pairs(jout, pout):
        for key in ("pred_logits", "pred_boxes"):
            assert p[key].shape == j[key].shape, (what, name, key)
            assert_close(p[key].detach().numpy(), j[key], f"{what} {name} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(lines, case):
    images, valid_hw = lines
    cfg = port_cfg(*CASES[case][:1], **CASES[case][1])
    flat = seeded_flat(cfg)
    jout = jax.jit(lambda p, im, vh: jax_model(cfg).apply(
        p, jax_prep_images(im, vh), vh, None, train=False))(nested(flat), images, valid_hw)
    port = build_dino(cfg, NUM_CLASSES, device="cpu")
    load_into(port, flat)
    pout, seen = run_port(port, images, valid_hw)
    spatial = [tuple(m.shape[1:]) for m in port.levels(
        prep_images(torch.from_numpy(images), torch.from_numpy(valid_hw)),
        torch.from_numpy(valid_hw))[1]]
    assert len(spatial) == cfg.num_feature_levels
    assert spatial[:3] == [(16, 32), (8, 16), (4, 8)] and all(
        b == ((a[0] + 1) // 2, (a[1] + 1) // 2) for a, b in zip(spatial[2:], spatial[3:]))
    jsel = np.asarray(jout["interm_outputs_for_matching_pre"]["pred_boxes"])
    psel = pout["interm_outputs_for_matching_pre"]["pred_boxes"].numpy()
    assert np.allclose(jsel, psel, atol=1e-6), "the two-stage selection differs"
    check_outputs(jout, pout, case)


def test_fewer_levels_than_the_backbone_raises_as_jax(lines):
    """Two levels: JAX's forward indexes a third projection and raises;
    the port refuses the model when it is built."""
    images, valid_hw = lines
    cfg = port_cfg(FLAGSHIP_ARCH, num_feature_levels=2)
    with pytest.raises(IndexError):
        jax.eval_shape(lambda: jax_model(cfg).init(
            {"params": jax.random.PRNGKey(0)}, jax_prep_images(images, valid_hw), valid_hw,
            None))
    with pytest.raises(ValueError, match="num_feature_levels = 2"):
        DINO(cfg, NUM_CLASSES)
    with pytest.raises(ValueError, match="decoder_module_seq"):
        DINO(port_cfg(FLAGSHIP_ARCH, decoder_module_seq=("sa", "xa", "ffn")), NUM_CLASSES)


def outputs_list(out):
    pairs = [out] + list(out["aux_outputs"]) + [out["interm_outputs"],
                                                 out["interm_outputs_for_matching_pre"]]
    return [(p["pred_logits"], p["pred_boxes"]) for p in pairs]


def scalar_weights(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, cfg.num_queries, NUM_CLASSES)).astype(np.float32),
             rng.normal(size=(2, cfg.num_queries, 4)).astype(np.float32))
            for _ in range(cfg.dec_layers + 2)]


def weighted(out, weights, asarray):
    return sum((lg * asarray(wl)).sum() + (bx * asarray(wb)).sum()
               for (lg, bx), (wl, wb) in zip(outputs_list(out), weights))


def test_dropout_one_forward_and_gradients_match_jax(lines):
    """Train mode at rate 1.0 (no denoising queries) with the deformable
    encoder and decoder, which hold every kind of site: the outputs and
    every leaf's gradient of one weighted scalar of them; the leaves that
    only reach the outputs through a site have zero gradient on both
    sides. (The dense cross-attention's site is the same line of
    ``DecoderLayer``, test_decoder_layer_orders_match_jax.)"""
    images, valid_hw = lines
    arch = "deformable"
    cfg = port_cfg(LATIN_ARCH, num_feature_levels=5, dropout=1.0)
    flat = seeded_flat(cfg)
    weights = scalar_weights(cfg)
    jmodel = jax_model(cfg)

    def scalar(p, im, vh):
        out = jmodel.apply(p, jax_prep_images(im, vh), vh, None, train=True,
                           rngs={"dropout": jax.random.PRNGKey(3)})
        return weighted(out, weights, jnp.asarray), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(scalar, has_aux=True))(
        nested(flat), images, valid_hw)
    jgrad = {k: np.asarray(v) for k, v in flatten_dict(jgrad, sep="/").items()}
    jgrad = {"params/" + k.removeprefix("params/"): v for k, v in jgrad.items()}

    port = build_dino(cfg, NUM_CLASSES, device="cpu")
    load_into(port, flat)
    port.train()
    vh = torch.from_numpy(valid_hw)
    pout = port(prep_images(torch.from_numpy(images), vh), vh, train=True,
                dropout=torch.Generator().manual_seed(3))
    check_outputs(jout, pout, f"{arch} dropout 1.0")
    weighted(pout, weights, torch.from_numpy).backward()
    pgrad = params_to_flax({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for n, p in port.named_parameters()}, cfg.nheads)
    assert set(pgrad) == set(jgrad)
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in jgrad.values())
    zero_leaves = 0
    for k, want in jgrad.items():
        got = pgrad[k]
        if not np.abs(want).any():
            zero_leaves += 1
            assert not np.abs(got).any(), f"{k}: JAX's gradient is zero, the port's is not"
            continue
        scale = max(float(np.abs(want).max()), floor)
        assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, k
    # every decoder layer's FFN and attention projections lie behind a site
    dec = [k for k in jgrad if "/decoder_layer_" in k and ("linear" in k or "_attn/" in k)]
    assert dec and all(not np.abs(jgrad[k]).any() for k in dec)
    assert zero_leaves >= len(dec)


def test_dropout_sites_share_and_scale(lines):
    """At rate 0.1: the sites are JAX's count (3 per deformable encoder
    layer, 4 per decoder layer), each keeps a share within 5 sigma of 0.9
    and scales what it keeps by 1 / 0.9; the same generator seed gives
    the same forward; in eval mode the model equals the rate-0 model bit
    for bit."""
    images, valid_hw = lines
    cfg = port_cfg(LATIN_ARCH, num_feature_levels=5, dropout=0.1)
    flat = seeded_flat(cfg)
    port = build_dino(cfg, NUM_CLASSES, device="cpu")
    load_into(port, flat)
    vh = torch.from_numpy(valid_hw)
    x = prep_images(torch.from_numpy(images), vh)
    records = []
    call = Dropout.__call__

    def recording(self, t):
        out = call(self, t)
        records.append((t.detach(), out.detach()))
        return out

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(Dropout, "__call__", recording)
        a = port.train()(x, vh, train=True, dropout=torch.Generator().manual_seed(5))
        sites = len(records)
        b = port(x, vh, train=True, dropout=torch.Generator().manual_seed(5))
        c = port(x, vh, train=True, dropout=torch.Generator().manual_seed(6))
        records_eval = len(records)
        ev = port.eval()(x, vh)
        assert len(records) == records_eval  # eval mode draws nothing
    assert sites == 3 * cfg.enc_layers + 4 * cfg.dec_layers
    for (la, ba), (lb, bb) in zip(outputs_list(a), outputs_list(b)):
        assert torch.equal(la, lb) and torch.equal(ba, bb)
    assert not torch.equal(a["pred_logits"], c["pred_logits"])
    kept = total = 0
    for t, out in records[:sites]:
        nz = t != 0
        k = (out != 0) & nz
        kept += int(k.sum())
        total += int(nz.sum())
        torch.testing.assert_close(out[k], t[k] / 0.9, rtol=0, atol=0)
    sigma = (0.9 * 0.1 / total) ** 0.5
    assert abs(kept / total - 0.9) <= 5 * sigma, (kept / total, sigma)

    rate0 = build_dino(dataclasses.replace(cfg, dropout=0.0), NUM_CLASSES, device="cpu")
    load_into(rate0, flat)
    with torch.no_grad():
        ref = rate0(x, vh)
    for (la, ba), (lb, bb) in zip(outputs_list(ev), outputs_list(ref)):
        assert torch.equal(la, lb) and torch.equal(ba, bb)


def test_dropout_module_edges():
    x = torch.randn(4096)
    assert Dropout(0.0)(x) is x
    assert not Dropout(1.0)(x).any()
    gen = torch.Generator().manual_seed(0)
    y = Dropout(0.25, gen)(x)
    keep = y != 0
    torch.testing.assert_close(y[keep], x[keep] / 0.75, rtol=0, atol=0)
    with pytest.raises(ValueError):
        Dropout(1.5)


def test_five_level_init_and_pth_round_trip(tmp_path):
    """The fresh init at 5 levels: JAX's names and shapes (the fifth 3x3
    projection, level_embed (5, C), each sampling-offset ring over 5
    levels); and a 5-level tree of the reference's architecture through a
    reference ``.pth`` and back."""
    cfg = port_cfg(LATIN_ARCH, num_feature_levels=5)
    tree = init_params(cfg, NUM_CLASSES, torch.Generator().manual_seed(0))
    images = np.zeros((1, 128, 256, 3), np.float32)
    shapes = jax.eval_shape(lambda: jax_model(cfg).init(
        {"params": jax.random.PRNGKey(0)}, images, np.asarray([[128, 256]], np.int32), None))
    want = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    assert {k: tuple(v.shape) for k, v in tree.items()} == want
    assert tree["params/input_proj_4_conv/kernel"].shape == (3, 3, cfg.hidden_dim,
                                                               cfg.hidden_dim)
    assert tree["params/transformer/level_embed"].shape == (5, cfg.hidden_dim)
    np.testing.assert_array_equal(
        tree["params/transformer/encoder_layer_0/self_attn/sampling_offsets/bias"],
        ring_bias(cfg.nheads, 5, cfg.enc_n_points).numpy())

    ref = dataclasses.replace(TINY, dn_labelbook_size=NUM_CLASSES + 1, num_feature_levels=5,
                              **LATIN_ARCH, norm_kind="FrozenBatchNorm2d")
    # a value of its own on every leaf (a constant each: the draws of the
    # ResNet's 24M would cost more than the round trip)
    tree = {k: np.full(x.shape, i + 1, np.float32)
            for i, (k, x) in enumerate(sorted(T.template(ref, NUM_CLASSES).items()))}
    path = str(tmp_path / "five.pth")
    T.save_torch_checkpoint(tree, path, ref.nheads)
    assert "input_proj.4.0.weight" in T.load_torch_checkpoint(path)
    back = T.load_params_file(path, ref)
    assert set(back) == set(tree) and all(np.array_equal(back[k], tree[k]) for k in tree)


def test_decoder_layer_orders_match_jax():
    """One decoder layer (dense cross-attention with the box prior and key
    padding) in each of the six orders of its sublayers against JAX's
    ``DecoderLayer`` at eval, and one order in train mode at dropout 1.0."""
    import itertools

    from dtlr_tpu.models.transformer import DecoderLayer as JaxDecoderLayer
    from dtlr_tpu_torch.models.transformer import DecoderLayer

    rng = np.random.default_rng(2)
    B, Q, C, M, F = 2, 6, 16, 2, 24
    shapes = ((4, 8), (2, 4))
    S = sum(h * w for h, w in shapes)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    tgt, qpos, mem, mpos = f32(B, Q, C), f32(B, Q, C), f32(B, S, C), f32(B, S, C)
    ref = rng.uniform(0.2, 0.8, size=(B, Q, len(shapes), 4)).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, -5:] = True
    args = (tgt, qpos, ref, mem, shapes, pad)
    # the parameters do not depend on the order: one init serves all six
    params = JaxDecoderLayer(C, F, len(shapes), M, 4, ca_type="dense", box_bias=True).init(
        jax.random.PRNGKey(0), *args, memory_pos=mpos)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(np.float32), params)
    for seq in itertools.permutations(("sa", "ca", "ffn")):
        cases = ((0.0, False),) + (((1.0, True),) if seq == ("ffn", "sa", "ca") else ())
        for rate, train in cases:
            jl = JaxDecoderLayer(C, F, len(shapes), M, 4, rate, seq, ca_type="dense",
                                 box_bias=True)
            want = jl.apply(params, *args, memory_pos=mpos, deterministic=not train,
                            rngs={"dropout": jax.random.PRNGKey(1)})
            layer = DecoderLayer(C, F, M, torch.float32, "dense", True, len(shapes), 4,
                                 False, seq)
            load_into(layer, {"params/" + k: v for k, v in flatten_dict(
                params["params"], sep="/").items()})
            key_bias = torch.zeros(B, S).masked_fill(torch.from_numpy(pad), -1e9)
            t = lambda a: torch.from_numpy(a)
            got = layer(t(tgt), t(qpos), t(ref), t(mem), shapes, key_bias, t(mpos),
                        drop=Dropout(rate) if train else port_transformer._identity)
            assert_close(got.detach().numpy(), want, f"{seq} rate {rate}")


def test_config_file_settings_build_train_and_read(tmp_path):
    """A recipe file with the four settings changed: ``from_config`` reads
    them into ``DinoConfig``, ``ARCHITECTURE`` keeps only the parameter
    dtype (JAX's one value), ``to_config`` writes them back, and the
    ``--options`` syntax parses the order; one CTC step at rate 0.1 is
    finite and an eval read follows."""
    from dtlr_tpu_torch import config as cfg_lib
    from dtlr_tpu_torch.train.engine import Trainer

    assert set(TC.ARCHITECTURE) == {"param_dtype"}
    path = tmp_path / "arch_cfg.py"
    path.write_text("\n".join([
        "_base_ = ['" + str(TC.__file__).replace("train/config.py", "configs/Latin_TPU.py")
        + "']", "num_feature_levels = 5", "decoder_module_seq = ['ca', 'sa', 'ffn']",
        "pe_temperatureH = 10000", "pe_temperatureW = 20", "dropout = 0.1", ""]))
    cfg = cfg_lib.apply_options(cfg_lib.load_config(str(path)), cfg_lib.parse_options(
        ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
         "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32",
         f"backbone={BACKBONE}"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TC.ACCEPTED, "backbone", TC.ACCEPTED["backbone"] + (BACKBONE,))
        train, model, _ = TC.from_config(cfg, "ctc")
    assert (model.num_feature_levels, model.decoder_module_seq, model.dropout,
            model.pe_temperature_h, model.pe_temperature_w) == (
        5, ("ca", "sa", "ffn"), 0.1, 10000.0, 20.0)
    back = TC.to_config(train, model, NUM_CLASSES, NUM_CLASSES + 1)
    assert back["decoder_module_seq"] == ["ca", "sa", "ffn"]
    assert back["pe_temperatureH"] == 10000.0 and back["dropout"] == 0.1
    _, opts_model = TC.apply_options(train, TINY, ["decoder_module_seq=[ffn,sa,ca]",
                                                   "num_feature_levels=5", "dropout=0.5"])
    assert opts_model.decoder_module_seq == ("ffn", "sa", "ca")

    model = dataclasses.replace(model, dn_labelbook_size=NUM_CLASSES + 1)
    train = dataclasses.replace(train, batch_size=2)
    trainer = Trainer(train, model, output_dir=str(tmp_path / "run"), device="cpu")
    trainer.build(init_params(model, NUM_CLASSES, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3), np.uint8)),
             "valid_hw": torch.tensor([[128, 256], [100, 181]], dtype=torch.int32),
             "labels": torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]]),
             "valid": torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0]], dtype=torch.bool)}
    gen = trainer.dropout_generator()
    assert gen is not None
    seed = gen.initial_seed()
    metrics = trainer.step_fn(trainer.state, batch, gen)[1]
    assert torch.isfinite(metrics["loss"])
    trainer.state.step = 0
    assert trainer.dropout_generator().initial_seed() == seed  # the step's seed
    with torch.no_grad():
        out = trainer.state.model.eval()(prep_images(batch["images"], batch["valid_hw"]),
                                         batch["valid_hw"])
    assert torch.isfinite(out["pred_logits"]).all()


def test_rate_zero_takes_no_generator_and_step_is_unchanged(lines, tmp_path):
    """At rate 0 the Trainer passes no generator, and a CTC train-mode
    forward equals the eval forward bit for bit."""
    from dtlr_tpu_torch.train.config import RECIPE
    from dtlr_tpu_torch.train.engine import Trainer

    cfg = port_cfg(FLAGSHIP_ARCH)
    trainer = Trainer(RECIPE, cfg, output_dir=str(tmp_path), device="cpu")
    assert trainer.dropout_generator() is None
    images, valid_hw = lines
    port = build_dino(cfg, NUM_CLASSES, device="cpu")
    load_into(port, seeded_flat(cfg))
    vh = torch.from_numpy(valid_hw)
    x = prep_images(torch.from_numpy(images), vh)
    with torch.no_grad():
        a = port.train()(x, vh, train=True)
        b = port.eval()(x, vh)
    for (la, ba), (lb, bb) in zip(outputs_list(a), outputs_list(b)):
        assert torch.equal(la, lb) and torch.equal(ba, bb)
