"""The port's fresh initialization (dtlr_tpu_torch/train/init.py) against
the JAX package's (``Trainer.init_params``, dtlr_tpu/train/engine.py:155-182,
flax's initializers) at the tiny geometry (``TINY``, the detection mode
with its CDN label encoder).

- Every leaf of JAX's tree has the port's name and shape, and no other.
- Each leaf's family, read from JAX's values (all zero, all one, all the
  focal prior, a normal truncated at two of its std, a normal of std 1),
  is the port's ``family`` of it; the constant leaves are equal exactly.
- Random leaves: the port's mean and std lie within sampling bounds of
  JAX's own leaf's: six standard errors of the difference of two
  estimates from n draws of std s (mean: s * sqrt(2 / n); std, for a
  normal, s * sqrt(1 / n), and for the truncated normal, whose fourth
  moment is lower, less), and each leaf's std within the same bound of
  its family's (sqrt(1 / fan_in) lecun-normal, 1). The truncated leaves
  lie within two of their untruncated std, JAX's too.
- A fresh model's forward and first detection step are finite.
- The same for the reference's architecture (configs/Latin.py: deformable
  encoder and cross-attention, FrozenBN backbone) at TINY: its names and
  shapes; the sampling offsets' ring bias within 1e-6 of JAX's (float32
  cos and sin of two libraries); the zero sampling-offset and
  attention-weight kernels and attention-weight bias, and the FrozenBN
  statistics (scale and var one, bias and mean zero) exactly.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from dtlr_tpu.config import load_config as jax_load_config
from dtlr_tpu.config.loader import apply_options as jax_apply, parse_options as jax_parse
from dtlr_tpu.train.checkpoints import _flatten as jax_flatten
from dtlr_tpu.train.engine import Trainer as JaxTrainer
from dtlr_tpu_torch.ops.pixels import prep_images
from dtlr_tpu_torch.train.config import load_settings
from dtlr_tpu_torch.train.engine import Trainer, collate
from dtlr_tpu_torch.train.init import FOCAL_PRIOR, family, init_params, lecun_std
from dtlr_tpu_torch.eval.evaluate import load_lines
from dtlr_tpu_torch.weights import load_jax_params
from test_torch_smoke_detect import FIXTURE

NUM_CLASSES = 12
TINY_KEYS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
             "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32", "batch_size=2",
             "max_targets=8", "dn_number=3", f"num_classes={NUM_CLASSES}",
             f"dn_labelbook_size={NUM_CLASSES + 1}", "compilation_cache_dir=",
             "print_freq=1"]
TINY_HEADS = 4
#: standard errors of the sampling bounds
SIGMAS = 6.0


def init_trees(config: str, out_dir: str):
    """JAX's init tree (flat, numpy) and the port's, from the same config
    file at TINY, and the port's model config."""
    cfg = jax_apply(jax_load_config(f"dtlr_tpu/configs/{config}"), jax_parse(TINY_KEYS))
    trainer = JaxTrainer(cfg, mode="detection", seed=0, output_dir=out_dir)
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8),
             "valid_hw": np.asarray([[64, 128], [50, 90]], np.int32),
             "labels": np.zeros((2, 8), np.int32), "boxes": np.full((2, 8, 4), 0.2, np.float32),
             "valid": np.ones((2, 8), bool)}
    want = jax_flatten(jax.tree.map(np.asarray, trainer.init_params(batch)))
    _, model_cfg, config, _ = load_settings(f"dtlr_tpu_torch/configs/{config}", TINY_KEYS,
                                            "pretrain")
    model_cfg = dataclasses.replace(model_cfg, dn_labelbook_size=NUM_CLASSES + 1)
    got = init_params(model_cfg, NUM_CLASSES, torch.Generator().manual_seed(0))
    return want, got, model_cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return init_trees("Latin_TPU.py", str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def deform_trees(tmp_path_factory):
    return init_trees("Latin.py", str(tmp_path_factory.mktemp("jax_deform")))


def jax_family(x: np.ndarray, std: float) -> str:
    if np.all(x == 0):
        return "zero"
    if np.all(x == 1):
        return "one"
    if np.all(x == np.float32(FOCAL_PRIOR)):
        return "prior"
    if np.abs(x).max() <= 2 * std * (1 + 1e-6):
        return "lecun"
    return "normal"


def port_name(key: str, ndim: int) -> str:
    """The port's parameter name of a flax leaf."""
    return next(iter(load_jax_params({key: np.zeros((1,) * ndim, np.float32)})))


def test_names_and_shapes_are_jax_s(trees):
    check_names_and_shapes(*trees[:2])


def check_names_and_shapes(want, got):
    assert set(got) == set(want) and len(got) == len(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k


def check_families(want, got):
    """Each leaf's family read from JAX's values is the port's; constants
    exact, the ring within 1e-6. Returns the families seen."""
    seen = set()
    for k, w in want.items():
        name = port_name(k, w.ndim)
        torch_shape = tuple(load_jax_params({k: w})[name].shape)
        kind = family(name, len(torch_shape))
        seen.add(kind)
        if kind == "ring":
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
            continue
        std = lecun_std(torch_shape) if kind == "lecun" else 1.0
        assert jax_family(w, std) == kind, (k, kind)
        if kind in ("zero", "one", "prior"):
            assert np.array_equal(got[k], w), k
    return seen


def test_families_and_constant_leaves(trees):
    want, got, _ = trees
    assert check_families(want, got) == {"zero", "one", "prior", "lecun", "normal"}
    for k in ("params/label_enc", "params/transformer/level_embed",
              "params/transformer/tgt_embed"):
        assert family(port_name(k, 2), 2) == "normal"
    for k in ("params/bbox_embed/layers_2/kernel", "params/enc_out_bbox_embed/layers_2/kernel",
              "params/transformer/encoder_layer_0/mix_up/kernel",
              "params/transformer/encoder_layer_1/mix_down/kernel",
              "params/transformer/decoder_layer_0/ca_box_gamma"):
        assert np.all(want[k] == 0) and np.all(got[k] == 0), k


def test_random_leaves_within_sampling_bounds(trees):
    assert check_random_leaves(*trees[:2]) >= 90  # every kernel and the three embeddings


def check_random_leaves(want, got) -> int:
    """The lecun and normal leaves within the sampling bounds of the
    module docstring; returns how many were checked."""
    checked = 0
    for k, w in want.items():
        name = port_name(k, w.ndim)
        torch_shape = tuple(load_jax_params({k: w})[name].shape)
        kind = family(name, len(torch_shape))
        if kind not in ("lecun", "normal"):
            continue
        g, n = got[k].astype(np.float64), w.size
        s = math.sqrt(1.0 / int(np.prod(torch_shape[1:]))) if kind == "lecun" else 1.0
        assert abs(g.mean() - w.mean()) <= SIGMAS * s * math.sqrt(2.0 / n), k
        assert abs(g.std() - w.std()) <= SIGMAS * s * math.sqrt(1.0 / n), k
        for x in (g, w):
            assert abs(x.std() - s) <= SIGMAS * s * math.sqrt(1.0 / n), k
        if kind == "lecun":
            bound = 2 * lecun_std(torch_shape) * (1 + 1e-6)
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, k
        checked += 1
    return checked


def test_fresh_model_forward_and_first_detection_step_are_finite(trees):
    _, got, model_cfg = trees
    cfg, _, _, _ = load_settings("dtlr_tpu_torch/configs/Latin_TPU.py", TINY_KEYS, "pretrain")
    trainer = Trainer(cfg, model_cfg, device="cpu", mode="detection",
                      output_dir=str(__import__("tempfile").mkdtemp()))
    trainer.build(got)
    lines = load_lines(FIXTURE)
    batch = collate(lines, [0, 1], lines["charset"][:NUM_CLASSES], cfg.max_targets)
    batch["images"] = np.ascontiguousarray(batch["images"][:, :64, :128])
    batch["labels"] = batch["labels"] % NUM_CLASSES
    vh = torch.from_numpy(np.minimum(batch["valid_hw"], [64, 128]).astype(np.int32))
    batch["valid_hw"] = vh.numpy()
    with torch.no_grad():
        out = trainer.state.model(prep_images(torch.from_numpy(batch["images"]), vh), vh)
    assert torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_boxes"]).all()
    m = trainer.step(batch)
    assert math.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0


# ------------------------------------------------ the reference's architecture

def test_deform_names_shapes_and_families_are_jax_s(deform_trees):
    want, got, model_cfg = deform_trees
    assert (model_cfg.encoder_type, model_cfg.decoder_ca, model_cfg.norm_kind) == (
        "deformable", "deform", "FrozenBatchNorm2d")
    check_names_and_shapes(want, got)
    assert check_families(want, got) == {"zero", "one", "prior", "lecun", "normal", "ring"}
    assert check_random_leaves(want, got) >= 90
    enc = "params/transformer/encoder_layer_0/self_attn"
    dec = "params/transformer/decoder_layer_1/cross_attn"
    for k in (f"{enc}/sampling_offsets/kernel", f"{enc}/attention_weights/kernel",
              f"{enc}/attention_weights/bias", f"{dec}/sampling_offsets/kernel",
              "params/backbone_net/FrozenBatchNorm_0/bias",
              "params/backbone_net/layer1_0/FrozenBatchNorm_3/mean"):
        assert np.all(want[k] == 0) and np.all(got[k] == 0), k
    for k in ("params/backbone_net/layer2_0/FrozenBatchNorm_1/scale",
              "params/backbone_net/layer4_2/FrozenBatchNorm_2/var"):
        assert np.all(want[k] == 1) and np.all(got[k] == 1), k
    ring = got[f"{enc}/sampling_offsets/bias"].reshape(TINY_HEADS, 4, 4, 2)
    # head 0 points along +x, each point p at p + 1 pixels, every level alike
    assert np.array_equal(ring[0, :, :, 0], np.tile(np.arange(1, 5, dtype=np.float32), (4, 1)))


def test_deform_fresh_model_first_detection_step_is_finite(deform_trees):
    _, got, model_cfg = deform_trees
    cfg, _, _, _ = load_settings("dtlr_tpu_torch/configs/Latin.py", TINY_KEYS, "pretrain")
    trainer = Trainer(cfg, model_cfg, device="cpu", mode="detection",
                      output_dir=str(__import__("tempfile").mkdtemp()))
    trainer.build(got)
    lines = load_lines(FIXTURE)
    batch = collate(lines, [0, 1], lines["charset"][:NUM_CLASSES], cfg.max_targets)
    batch["images"] = np.ascontiguousarray(batch["images"][:, :64, :128])
    batch["labels"] = batch["labels"] % NUM_CLASSES
    batch["valid_hw"] = np.minimum(batch["valid_hw"], [64, 128]).astype(np.int32)
    m = trainer.step(batch)
    assert math.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0


def test_detection_epoch_without_cdn(deform_trees):
    """Chinese.py's recipe pretrains without CDN (use_dn False): a
    detection epoch logs the terms the step has, and no DN term (the port
    read ``loss_ce_dn`` unconditionally and raised KeyError)."""
    _, got, model_cfg = deform_trees
    cfg, _, _, _ = load_settings("dtlr_tpu_torch/configs/Latin.py", TINY_KEYS, "pretrain")
    trainer = Trainer(cfg, dataclasses.replace(model_cfg, use_dn=False), device="cpu",
                      mode="detection", output_dir=str(__import__("tempfile").mkdtemp()))
    trainer.build(got)
    lines = load_lines(FIXTURE)
    batch = collate(lines, [2, 3], lines["charset"][:NUM_CLASSES], cfg.max_targets)
    batch["images"] = np.ascontiguousarray(batch["images"][:, :64, :128])
    batch["labels"] = batch["labels"] % NUM_CLASSES
    batch["valid_hw"] = np.minimum(batch["valid_hw"], [64, 128]).astype(np.int32)
    stats = trainer.train_epoch([batch])
    assert "loss_ce_dn" not in stats and math.isfinite(stats["loss"])
    assert stats["iterations"] == 1 and stats["skipped"] == 0.0
