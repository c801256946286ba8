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
"""

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
#: standard errors of the sampling bounds
SIGMAS = 6.0


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX's init tree (flat, numpy) and the port's, from the same config."""
    cfg = jax_apply(jax_load_config("dtlr_tpu/configs/Latin_TPU.py"), jax_parse(TINY_KEYS))
    trainer = JaxTrainer(cfg, mode="detection", seed=0,
                         output_dir=str(tmp_path_factory.mktemp("jax")))
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8),
             "valid_hw": np.asarray([[64, 128], [50, 90]], np.int32),
             "labels": np.zeros((2, 8), np.int32), "boxes": np.full((2, 8, 4), 0.2, np.float32),
             "valid": np.ones((2, 8), bool)}
    want = jax_flatten(jax.tree.map(np.asarray, trainer.init_params(batch)))
    _, model_cfg, config, _ = load_settings("dtlr_tpu_torch/configs/Latin_TPU.py", TINY_KEYS,
                                            "pretrain")
    import dataclasses

    model_cfg = dataclasses.replace(model_cfg, dn_labelbook_size=NUM_CLASSES + 1)
    got = init_params(model_cfg, NUM_CLASSES, torch.Generator().manual_seed(0))
    return want, got, model_cfg


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
    want, got, _ = trees
    assert set(got) == set(want) and len(got) == len(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k


def test_families_and_constant_leaves(trees):
    want, got, _ = trees
    seen = set()
    for k, w in want.items():
        name = port_name(k, w.ndim)
        torch_shape = tuple(load_jax_params({k: w})[name].shape)
        kind = family(name, len(torch_shape))
        std = lecun_std(torch_shape) if kind == "lecun" else 1.0
        assert jax_family(w, std) == kind, (k, kind)
        seen.add(kind)
        if kind in ("zero", "one", "prior"):
            assert np.array_equal(got[k], w), k
    assert seen == {"zero", "one", "prior", "lecun", "normal"}
    for k in ("params/label_enc", "params/transformer/level_embed",
              "params/transformer/tgt_embed"):
        assert family(port_name(k, 2), 2) == "normal"
    for k in ("params/bbox_embed/layers_2/kernel", "params/enc_out_bbox_embed/layers_2/kernel",
              "params/transformer/encoder_layer_0/mix_up/kernel",
              "params/transformer/encoder_layer_1/mix_down/kernel",
              "params/transformer/decoder_layer_0/ca_box_gamma"):
        assert np.all(want[k] == 0) and np.all(got[k] == 0), k


def test_random_leaves_within_sampling_bounds(trees):
    want, got, _ = trees
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
    assert checked >= 90  # every kernel and the three embeddings


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
