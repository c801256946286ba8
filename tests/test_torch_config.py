"""The port's config loader and config files (dtlr_tpu_torch/config,
dtlr_tpu_torch/configs) against the JAX package's (dtlr_tpu/config,
dtlr_tpu/configs), exactly, and ``train/config.py``'s mapping of a
config onto the port's settings (``from_config``).

- Each of the 11 config files loads to JAX's keys and values. One value
  differs by design: ``compilation_cache_dir``, which the port does not
  read, names the cache relative to the checkout (JAX's files name an
  absolute path on the TPU host); it must be the tail of JAX's.
- ``parse_options`` and ``apply_options`` give JAX's results on the
  options of scripts/round4_chain.sh and scripts/hwdb_real.sh as the
  shell hands them over (lists, quoted values, paths), and on literals of
  each kind; JAX-dumped run configs load to JAX's values and dump back
  to JAX's bytes.
- ``from_config`` of Latin_TPU.py with round4_chain.sh's options is
  ``RECIPE_DETECTION`` and ``FLAGSHIP`` field for field; of the dumped
  finetune config it is ``RECIPE``; ``to_config`` reads back; the keys the
  port does not read are listed.
- Each of the 10 recipe files (the reference's deformable FrozenBN ones
  included) loads to the model JAX's ``build_dino_from_config`` builds
  from it, and at the tiny geometry the port's fresh tree has JAX's
  parameter names and shapes (``jax.eval_shape`` of JAX's init). What
  the port lacks (a Swin variant JAX does not know, three levels,
  dropout, an unknown encoder) is refused, naming it.
"""

import dataclasses
import os
import shlex

import pytest

from dtlr_tpu.config import loader as JL
from dtlr_tpu_torch.config import loader as TL
from dtlr_tpu_torch.models.dino import FLAGSHIP
from dtlr_tpu_torch.train import config as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(f for f in os.listdir(os.path.join(REPO, "dtlr_tpu", "configs"))
               if f.endswith(".py") and not f.startswith("__"))
#: scripts/round4_chain.sh:51-56 (its corpus paths stand for $CW_TRAIN, $CW_VAL)
ROUND4 = shlex.split("""batch_size=8 use_ema=True warmup_steps=200 \
      max_targets=64 'data_aug_scales=[128]' data_aug_max_size=1024 \
      image_w_max=1024 image_h_max=192 synthetic_max_words=5 eval_set_size=200 \
      save_checkpoint_interval=20 lr_drop=50000 rss_restart_gb=80 \
      batch_norm_type=group lr_backbone=1e-4 dense_box_bias=True \
      synthetic_corpus_file="artifacts/corpus_words_train.txt" \
      synthetic_corpus_val_file="artifacts/corpus_words_val.txt" \
      synthetic_corpus_prob=0.5""")
#: scripts/hwdb_real.sh:32-38 (its pickle path relative here)
HWDB_REAL = shlex.split("""batch_size=4 max_targets=64 'data_aug_scales=[96]' \
  data_aug_max_size=1024 image_w_max=1024 image_h_max=160 \
  eval_set_size=64 \
  warmup_steps=500 lr_drop=1000000 \
  hwdb_charset_pickle=data/HWDB_v1/charset.pkl \
  'hwdb_glyphs_per_line=[5,25]' \
  compilation_cache_dir=outputs/xla_cache""")
LITERALS = ["a=1", "b=1.5e-3", "c=true", "d=False", "e=none", "f=null", "g=[1, (2, 3)]",
            "h='quoted'", "i=plain text", "j.k=2", "j.l=[x]", "m={'n': 1}", "o=", "p=-7"]
DUMPS = ["outputs/finetune_r4/config_cfg.py", "outputs/finetune_r4b/config_cfg.py",
         "outputs/hwdb_ft/config_cfg.py"]


def port_path(name):
    return os.path.join(REPO, "dtlr_tpu_torch", "configs", name)


def jax_path(name):
    return os.path.join(REPO, "dtlr_tpu", "configs", name)


@pytest.mark.parametrize("name", FILES)
def test_config_files_load_as_jax_s(name):
    got, want = TL.load_config(port_path(name)), JL.load_config(jax_path(name))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "compilation_cache_dir":
            assert v.endswith("/" + got[k]) and not os.path.isabs(got[k])
        else:
            assert got[k] == v and type(got[k]) is type(v), k
    assert len(FILES) == 11


@pytest.mark.parametrize("options", [ROUND4, HWDB_REAL, LITERALS],
                         ids=["round4_chain", "hwdb_real", "literals"])
def test_options_parse_and_apply_as_jax_s(options):
    got, want = TL.parse_options(options), JL.parse_options(options)
    assert got == want
    base = "Chinese_TPU.py" if options is HWDB_REAL else "Latin_TPU.py"
    applied = TL.apply_options(TL.load_config(jax_path(base)), got)
    assert applied == JL.apply_options(JL.load_config(jax_path(base)), want)
    assert isinstance(applied, TL.Config) and applied.get_default("nope", 3) == 3
    with pytest.raises(ValueError):
        TL.parse_options(["no_equals"])


@pytest.mark.parametrize("path", DUMPS)
def test_dumped_run_configs_load_and_dump_as_jax_s(path, tmp_path):
    got, want = TL.load_config(os.path.join(REPO, path)), JL.load_config(os.path.join(REPO, path))
    assert got == want
    TL.dump_config(got, str(tmp_path / "port.py"))
    JL.dump_config(want, str(tmp_path / "jax.py"))
    assert (tmp_path / "port.py").read_bytes() == (tmp_path / "jax.py").read_bytes()
    assert TL.load_config(str(tmp_path / "port.py")) == want


def test_base_inheritance_and_delete(tmp_path):
    (tmp_path / "base.py").write_text("a = 1\nd = {'x': 1, 'y': 2}\nlst = [1]\n")
    (tmp_path / "mid.py").write_text("_base_ = 'base.py'\nd = {'y': 3}\nb = 2\n")
    (tmp_path / "top.py").write_text("_base_ = ['mid.py']\nd = {'_delete_': True, 'z': 4}\n"
                                     "import os\ndef f():\n    pass\n")
    for name in ("mid.py", "top.py"):
        got, want = TL.load_config(str(tmp_path / name)), JL.load_config(str(tmp_path / name))
        assert got == want
    assert TL.load_config(str(tmp_path / "top.py")) == {"a": 1, "b": 2, "d": {"z": 4},
                                                         "lst": [1]}


def test_flagship_recipe_from_its_config_file():
    """scripts/round4_chain.sh's run: Latin_TPU.py, its --options, and
    --epochs 400 --steps_per_epoch 500, which its entry point sets."""
    cfg = TL.apply_options(TL.load_config(port_path("Latin_TPU.py")), TL.parse_options(ROUND4))
    cfg.epochs, cfg.steps_per_epoch = 400, 500
    train, model, unread = TC.from_config(cfg, "pretrain")
    for f in dataclasses.fields(train):
        assert getattr(train, f.name) == getattr(TC.RECIPE_DETECTION, f.name), f.name
    assert train == TC.RECIPE_DETECTION and model == FLAGSHIP
    assert {"compilation_cache_dir", "rss_restart_gb", "synthetic_corpus_file",
            "query_dim"} <= set(unread)
    assert not set(unread) & {"lr", "batch_size", "use_ema", "dn_labelbook_size",
                              "num_classes", "encoder_type", "max_targets", "synthetic_reuse",
                              "deform_shared_offsets", "enc_n_points", "batch_norm_type"}
    assert TC.labelbook_offset(cfg) == 1
    assert TC.labelbook_offset(TL.load_config(port_path("Chinese_TPU.py"))) == 0


def test_finetune_recipe_from_its_dumped_config():
    """outputs/finetune_r4b/config_cfg.py, the run that finetuned the
    shipped Latin checkpoints, is the port's RECIPE."""
    cfg = TL.load_config(os.path.join(REPO, "outputs/finetune_r4b/config_cfg.py"))
    train, model, unread = TC.from_config(cfg, "ctc")
    assert train == TC.RECIPE
    assert dataclasses.replace(model, use_dn=True) == FLAGSHIP
    # the finetune passes no reuse pool and no erasing to its batcher
    assert "synthetic_reuse" in unread and train.reuse == 1


def test_keys_that_are_absent_take_jax_s_defaults_and_read_back():
    cfg = TL.load_config(port_path("Chinese_TPU.py"))
    train, model, _ = TC.from_config(cfg, "pretrain")
    assert (train.max_targets, train.image_w_max, train.steps_per_epoch, train.eval_set_size,
            train.save_checkpoint_interval) == (256, 1344, 1250, 200, 30)
    assert (model.compute_dtype, model.use_dn, model.dn_number) == ("bfloat16", True, 100)
    assert TC.from_config(cfg, "ctc")[0].eval_set_size == 64
    dumped = TC.to_config(train, model, 36, 36)
    assert TC.from_config(TL.Config(dumped), "pretrain")[:2] == (train, model)
    del cfg["lr"]
    with pytest.raises(KeyError, match="'lr'"):
        TC.from_config(cfg, "pretrain")


#: JAX's DINO attributes (dtlr_tpu/models/dino.py:334-364) and the
#: DinoConfig field of each
JAX_MODEL_FIELDS = {
    "num_queries": "num_queries", "hidden_dim": "hidden_dim", "n_heads": "nheads",
    "num_encoder_layers": "enc_layers", "num_decoder_layers": "dec_layers",
    "d_ffn": "dim_feedforward", "encoder_win": "encoder_win", "use_dn": "use_dn",
    "dn_number": "dn_number", "dn_box_noise_scale": "dn_box_noise_scale",
    "dn_label_noise_ratio": "dn_label_noise_ratio", "encoder_type": "encoder_type",
    "decoder_ca": "decoder_ca", "dense_box_bias": "dense_box_bias",
    "shared_offsets": "shared_offsets", "norm_kind": "norm_kind", "backbone": "backbone",
    "enc_n_points": "enc_n_points", "dec_n_points": "dec_n_points"}
#: the options that cut a config to the tiny geometry; its architecture stays
TINY_OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
                "dim_feedforward=64", "encoder_win=8", "num_classes=12",
                "dn_labelbook_size=13"]
RECIPE_FILES = [f for f in FILES if f != "transformer_base.py"]
_JAX_TREES = {}


def jax_tree_shapes(jmodel):
    """Names and shapes of JAX's parameter tree (``jax.eval_shape`` of its
    init on one 64x128 line), once per distinct model."""
    import jax
    import numpy as np

    key = repr(jmodel)
    if key not in _JAX_TREES:
        images = np.zeros((1, 64, 128, 3), np.float32)
        vh = np.asarray([[64, 128]], np.int32)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), images, vh, None,
                                                    train=False))
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        _JAX_TREES[key] = flat
    return _JAX_TREES[key]


@pytest.mark.parametrize("name", RECIPE_FILES)
def test_recipe_file_builds_jax_s_model(name):
    """Each recipe file (the reference's six included) loads through
    ``from_config`` to the model JAX's ``build_dino_from_config`` builds
    from it (every architecture and geometry field), and at the tiny
    geometry the port's fresh tree has JAX's names and shapes."""
    import torch

    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu_torch.train.init import init_params

    jcfg = JL.load_config(jax_path(name))
    jmodel = build_dino_from_config(jcfg)
    _, model, _ = TC.from_config(TL.load_config(port_path(name)), "pretrain")
    for jname, field in JAX_MODEL_FIELDS.items():
        assert getattr(model, field) == getattr(jmodel, jname), (name, field)
    assert model.compute_dtype == jcfg.get_default("compute_dtype", "float32")

    jtiny = build_dino_from_config(JL.apply_options(jcfg, JL.parse_options(TINY_OPTIONS)))
    _, tiny, _ = TC.from_config(TL.apply_options(TL.load_config(port_path(name)),
                                                 TL.parse_options(TINY_OPTIONS)), "pretrain")
    tiny = dataclasses.replace(tiny, dn_labelbook_size=13)
    got = init_params(tiny, 12, torch.Generator().manual_seed(0))
    want = jax_tree_shapes(jtiny)
    assert set(got) == set(want), (name, sorted(set(got) ^ set(want))[:6])
    assert all(tuple(got[k].shape) == want[k] for k in want), name


@pytest.mark.parametrize("option,match", [
    ("backbone=swin_X_224_1k", "backbone in"),
    ("param_dtype=bfloat16", "param_dtype = 'float32'"),
    ("batch_norm_type=LayerNorm", "batch_norm_type in"),
    ("encoder_type=sparse", "encoder_type in"),
], ids=["swin", "param_dtype", "unknown_norm", "unknown_encoder"])
def test_what_the_port_lacks_is_refused(option, match):
    cfg = TL.apply_options(TL.load_config(port_path("Latin.py")), TL.parse_options([option]))
    with pytest.raises(NotImplementedError, match=match):
        TC.from_config(cfg, "pretrain")
