"""The training recipes' settings: CTC finetuning (``RECIPE``) and the
detection pretraining that made every shipped trunk (``RECIPE_DETECTION``).

The data settings (``DataConfig``), shared by both recipes, are those of
the batches the shipped checkpoints trained on.

CTC finetuning:

The port's own copy of the values in outputs/finetune_r4b/config_cfg.py
(the run that finetuned the shipped Latin checkpoints), with the JAX
package's defaults where that file sets nothing (``steps_per_epoch``
1250 and ``warmup_steps`` 0, dtlr_tpu/train/optim.py:32-33; ``print_freq``
50, dtlr_tpu/train/engine.py:209). Its ``dropout = 0.0`` is the model's
(``DinoConfig.dropout``), as are the other architecture keys.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass
from typing import Optional, Tuple

from .. import config as cfg_lib
from ..models.convnext import CONVNEXT_CONFIGS
from ..models.dino import FLAGSHIP, DinoConfig
from ..models.resnet import NORM_NAMES, STAGES
from ..models.swin import SWIN_CONFIGS
from ..models.transformer import DECODER_CA, ENCODER_TYPES


@dataclass
class DataConfig:
    """``BucketBatcher``'s settings (data/batching.py) in the recipe."""

    data_aug_scales: Tuple[int, ...] = (128,)  # finetune_r4b/config_cfg.py:16, round4_chain.sh:52
    data_aug_max_size: int = 1024      # finetune_r4b/config_cfg.py:14, round4_chain.sh:52
    image_w_max: int = 1024            # finetune_r4b/config_cfg.py:51, round4_chain.sh:53
    image_h_max: Optional[int] = 192   # finetune_r4b/config_cfg.py:50, round4_chain.sh:53
    transfer_uint8: bool = True        # finetune_r4b/config_cfg.py:97, Latin_TPU.py:46
    truly_random_erasing: bool = False  # dtlr_tpu/train/pretrain.py:223 (unset in Latin.py)
    h_quant: int = 64                  # dtlr_tpu/data/batching.py:196 (never overridden)
    # the pretraining's sample reuse (synthetic_reuse, Latin_TPU.py:51);
    # the finetune passes none (dtlr_tpu/train/finetune.py:206-214)
    reuse: int = 1
    # the HWDB_synth stream (data/hwdb_synth.py): the label space's pickle
    # (else the glyph bank's characters) and the glyphs per line
    hwdb_charset_pickle: Optional[str] = None
    hwdb_glyphs_per_line: Optional[Tuple[int, ...]] = None
    # the Latin renderer's streams (data/synthetic.py; the keys of
    # dtlr_tpu/train/pretrain.py:103-173, finetune.py:90-160,
    # eval/evaluate.py:194-220): None where the JAX entry points default
    # differently (``synth_defaults``)
    plain_background: bool = False
    synthetic_max_words: Optional[int] = None
    synthetic_charset: str = "default"
    synthetic_background_dir: Optional[str] = None
    synthetic_font_dict: Optional[str] = None
    synthetic_font_root: str = ""
    synthetic_corpus_dir: Optional[str] = None
    synthetic_language: str = "en"
    synthetic_reference_text: bool = False
    synthetic_corpus_file: Optional[str] = None
    synthetic_corpus_val_file: Optional[str] = None
    synthetic_corpus_prob: Optional[float] = None


@dataclass
class TrainConfig(DataConfig):
    batch_size: int = 8
    epochs: int = 2
    max_iterations: int = 6000
    eval_epoch: int = 1
    print_freq: int = 50
    max_targets: int = 64
    # optimizer (dtlr_tpu/train/optim.py)
    lr: float = 1e-5
    lr_backbone: float = 1e-10
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.01
    # schedule: StepLR x0.1 at lr_drop epochs, or multistep / onecycle
    lr_drop: int = 11
    steps_per_epoch: int = 1250
    warmup_steps: int = 0
    multi_step_lr: bool = False
    lr_drop_list: Tuple[int, ...] = (33, 45)
    onecyclelr: bool = False
    # the CTC step (dtlr_tpu/train/train_step.py:109-150)
    ctc_eps: float = 0.003
    CTC_loss_coef: float = 1.0
    use_ema: bool = False
    ema_decay: float = 0.9997
    # held-out lines of a generated stream (dtlr_tpu/train/finetune.py:193)
    eval_set_size: int = 64


RECIPE = TrainConfig()


@dataclass
class PretrainConfig(DataConfig):
    """The detection pretraining recipe that made ``artifacts/r4run_params.npz``
    (scripts/round4_chain.sh:43-56 on dtlr_tpu/configs/Latin_TPU.py and its
    base Latin.py). Each value's source is beside it. The model's CDN
    settings and target capacity are ``DinoConfig``'s (models/dino.py)."""

    batch_size: int = 8                # round4_chain.sh:51
    epochs: int = 400                  # round4_chain.sh:49
    steps_per_epoch: int = 500         # round4_chain.sh:48
    print_freq: int = 50               # dtlr_tpu/train/engine.py:209
    max_targets: int = 64              # round4_chain.sh:52
    # optimizer (dtlr_tpu/train/optim.py)
    lr: float = 1e-4                   # Latin.py:9
    lr_backbone: float = 1e-4          # Latin_TPU.py:19, round4_chain.sh:55
    weight_decay: float = 1e-4         # Latin.py:16
    clip_max_norm: float = 0.1         # Latin.py:20
    lr_drop: int = 50000               # round4_chain.sh:54 (no drop in the run)
    warmup_steps: int = 200            # round4_chain.sh:51
    multi_step_lr: bool = False        # Latin.py:22
    lr_drop_list: Tuple[int, ...] = (33, 45)  # Latin.py:23
    onecyclelr: bool = False           # Latin.py:21
    use_ema: bool = True               # round4_chain.sh:51
    reuse: int = 4                     # synthetic_reuse, Latin_TPU.py:51
    ema_decay: float = 0.9997          # Latin.py:86
    # matcher (dtlr_tpu/ops/matcher.py) and loss (dtlr_tpu/losses/criterion.py)
    matcher_impl: str = "jax"          # Latin.py:99, the auction
    set_cost_class: float = 2.0        # Latin.py:65
    set_cost_bbox: float = 5.0         # Latin.py:66
    set_cost_giou: float = 2.0         # Latin.py:67
    cls_loss_coef: float = 1.0         # Latin.py:68
    bbox_loss_coef: float = 5.0        # Latin.py:69
    giou_loss_coef: float = 2.0        # Latin.py:70
    focal_alpha: float = 0.25          # Latin.py:74
    # the loss weights (losses/criterion.py build_weight_dict)
    aux_loss: bool = True              # Latin.py:50
    two_stage_type: str = "standard"   # Latin.py:45
    interm_loss_coef: float = 1.0      # Latin.py:72
    no_interm_box_loss: bool = False   # Latin.py:73
    # the loop (dtlr_tpu/train/pretrain.py:233-295)
    ctc_eps: float = 0.003             # Latin.py:101, the evaluation's CTC loss
    eval_set_size: int = 200           # round4_chain.sh:53
    save_checkpoint_interval: int = 20  # round4_chain.sh:54


RECIPE_DETECTION = PretrainConfig()


def _parse_value(text: str, kind):
    if typing.get_origin(kind) is typing.Union:  # Optional[int]
        if text.lower() == "none":
            return None
        kind = typing.get_args(kind)[0]
    if kind is bool:
        if text.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"not a bool: {text!r}")
        return text.lower() in ("true", "1")
    if typing.get_origin(kind) is tuple:
        item = typing.get_args(kind)[0]
        return tuple(item(v.strip().strip("'\"")) for v in text.strip("()[]").split(",")
                     if v.strip())
    return kind(text)


def apply_options(train_cfg, model_cfg, options):
    """``key=value`` strings onto the training settings (a ``TrainConfig``
    or ``PretrainConfig``) and the model's ``DinoConfig``; each key belongs
    to one of them, an unknown key raises."""
    train_hints = typing.get_type_hints(type(train_cfg))
    model_hints = typing.get_type_hints(type(model_cfg))
    train_kw, model_kw = {}, {}
    for opt in options or ():
        key, _, value = opt.partition("=")
        if key in train_hints:
            train_kw[key] = _parse_value(value, train_hints[key])
        elif key in model_hints:
            model_kw[key] = _parse_value(value, model_hints[key])
        else:
            raise KeyError(f"unknown option {key!r}")
    return dataclasses.replace(train_cfg, **train_kw), dataclasses.replace(model_cfg, **model_kw)


# ------------------------------------------------------------ config files

#: fields whose config key has another name
_KEY_OF_FIELD = {"reuse": "synthetic_reuse", "shared_offsets": "deform_shared_offsets",
                 "norm_kind": "batch_norm_type", "pe_temperature_h": "pe_temperatureH",
                 "pe_temperature_w": "pe_temperatureW"}
#: keys a CTC finetune does not take: dtlr_tpu/train/finetune.py:206-214
#: passes the batcher no reuse pool and no erasing
_NOT_IN_FINETUNE = ("synthetic_reuse", "truly_random_erasing")
#: keys that the JAX package reads with a default, and that default
#: (dtlr_tpu/models/dino.py:334-364, train/optim.py:40-97, train/pretrain.py
#: and finetune.py, losses/criterion.py:199-219)
JAX_DEFAULTS = {
    "max_targets": 256, "image_w_max": 1344, "image_h_max": None, "transfer_uint8": False,
    "truly_random_erasing": False, "synthetic_reuse": 1, "hwdb_charset_pickle": None,
    "hwdb_glyphs_per_line": None, "plain_background": False, "synthetic_max_words": None,
    "synthetic_charset": "default", "synthetic_background_dir": None,
    "synthetic_font_dict": None, "synthetic_font_root": "", "synthetic_corpus_dir": None,
    "synthetic_language": "en", "synthetic_reference_text": False,
    "synthetic_corpus_file": None, "synthetic_corpus_val_file": None,
    "synthetic_corpus_prob": None, "steps_per_epoch": 1250, "warmup_steps": 0,
    "onecyclelr": False, "multi_step_lr": False, "lr_drop_list": (33, 45),
    "weight_decay": 1e-4, "clip_max_norm": 0.1, "use_ema": False, "ema_decay": 0.9997,
    "matcher_impl": "jax", "set_cost_class": 2.0, "set_cost_bbox": 5.0, "set_cost_giou": 2.0,
    "focal_alpha": 0.25, "ctc_eps": 0.003, "CTC_loss_coef": 1.0, "aux_loss": True,
    "two_stage_type": "standard", "interm_loss_coef": 1.0, "no_interm_box_loss": False,
    "max_iterations": 2500, "eval_epoch": 10, "save_checkpoint_interval": 100,
    "compute_dtype": "float32", "use_dn": True, "dn_number": 100, "dn_box_noise_scale": 0.4,
    "dn_label_noise_ratio": 0.5, "encoder_win": 32,
    # the architecture (dtlr_tpu/models/dino.py:348-360): the reference's
    "encoder_type": "deformable", "decoder_ca": "deform", "dense_box_bias": False,
    "deform_shared_offsets": False, "batch_norm_type": "FrozenBatchNorm2d",
    "decoder_module_seq": ("sa", "ca", "ffn"), "pe_temperatureH": 20.0,
    "pe_temperatureW": 20.0,
}
#: the held-out set's default size per kind (pretrain.py:232, finetune.py:193)
_EVAL_SET_SIZE = {"ctc": 64, "pretrain": 200}
#: settings' keys that the JAX package reads without a default
REQUIRED = ("num_queries", "hidden_dim", "nheads", "enc_layers", "dec_layers",
            "dim_feedforward", "lr", "lr_backbone", "lr_drop", "epochs", "batch_size",
            "data_aug_scales", "data_aug_max_size", "cls_loss_coef", "bbox_loss_coef",
            "giou_loss_coef", "backbone", "enc_n_points", "dec_n_points",
            "num_feature_levels", "dropout")
#: the architecture's keys that ``DinoConfig`` reads and the values the
#: port's modules accept (dtlr_tpu/models/transformer.py:299-307,
#: resnet.py:52-57, dino.py:123-141)
ACCEPTED = {
    "encoder_type": ENCODER_TYPES,
    "decoder_ca": DECODER_CA,
    "batch_norm_type": tuple(NORM_NAMES),
    "backbone": tuple(STAGES) + tuple(SWIN_CONFIGS) + tuple(CONVNEXT_CONFIGS),
}
#: the rest of the architecture, which the port has at one value only, as
#: JAX has (key, that value, JAX's default where the key is absent)
ARCHITECTURE = {
    "param_dtype": ("float32", "float32"),
}
KINDS = {"ctc": TrainConfig, "pretrain": PretrainConfig}


def _coerce(value, kind):
    if typing.get_origin(kind) is typing.Union:  # Optional[...]
        if value is None:
            return None
        kind = typing.get_args(kind)[0]
    if typing.get_origin(kind) is tuple:
        return tuple(typing.get_args(kind)[0](v) for v in value)
    if kind is float:
        return float(value)
    if kind is int and not isinstance(value, bool):
        return int(value)
    if not isinstance(value, kind):
        raise TypeError(f"expected {kind.__name__}, got {value!r}")
    return value


def check_architecture(cfg) -> None:
    """Refuse a config whose model the port does not have: a backbone,
    encoder, cross-attention or norm that JAX's modules do not know, or
    another value of a key in ``ARCHITECTURE`` (the parameter dtype)."""
    for key, accepted in ACCEPTED.items():
        value = cfg[key] if key in cfg else JAX_DEFAULTS.get(key)
        if value is None:
            raise KeyError(f"the config has no {key!r}")
        if value not in accepted:
            raise NotImplementedError(
                f"{key} = {value!r}: the port has {key} in {accepted}")
    for key, (want, default) in ARCHITECTURE.items():
        value = cfg[key] if key in cfg else default
        if key not in cfg and default is None:
            raise KeyError(f"the config has no {key!r}")
        if (list(value) if isinstance(value, (list, tuple)) else value) != want:
            raise NotImplementedError(
                f"{key} = {value!r}: the port's modules have {key} = {want!r} only")


def from_config(cfg, kind: str):
    """A loaded config (``config.load_config``, options applied) as the
    port's settings: the ``TrainConfig`` (``kind="ctc"``) or
    ``PretrainConfig`` (``kind="pretrain"``), the model's ``DinoConfig``,
    and the sorted keys that neither reads, which the caller logs.

    A key the config lacks takes the JAX package's default for it;
    ``dn_labelbook_size`` stays None: it follows the class count, which
    the charset sets (``labelbook_offset``). Raises on a key that the JAX
    package requires and on an architecture the port does not have."""
    check_architecture(cfg)
    train_cls = KINDS[kind]
    read = set(ARCHITECTURE) | {"num_classes", "dn_labelbook_size"}

    def values(cls, skip=()):
        out = {}
        for f in dataclasses.fields(cls):
            key = _KEY_OF_FIELD.get(f.name, f.name)
            if key in skip or f.name == "dn_labelbook_size":
                continue
            if key == "eval_set_size":
                default = _EVAL_SET_SIZE[kind]
            elif key in JAX_DEFAULTS:
                default = JAX_DEFAULTS[key]
            elif key in REQUIRED:
                if key not in cfg:
                    raise KeyError(f"the config has no {key!r}")
                default = None
            elif key in cfg:  # the port's own settings (print_freq, h_quant)
                default = None
            else:
                continue
            hint = typing.get_type_hints(cls)[f.name]
            out[f.name] = _coerce(cfg[key] if key in cfg else default, hint)
            read.add(key)
        return out

    train = train_cls(**values(train_cls, _NOT_IN_FINETUNE if kind == "ctc" else ()))
    model = DinoConfig(**values(DinoConfig))
    return train, model, sorted(set(cfg) - read)


#: the renderer's keys (``DataConfig``'s fields of the same names)
SYNTH_KEYS = ("plain_background", "synthetic_max_words", "synthetic_charset",
              "synthetic_background_dir", "synthetic_font_dict", "synthetic_font_root",
              "synthetic_corpus_dir", "synthetic_language", "synthetic_reference_text",
              "synthetic_corpus_file", "synthetic_corpus_val_file", "synthetic_corpus_prob")
#: the JAX entry points' defaults of the renderer's keys that differ:
#: (synthetic_max_words, synthetic_corpus_prob)
SYNTH_DEFAULTS = {"pretrain": (30, 0.5), "finetune": (8, 0.7), "evaluate": (8, 0.5)}


def synth_defaults(cfg, entry: str):
    """(max words, corpus probability) of ``cfg`` (a ``DataConfig``) for
    the JAX entry point ``entry``, its own defaults where the keys are
    absent."""
    words, prob = SYNTH_DEFAULTS[entry]
    return (words if cfg.synthetic_max_words is None else cfg.synthetic_max_words,
            prob if cfg.synthetic_corpus_prob is None else cfg.synthetic_corpus_prob)


def labelbook_offset(cfg) -> int:
    """The CDN label book's size less the class count, which the config
    family keeps when the charset sets the class count: 1 for Latin
    (Latin.py), 0 for Chinese (Chinese.py), as dtlr_tpu/train/pretrain.py:
    201-212 keeps it."""
    return cfg.get_default("dn_labelbook_size", cfg["num_classes"] + 1) - cfg["num_classes"]


def to_config(train_cfg, model_cfg, num_classes: int, labelbook_size: int) -> dict:
    """The settings of a run without a config file as the keys of one
    (the architecture's, the class count's, then each field's), for the
    run's dumped ``config_cfg.py``; ``from_config`` reads them back."""
    cfg = {k: v for k, (v, _) in ARCHITECTURE.items()}
    cfg.update(num_classes=num_classes, dn_labelbook_size=labelbook_size)
    # DinoConfig's fields below carry the rest of the architecture
    for obj in (train_cfg, model_cfg):
        for f in dataclasses.fields(obj):
            if f.name == "dn_labelbook_size":
                continue
            value = getattr(obj, f.name)
            cfg[_KEY_OF_FIELD.get(f.name, f.name)] = list(value) if isinstance(value, tuple) else value
    return cfg


def load_settings(config_file: Optional[str], options, kind: str):
    """An entry point's settings: with ``config_file`` (a config file or a
    run's dumped ``config_cfg.py``) the config with ``options`` (JAX's
    ``key=value`` overrides of its keys) applied, through ``from_config``;
    without one the recipe of ``kind`` (``RECIPE`` or
    ``RECIPE_DETECTION``) and ``FLAGSHIP``, ``options`` overriding their
    fields. Returns the training settings, the model's ``DinoConfig``,
    the config (None without a file) and the keys the port does not read."""
    if config_file is None:
        train, model = apply_options(RECIPES[kind], FLAGSHIP, options)
        return train, model, None, []
    cfg = cfg_lib.apply_options(cfg_lib.load_config(config_file),
                                cfg_lib.parse_options(options))
    train, model, unread = from_config(cfg, kind)
    return train, model, cfg, unread


RECIPES = {"ctc": RECIPE, "pretrain": RECIPE_DETECTION}


def dump_run_config(path: str, cfg, train_cfg, model_cfg, num_classes: int,
                    labelbook_size: int) -> None:
    """A run's ``config_cfg.py`` in the JAX package's dump format: the
    config (or, without one, ``to_config`` of the settings) with the run's
    epochs, steps per epoch and the class count its charset set, which
    ``evaluate --config`` and a finetune from the run read back."""
    if cfg is None:
        out = to_config(train_cfg, model_cfg, num_classes, labelbook_size)
    else:
        out = dict(cfg, epochs=train_cfg.epochs, num_classes=num_classes,
                   dn_labelbook_size=labelbook_size)
        if hasattr(train_cfg, "steps_per_epoch"):
            out["steps_per_epoch"] = train_cfg.steps_per_epoch
    cfg_lib.dump_config(out, path)
