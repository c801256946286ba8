"""weights.py carries every flax leaf into the port, and the port keeps
to its rules: no JAX, flax, optax, PIL or dtlr_tpu import, and entry
points that run on the card unless the caller asks for the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.eval import evaluate
from dtlr_tpu_torch.train import finetune
from dtlr_tpu_torch.models.dino import FLAGSHIP, build_dino
from dtlr_tpu_torch.weights import load_into, load_jax_params, params_from_npz
from test_torch_model import NUM_CLASSES, TINY, jax_tiny, make_lines, perturbed_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
FIXTURE = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "PIL", "dtlr_tpu")


def _leaf_paths(tree, prefix=""):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}/{k}" if prefix else k)]


def test_tiny_flax_init_fits_exactly():
    images, valid_hw = make_lines()
    params = perturbed_params(jax_tiny(False), images, valid_hw)
    sd = load_jax_params(params)
    assert len(sd) == len(_leaf_paths(params))
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, params)
    own = port.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k], v), k


def test_load_into_raises_on_missing_and_unused_leaves():
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    tree = {"params/" + k.replace(".", "/"): v for k, v in _torch_as_flax(port).items()}
    load_into(port, tree)
    missing = dict(tree)
    missing.pop("params/transformer/tgt_embed")
    with pytest.raises(KeyError, match="missing"):
        load_into(port, missing)
    extra = dict(tree, **{"params/transformer/unused/bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        load_into(port, extra)
    bad = dict(tree, **{"params/transformer/tgt_embed": np.zeros((3, 32), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_into(port, bad)


def _torch_as_flax(model):
    """Leaves of a port model written back in flax layout (1-d leaves
    and conv / dense kernels), enough to round-trip the loader."""
    out = {}
    for k, v in model.state_dict().items():
        x = v.numpy()
        if k.endswith(".weight") and x.ndim == 4:
            k, x = k[:-6] + "kernel", x.transpose(2, 3, 1, 0)
        elif k.endswith(".weight") and x.ndim == 2:
            k, x = k[:-6] + "kernel", x.T
        elif k.endswith(".weight"):
            k = k[:-6] + "scale"
        out[k] = x
    return out


def test_flagship_checkpoint_fits_exactly():
    """All 474 leaves of r4ft_params.npz (float16) land in the flagship
    model with 65 classes, as float32."""
    tree = params_from_npz(PARAMS)
    assert len(tree) == 474
    assert all(v.dtype == np.float16 for v in tree.values())
    assert tree["params/class_embed/fc/kernel"].shape == (256, 65)
    model = build_dino(FLAGSHIP, 65, device="cpu")
    load_into(model, tree)
    sd = model.state_dict()
    assert len(sd) == 474 and all(v.dtype == torch.float32 for v in sd.values())
    q = tree["params/transformer/decoder_layer_0/cross_attn/q_proj/kernel"]  # (C, M, D)
    np.testing.assert_array_equal(
        sd["transformer.decoder_layer_0.cross_attn.q_proj.weight"].numpy(),
        q.astype(np.float32).reshape(256, 256).T)
    o = tree["params/transformer/decoder_layer_0/cross_attn/out_proj/kernel"]  # (M, D, C)
    np.testing.assert_array_equal(
        sd["transformer.decoder_layer_0.cross_attn.out_proj.weight"].numpy(),
        o.astype(np.float32).reshape(256, 256).T)
    qk = tree["params/transformer/encoder_layer_0/qk/kernel"]  # (C, 2, C)
    np.testing.assert_array_equal(
        sd["transformer.encoder_layer_0.qk.weight"].numpy(),
        qk.astype(np.float32).reshape(256, 512).T)
    conv = tree["params/backbone_net/conv1/kernel"]  # HWIO
    np.testing.assert_array_equal(sd["backbone_net.conv1.weight"].numpy(),
                                  conv.astype(np.float32).transpose(3, 2, 0, 1))


def _port_sources():
    pkg = os.path.join(REPO, "dtlr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_pil_or_dtlr_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_import_scan_covers_every_module():
    """The scan above reads every module of the package, the n-gram
    decoder's, the Swin and ConvNeXt backbones' and the LM rescorer's among
    them."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {f"dtlr_tpu_torch/{m}.py" for m in (
        "ngram/lm_decode", "ngram/preprocessing", "ngram/rescore", "models/swin",
        "models/convnext", "models/lm_rescorer")} <= scanned


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dino(TINY, NUM_CLASSES)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.load_model(PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--params", PARAMS, "--lines", "unused.npz"])
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main(["--lines", FIXTURE, "--pretrain_dir", PARAMS, "--full_model",
                       "--output_dir", str(tmp_path)])
    assert next(build_dino(TINY, NUM_CLASSES, device="cpu").parameters()).device.type == "cpu"


#: every checkpoint the repository ships; all share the flagship recipe's
#: geometry and differ in classes (65, 166, 7356) and label book size
SHIPPED = ("hwdb_ft_params", "hwdb_ft_params_ema", "hwdb_v3_20k", "hwdb_v3_20k_ema",
           "r4ft_params", "r4run_params", "r4run_params_ema", "r5_bigscale_1k",
           "r5_bigscale_5k")


def test_shipped_checkpoints_are_listed():
    names = sorted(f[:-4] for f in os.listdir(os.path.join(REPO, "artifacts"))
                   if f.endswith(".npz"))
    assert tuple(names) == SHIPPED


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_checkpoint_loads(name):
    """Strict load (no leaf missing, unused or misshapen) with the class
    count and the label encoder's rows read from the checkpoint."""
    path = os.path.join(REPO, "artifacts", f"{name}.npz")
    tree = params_from_npz(path)
    model = evaluate.load_model(path, device="cpu")
    assert model.num_classes == tree["params/class_embed/fc/kernel"].shape[-1]
    assert tuple(model.label_enc.shape) == tree["params/label_enc"].shape
    assert model.cfg.dn_labelbook_size == tree["params/label_enc"].shape[0] - 1
    assert model.cfg.compute_dtype == "bfloat16"


@pytest.mark.slow
def test_port_reads_fixture_with_hwdb_checkpoint_like_jax():
    """The Chinese checkpoint (7356 classes, label book 7356) on the CPU
    reads the fixture's lines to the same labels as the JAX package in
    float32. The HWDB charset lives outside the repository, so labels
    are compared through a stand-in charset with one distinct character
    per class. Gates as the flagship's float32 test: labels exact, and
    per query boxes and max logits within 1e-3 on the lines whose
    selection is JAX's, any other selection from a score gap under 1e-3."""
    from test_torch_smoke_fixture import FIXTURE, NMS, TH, jax_reading

    path = os.path.join(REPO, "artifacts", "hwdb_ft_params.npz")
    cfg = os.path.join(REPO, "outputs", "hwdb_ft", "config_cfg.py")
    lines = evaluate.load_lines(FIXTURE)
    lines["charset"] = [chr(0x4E00 + i) for i in range(7356)]
    ref = jax_reading(lines["images"], lines["valid_hw"], lines["charset"], path, cfg,
                      batch_size=4)
    model = evaluate.load_model(path, device="cpu", compute_dtype="float32")
    res = evaluate.read_lines(model, lines, TH, NMS, batch_size=2)
    a = evaluate.agreement(res, ref)
    assert res["greedy"] == ref["jax_greedy"], a
    assert res["nms"] == ref["jax_nms"], a
    assert a["lines_compared"] >= len(lines["texts"]) // 2, a
    assert a["max_swap_score_gap"] < 1e-3, a
    assert a["max_pred_boxes_err"] < 1e-3, a
    assert a["max_logit_err"] < 1e-3, a
