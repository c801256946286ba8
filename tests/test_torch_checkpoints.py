"""The port's checkpoints (dtlr_tpu_torch/train/checkpoints.py) against
dtlr_tpu/train/checkpoints.py: npz snapshots that each package reads
from the other, the charset mapping and the class-head surgery, and a
train state saved and resumed.

Exact where the operation is a copy: npz leaves round-trip bit for bit
(float32, and float16 as the shipped checkpoints store them), mapped
rows of the surgery equal JAX's. The rows that the surgery draws anew
come from different generators in the two packages, so they are held
by shape, dtype and spread (N(0, 0.02)).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dtlr_tpu.data.charset import load_default_charset as jax_default_charset
from dtlr_tpu.data.charset import resolve_synthetic_charset as jax_synthetic_charset
from dtlr_tpu.train import checkpoints as jax_ckpt
from dtlr_tpu_torch.data.charset import load_default_charset, resolve_synthetic_charset
from dtlr_tpu_torch.models.dino import FLAGSHIP, build_dino
from dtlr_tpu_torch.train import checkpoints as ckpt
from dtlr_tpu_torch.train.config import RECIPE
from dtlr_tpu_torch.train.engine import Trainer
from dtlr_tpu_torch.weights import load_into, params_from_npz
from test_torch_grad_stops import flat
from test_torch_model import NUM_CLASSES, TINY, jax_tiny, make_lines, perturbed_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4FT = os.path.join(REPO, "artifacts", "r4ft_params.npz")
R4RUN_EMA = os.path.join(REPO, "artifacts", "r4run_params_ema.npz")


@pytest.fixture(scope="module")
def tiny_tree():
    images, valid_hw = make_lines()
    return perturbed_params(jax_tiny(False), images, valid_hw)


def test_jax_export_port_export_jax_load(tiny_tree, tmp_path):
    """JAX writes, the port reads and writes, JAX reads back the tree it
    wrote, bit for bit (float32)."""
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.export_params_npz(tiny_tree, a, dtype=None)
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, ckpt.load_params_npz(a))
    ckpt.export_params_npz(port, b, dtype=None)
    back = flat(jax_ckpt.load_params_npz(b))
    want = flat(tiny_tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_port_export_jax_export_float16(tiny_tree, tmp_path):
    """The port's float16 export holds the same arrays as JAX's float16
    export of the same parameters; the port reads JAX's."""
    a, b = str(tmp_path / "jax16.npz"), str(tmp_path / "port16.npz")
    jax_ckpt.export_params_npz(tiny_tree, a)
    port = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port, tiny_tree)
    ckpt.export_params_npz(port, b)
    with np.load(a) as ja, np.load(b) as pa:
        assert sorted(ja.files) == sorted(pa.files)
        for k in ja.files:
            assert pa[k].dtype == ja[k].dtype == np.float16
            np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    port2 = build_dino(TINY, NUM_CLASSES, device="cpu")
    load_into(port2, ckpt.load_params_npz(a))
    for (n, p), q in zip(port2.named_parameters(), port.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      q.detach().numpy().astype(np.float16).astype(np.float32),
                                      err_msg=n)


def test_flagship_checkpoint_round_trips(tmp_path):
    """r4ft_params.npz through the flagship model and back: all 474
    float16 leaves equal, with the file's keys and shapes."""
    out = str(tmp_path / "r4ft.npz")
    model = build_dino(FLAGSHIP, 65, device="cpu")
    load_into(model, params_from_npz(R4FT))
    ckpt.export_params_npz(model, out)
    with np.load(R4FT) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files) and len(want.files) == 474
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_charsets_are_jax_copies():
    assert load_default_charset() == jax_default_charset()
    assert resolve_synthetic_charset("no_accent_space") == jax_synthetic_charset("no_accent_space")


@pytest.mark.parametrize("pair", ["default_to_no_accent", "no_accent_to_default", "reversed"])
def test_smart_mapping_rows_exact(pair):
    old, new = {"default_to_no_accent": (load_default_charset(),
                                         resolve_synthetic_charset("no_accent_space")),
                "no_accent_to_default": (resolve_synthetic_charset("no_accent_space"),
                                         load_default_charset()),
                "reversed": (load_default_charset(), load_default_charset()[::-1])}[pair]
    got = ckpt.smart_mapping_rows(old, new)
    want = jax_ckpt.smart_mapping_rows(old, new)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("smart", [True, False], ids=["smart_mapping", "all_new"])
def test_surgery_on_pretrained_checkpoint(smart):
    """r4run_params_ema.npz (166 classes) to the 65 of the Latin lines,
    as outputs/finetune_r4b/info.txt did: the rows that the mapping
    copies equal JAX's, the rest are fresh N(0, 0.02) draws of the same
    shape, the biases the focal prior."""
    old, new = load_default_charset(), resolve_synthetic_charset("no_accent_space")
    tree = ckpt.load_params_npz(R4RUN_EMA)
    assert tree["params/class_embed/fc/kernel"].shape == (256, 166)
    got = ckpt.surgery_class_heads(tree, old, new, torch.Generator().manual_seed(0),
                                   smart_mapping=smart)
    want = flat(jax_ckpt.surgery_class_heads(jax_ckpt.load_params_npz(R4RUN_EMA), old, new,
                                             jax.random.PRNGKey(0), smart_mapping=smart))
    assert set(got) == set(want)
    mapping = ckpt.smart_mapping_rows(old, new)
    mapped = mapping >= 0 if smart else np.zeros(len(new), bool)
    assert mapped.sum() == (65 if smart else 0)  # the default charset has all 65
    for head in ("class_embed", "enc_out_class_embed"):
        k, b = f"params/{head}/fc/kernel", f"params/{head}/fc/bias"
        assert got[k].shape == want[k].shape == (256, 65) and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k][:, mapped], want[k][:, mapped])
        np.testing.assert_array_equal(got[b], want[b])
        if not smart:
            fresh = got[k]
            assert 0.015 < fresh.std() < 0.025 and abs(fresh.mean()) < 0.005
    lk = "params/label_enc"
    assert got[lk].shape == want[lk].shape == (67, 256)
    np.testing.assert_array_equal(got[lk][:65][mapped], want[lk][:65][mapped])
    fresh = got[lk][65:] if smart else got[lk]  # the two rows past the classes are always new
    assert 0.015 < fresh.std() < 0.025 and abs(fresh.mean()) < 0.005
    for k in want:  # everything else untouched
        if "class_embed" not in k and k != lk:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_dino(dataclasses.replace(FLAGSHIP, dn_labelbook_size=66), 65, device="cpu")
    load_into(model, got)


def _tiny_trainer(tmp_path, tree, head_only=False):
    cfg = dataclasses.replace(RECIPE, use_ema=True, lr=1e-3, batch_size=2, print_freq=1)
    t = Trainer(cfg, TINY, str(tmp_path), device="cpu")
    t.build(flat(tree), head_only=head_only)
    return t


def _batch(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, (2, 5)).astype(np.int32)
    return {"images": rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8),
            "valid_hw": np.asarray([[64, 128], [50, 93]], np.int32), "labels": labels,
            "valid": np.ones((2, 5), bool), "texts": ["", ""]}


def test_train_state_save_and_resume(tiny_tree, tmp_path):
    """Two steps, save, a fresh trainer resumes: parameters, moments,
    count, step, EMA and epoch as saved; one more step on each trainer
    lands on the same parameters."""
    t = _tiny_trainer(tmp_path, tiny_tree)
    t.train_epoch([_batch(0), _batch(1)])
    t.save()
    assert ckpt.latest_step(str(tmp_path / "checkpoint")) == 2
    r = _tiny_trainer(tmp_path, tiny_tree)
    assert r.try_resume()
    assert r.state.step == 2 and r.epoch == 1 and r.state.optimizer.state["count"] == 2
    for (n, p), q in zip(t.state.model.named_parameters(), r.state.model.parameters()):
        assert torch.equal(p, q), n
    for key in ("mu", "nu"):
        for n, v in t.state.optimizer.state[key].items():
            assert torch.equal(v, r.state.optimizer.state[key][n]), (key, n)
    for n, v in t.state.ema.items():
        assert torch.equal(v, r.state.ema[n]), n
    t.train_epoch([_batch(2)])
    r.train_epoch([_batch(2)])
    for (n, p), q in zip(t.state.model.named_parameters(), r.state.model.parameters()):
        assert torch.equal(p, q), n


def test_resume_across_stages_keeps_fresh_optimizer(tiny_tree, tmp_path):
    """A head-only run's checkpoint resumed by the full-model optimizer:
    parameters, step and epoch restored, the optimizer fresh, EMA seeded
    from the restored parameters."""
    t = _tiny_trainer(tmp_path, tiny_tree, head_only=True)
    t.train_epoch([_batch(0)])
    t.save()
    r = _tiny_trainer(tmp_path, tiny_tree, head_only=False)
    assert r.try_resume()
    assert r.state.step == 1 and r.state.optimizer.state["count"] == 0
    for (n, p), q in zip(t.state.model.named_parameters(), r.state.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(r.state.ema[n], q), n


def test_checkpoints_keep_the_newest(tmp_path):
    for step in range(7):
        ckpt.save_checkpoint(str(tmp_path), step, {"step": step}, max_to_keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 6
    assert sorted(os.listdir(tmp_path)) == [f"state_{s:08d}.pt" for s in (4, 5, 6)]
    assert ckpt.restore_checkpoint(str(tmp_path), 5) == {"step": 5}
    assert ckpt.restore_checkpoint(str(tmp_path / "none")) is None
