"""The reference's torch checkpoints in and out of the port
(dtlr_tpu_torch/train/torch_import.py) against the JAX package's map
(dtlr_tpu/train/torch_import.py), at the tiny geometry of
``Latin.py``'s architecture (test_torch_deform_model.py's weights).

- JAX's ``export_torch_state`` of a tree goes through the port's
  ``import_torch_state`` into the port's fresh tree, and gives exactly
  the tree (every leaf, bit for bit), so ``load_into`` a model gives the
  model of the same tree.
- The port's ``export_torch_state`` of the tree is JAX's, name for name
  and bit for bit, and reads back to the tree.
- A ``.pth`` saved as the reference saves (``{"model": ...}``, and with
  DataParallel's ``module.`` prefixes) loads through
  ``load_params_file`` to the tree; one of another architecture
  (GroupNorm backbone expected) is refused; the warm start from it into
  the flagship's architecture copies what fits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dtlr_tpu.train import torch_import as J
from dtlr_tpu_torch.models.dino import build_dino
from dtlr_tpu_torch.train import torch_import as T
from dtlr_tpu_torch.train.init import init_params
from dtlr_tpu_torch.weights import load_into
from test_torch_deform_model import port_cfg, seeded_params
from test_torch_model import NUM_CLASSES, TINY


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.fixture(scope="module")
def trees():
    """The seeded tree of Latin.py's architecture (nested and flat), JAX's
    export of it, and a fresh port tree of the same architecture."""
    nested = seeded_params("latin")
    cfg = dataclasses.replace(port_cfg("latin"), dn_labelbook_size=NUM_CLASSES + 1)
    fresh = init_params(cfg, NUM_CLASSES, torch.Generator().manual_seed(5))
    sd = J.export_torch_state(nested, n_heads=TINY.nheads, d_model=TINY.hidden_dim)
    return nested, flat(nested), sd, fresh, cfg


def test_jax_export_imports_to_the_same_tree(trees):
    _, tree, sd, fresh, _ = trees
    got, missing, unfilled = T.import_torch_state(fresh, sd, n_heads=TINY.nheads, strict=True)
    assert missing == [] and unfilled == 0
    assert set(got) == set(tree)
    assert all(np.array_equal(got[k], tree[k]) for k in tree)
    a = build_dino(port_cfg("latin"), NUM_CLASSES, device="cpu")
    b = build_dino(port_cfg("latin"), NUM_CLASSES, device="cpu")
    load_into(a, got)
    load_into(b, tree)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_port_export_is_jax_s_and_round_trips(trees):
    _, tree, sd, fresh, _ = trees
    got = T.export_torch_state(tree, n_heads=TINY.nheads)
    assert set(got) == set(sd)
    assert all(np.array_equal(got[k], sd[k]) for k in sd)
    back, missing, unfilled = T.import_torch_state(fresh, got, n_heads=TINY.nheads)
    assert not missing and unfilled == 0
    assert all(np.array_equal(back[k], tree[k]) for k in tree)
    # JAX's import of the port's export fills JAX's tree alike
    jtree, jmissing, junfilled = J.import_torch_state(
        {"params": {k: v for k, v in trees[0]["params"].items()}}, got,
        n_heads=TINY.nheads, d_model=TINY.hidden_dim)
    assert not jmissing and junfilled == 0
    assert all(np.array_equal(v, tree[k]) for k, v in flat(jtree).items())


@pytest.mark.parametrize("prefix", ["", "module."])
def test_pth_file_loads_to_the_tree(trees, tmp_path, prefix):
    _, tree, sd, _, cfg = trees
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {prefix + k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, "epoch": 3}, path)
    got = T.load_params_file(path, port_cfg("latin"))
    assert set(got) == set(tree) and all(np.array_equal(got[k], tree[k]) for k in tree)
    T.save_torch_checkpoint(tree, str(tmp_path / "port.pth"), TINY.nheads)
    again = T.load_torch_checkpoint(str(tmp_path / "port.pth"))
    assert set(again) == set(sd) and all(np.array_equal(again[k], sd[k]) for k in sd)


def test_other_architecture_is_refused_and_warm_started(trees, tmp_path):
    _, tree, sd, _, _ = trees
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, path)
    flagship = dataclasses.replace(TINY, dn_labelbook_size=NUM_CLASSES + 1)
    with pytest.raises(KeyError, match="does not fill"):
        T.load_params_file(path, flagship)
    fresh = init_params(flagship, NUM_CLASSES, torch.Generator().manual_seed(0))
    merged, counts = T.merge_params_file(fresh, path, TINY.nheads)
    copied = [k for k in merged if merged[k] is not fresh[k]]
    assert counts["copied"] == len(copied) and counts["fresh"] == len(fresh) - len(copied)
    # the backbone's convolutions, the input projections, the heads, the
    # label encoder and the decoders' self-attention and FFNs fit; the
    # encoder's windowed attention, the FrozenBN statistics and the
    # deformable attention do not
    assert all(k in copied for k in tree if k in fresh and ("/conv" in k or "/linear" in k))
    assert "params/transformer/decoder_layer_0/self_attn/q_proj/kernel" in copied
    assert not any("FrozenBatchNorm" in k or "sampling_offsets" in k for k in copied)
    assert all(np.array_equal(merged[k], tree[k]) for k in copied)
    assert counts["unused"] > 0


def test_name_map_matches_jax_s():
    for backbone in ("resnet50", "resnet101"):
        want = J.build_name_map(6, 6, 4, backbone=backbone)
        got = T.build_name_map(6, 6, 4, backbone=backbone)
        assert got == [(t, "/".join(("params",) + f), k) for t, f, k in want]
