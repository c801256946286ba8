"""The port's warm start (``checkpoints.merge_params_npz``) against the
JAX package's (dtlr_tpu/train/checkpoints.py:166-199) on the same npz
and the same fresh tree (the port's initialization at ``TINY``, given to
JAX as its nested pytree): the same counts, and every leaf of the merged
trees equal bit for bit (the copied ones cast from the npz's float16 to
float32 alike). The npz lacks some of the tree's leaves, has leaves the
tree lacks and one of another shape; across a class-count change the
fresh leaves are exactly the class heads and the label encoder.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dtlr_tpu.train import checkpoints as JC
from dtlr_tpu_torch.train import checkpoints as TC
from dtlr_tpu_torch.train.init import init_params
from test_torch_model import TINY

#: the leaves whose shape follows the class count
CLASS_LEAVES = {"params/class_embed/fc/kernel", "params/class_embed/fc/bias",
                "params/enc_out_class_embed/fc/kernel", "params/enc_out_class_embed/fc/bias",
                "params/label_enc"}


def tree(num_classes: int, seed: int):
    cfg = dataclasses.replace(TINY, dn_labelbook_size=num_classes + 1)
    return init_params(cfg, num_classes, torch.Generator().manual_seed(seed))


def nested(flat):
    out = {}
    for key, leaf in flat.items():
        node = out
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = jax.numpy.asarray(leaf)
    return out


def merge_both(fresh, path):
    got, got_counts = TC.merge_params_npz(fresh, str(path))
    want, want_counts = JC.merge_params_npz(nested(fresh), str(path))
    want = JC._flatten(jax.tree.map(np.asarray, want))
    assert got_counts == want_counts
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    return got, got_counts


@pytest.mark.parametrize("snapshot_classes", [12, 9], ids=["same_classes", "other_classes"])
def test_merge_matches_jax(tmp_path, snapshot_classes):
    fresh = tree(12, 0)
    snap = {k: v.astype(np.float16) for k, v in tree(snapshot_classes, 1).items()}
    dropped = ["params/transformer/tgt_embed", "params/transformer/decoder_norm/scale"]
    for k in dropped:
        snap.pop(k)
    snap["params/transformer/unused/kernel"] = np.ones((3, 3), np.float16)
    snap["params/transformer/level_embed"] = np.ones((5, TINY.hidden_dim), np.float16)
    np.savez(tmp_path / "snap.npz", **snap)
    merged, counts = merge_both(fresh, tmp_path / "snap.npz")
    fresh_keys = {k for k in merged if merged[k] is fresh[k]}
    moved = set(dropped) | {"params/transformer/level_embed"}
    if snapshot_classes != 12:
        moved |= CLASS_LEAVES
    assert fresh_keys == moved
    assert counts == {"copied": len(fresh) - len(moved), "fresh": len(moved),
                      "unused": len(snap) - (len(fresh) - len(moved))}
    for k in set(fresh) - moved:
        assert np.array_equal(merged[k], snap[k].astype(np.float32)), k


def test_a_whole_snapshot_copies_every_leaf(tmp_path):
    fresh, snap = tree(12, 0), tree(12, 3)
    np.savez(tmp_path / "snap.npz", **snap)
    merged, counts = merge_both(fresh, tmp_path / "snap.npz")
    assert counts == {"copied": len(fresh), "fresh": 0, "unused": 0}


def test_windowed_trunk_into_the_reference_architecture(tmp_path):
    """A flagship (windowed, dense, GroupNorm) snapshot warm-starts
    Latin.py's architecture (deformable, deform, FrozenBN) at TINY as
    JAX's merge does: the backbone convolutions, the input projections,
    the decoders' self-attention and FFNs, the heads and the embeddings
    are copied; the FrozenBN statistics and the deformable attentions stay
    fresh; the GroupNorms, the windowed encoders' and the dense
    cross-attentions' leaves go unused."""
    cfg = dataclasses.replace(TINY, encoder_type="deformable", decoder_ca="deform",
                              dense_box_bias=False, shared_offsets=False,
                              norm_kind="FrozenBatchNorm2d", dn_labelbook_size=13)
    fresh = init_params(cfg, 12, torch.Generator().manual_seed(0))
    trunk = {k: v.astype(np.float16) for k, v in tree(12, 1).items()}
    path = tmp_path / "trunk.npz"
    np.savez(path, **trunk)
    got, counts = merge_both(fresh, path)
    copied = {k for k in got if got[k] is not fresh[k]}
    assert counts == {"copied": len(copied), "fresh": len(fresh) - len(copied),
                      "unused": len(trunk) - len(copied)}
    assert {k for k in copied if k.startswith("params/backbone_net/")} == {
        k for k in fresh if k.startswith("params/backbone_net/") and k.endswith("/kernel")}
    assert not any("FrozenBatchNorm" in k or "sampling_offsets" in k or "attention_weights" in k
                   for k in copied)
    assert {"params/transformer/decoder_layer_0/self_attn/q_proj/kernel",
            "params/transformer/decoder_layer_1/linear2/bias", "params/class_embed/fc/kernel",
            "params/transformer/tgt_embed", "params/label_enc"} <= copied
    assert any("GroupNorm" in k for k in trunk if k not in copied)
