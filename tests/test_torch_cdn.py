"""The port's contrastive denoising queries (dtlr_tpu_torch/models/cdn.py)
against dtlr_tpu/models/cdn.py.

``prepare_cdn`` is held to JAX's with JAX's own four draws, reproduced
from its key split (``jax.random.split(rng, 4)``, dtlr_tpu/models/cdn.py:80)
and handed to the port as ``CdnDraws``: float32 on both sides, the same
arithmetic, to 1e-6. The mask is exact: ``cdn_attn_mask`` and the mask
the kernel builds from ``cdn_query_groups`` (``group_blocked``) equal
JAX's ``cdn_attn_mask`` bit for bit, for several (dn_number, n_max)
including more than one group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtlr_tpu.models.cdn import CdnMeta as JaxCdnMeta
from dtlr_tpu.models.cdn import cdn_attn_mask as jax_cdn_attn_mask
from dtlr_tpu.models.cdn import cdn_num_groups as jax_cdn_num_groups
from dtlr_tpu.models.cdn import prepare_cdn as jax_prepare_cdn
from dtlr_tpu_torch.models.cdn import (CdnDraws, CdnMeta, cdn_attn_mask, cdn_num_groups,
                                       cdn_query_groups, draw_cdn_noise, prepare_cdn)
from dtlr_tpu_torch.ops.flash_attn import group_blocked

TOL = 1e-6
#: (dn_number, n_max, matching queries): one group (the flagship step's),
#: several groups, a group count from the clamp, and a tiny layout
LAYOUTS = [(100, 64, 900), (100, 8, 30), (100, 25, 12), (4, 8, 5), (12, 6, 24)]


def jax_draws(rng, B, N, dn_number, num_classes):
    """JAX's four draws of ``prepare_cdn(rng, ...)``, as its body makes them."""
    G = jax_cdn_num_groups(dn_number, N)
    k_flip, k_which, k_sign, k_mag = jax.random.split(rng, 4)
    return CdnDraws(
        flip=torch.from_numpy(np.array(jax.random.uniform(k_flip, (B, G, 2, N)))),
        label=torch.from_numpy(np.array(
            jax.random.randint(k_which, (B, G, 2, N), 0, num_classes))),
        sign=torch.from_numpy(np.array(
            jax.random.randint(k_sign, (B, G, 2, N, 4), 0, 2) * 2.0 - 1.0, np.float32)),
        mag=torch.from_numpy(np.array(jax.random.uniform(k_mag, (B, G, 2, N, 4)))))


def targets(seed, B=3, N=6, C=16, labelbook=14):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 12, (B, N)).astype(np.int32)
    xy = rng.uniform(0.1, 0.9, (B, N, 2))
    wh = rng.uniform(0.02, 0.3, (B, N, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    valid = np.zeros((B, N), bool)
    for b, n in enumerate(rng.integers(0, N + 1, B)):
        valid[b, :n] = True
    valid[0, :] = True
    label_enc = rng.normal(size=(labelbook, C)).astype(np.float32)
    return labels, boxes, valid, label_enc


@pytest.mark.parametrize("dn_number,label_noise,box_noise", [
    (12, 0.5, 0.4), (5, 0.5, 0.4), (12, 1.0, 1.0), (12, 0.0, 0.0), (100, 0.5, 0.4)],
    ids=["two_groups", "one_group", "full_noise", "no_noise", "eight_groups"])
@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_cdn_matches_jax(dn_number, label_noise, box_noise, seed):
    labels, boxes, valid, label_enc = targets(seed)
    B, N = labels.shape
    rng = jax.random.PRNGKey(seed + 10)
    want_emb, want_box, want_meta = jax_prepare_cdn(
        rng, jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(label_enc), dn_number, label_noise, box_noise, 12)
    draws = jax_draws(rng, B, N, dn_number, 12)
    emb, qbox, meta = prepare_cdn(torch.from_numpy(labels), torch.from_numpy(boxes),
                                  torch.from_numpy(valid), torch.from_numpy(label_enc),
                                  dn_number, label_noise, box_noise, 12, draws)
    assert tuple(meta) == tuple(want_meta)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=0, atol=TOL)
    np.testing.assert_allclose(qbox.numpy(), np.asarray(want_box), rtol=0, atol=TOL)
    # invalid slots are zero queries
    keep = np.tile(valid, (1, 2 * meta.num_groups))
    assert not emb.numpy()[~keep].any() and not qbox.numpy()[~keep].any()


def test_cdn_noise_reaches_the_queries():
    """With noise, some labels flip (even slots only) and every valid
    box moves; negatives move by more than positives."""
    labels, boxes, valid, label_enc = targets(3, B=4, N=8)
    t = lambda a: torch.from_numpy(a)
    gen = torch.Generator().manual_seed(0)
    emb, qbox, meta = prepare_cdn(t(labels), t(boxes), t(valid), t(label_enc), 16, 1.0, 0.4,
                                  12, gen)
    clean_emb, clean_box, _ = prepare_cdn(t(labels), t(boxes), t(valid), t(label_enc), 16, 0.0,
                                          0.0, 12, gen)
    G, N = meta.num_groups, meta.n_max
    keep = torch.from_numpy(np.tile(valid, (1, 2 * G)))
    changed = (emb != clean_emb).any(-1) & keep
    slot = torch.arange(meta.pad_size)
    assert changed.any() and not changed[:, slot % 2 == 1].any()
    shift = (qbox - clean_box).abs().sum(-1).view(4, G, 2, N)
    vmask = torch.from_numpy(valid)[:, None, :]
    assert (shift[:, :, 1][vmask.expand(-1, G, -1)] > 0).all()
    assert shift[:, :, 1][vmask.expand(-1, G, -1)].mean() > shift[:, :, 0][
        vmask.expand(-1, G, -1)].mean()


def test_draws_come_from_the_generator():
    a = draw_cdn_noise(2, 6, 12, 12, torch.Generator().manual_seed(5))
    b = draw_cdn_noise(2, 6, 12, 12, torch.Generator().manual_seed(5))
    c = draw_cdn_noise(2, 6, 12, 12, torch.Generator().manual_seed(6))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.flip, c.flip)
    assert a.flip.shape == (2, 2, 2, 6) and a.mag.shape == (2, 2, 2, 6, 4)
    assert set(a.sign.unique().tolist()) <= {-1.0, 1.0}
    assert 0 <= int(a.label.min()) and int(a.label.max()) < 12


@pytest.mark.parametrize("dn_number,n_max,nq", LAYOUTS)
def test_masks_equal_jax(dn_number, n_max, nq):
    G = jax_cdn_num_groups(dn_number, n_max)
    assert cdn_num_groups(dn_number, n_max) == G
    want = np.asarray(jax_cdn_attn_mask(nq, JaxCdnMeta(G * 2 * n_max, G, n_max)))
    meta = CdnMeta(G * 2 * n_max, G, n_max)
    np.testing.assert_array_equal(cdn_attn_mask(nq, meta).numpy(), want)
    groups = cdn_query_groups(nq, meta)
    assert groups.dtype == torch.int32 and groups.shape == (meta.pad_size + nq,)
    assert (groups[meta.pad_size:] == -1).all()
    np.testing.assert_array_equal(group_blocked(groups).numpy(), want)
