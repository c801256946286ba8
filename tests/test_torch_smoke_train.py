"""The committed reference of the flagship's first CTC step
(dtlr_tpu_torch/assets/smoke_train.npz), which ``chip_smoke.py``'s
``train`` phase holds the port to on a machine without JAX.

``make_smoke_train()`` writes it from the JAX package on the CPU: the
loss of ``make_ctc_train_step``'s ``loss_fn`` (the forward in train mode,
then ``ctc_loss`` with ctc_eps 0.003) on the eight fixture lines
(``smoke_lines.npz``'s images, their texts as labels) with
``artifacts/r4ft_params.npz``, and the norms of its gradient: over every
leaf (before the clip) and over a few named leaves, in float32 and in
the recipe's bfloat16; and the same for each line alone (``line_*``),
which lets a reader hold the lines whose two-stage selection is JAX's
apart from those where near-tied proposals swapped. ``*loss_f64`` is
the loss of JAX's outputs with the CTC taken in float64
(``ctc_float64``): the model reads these lines almost perfectly, and a
float32 CTC's rounding then moves the loss by 1e-4 to 1e-2 of itself. The loss is a mean over lines and every line's
forward is its own, so each line runs alone (B=1, the batch's padded
128x1024 frame) and the batch's loss and gradient are the means of the
lines': the same numbers as one B=8 step, at an eighth of its memory.
Rebuild it with ``python tests/test_torch_smoke_train.py`` from the
repository root with ``PYTHONPATH=.`` (a few minutes on the CPU).
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_train.npz")
DTYPES = ("float32", "bfloat16")
#: the leaves whose gradient norms the card's step is held to
LEAVES = ("params/class_embed/fc/kernel",
          "params/transformer/decoder_layer_0/ca_box_gamma",
          "params/backbone_net/conv1/kernel")
CTC_EPS, MAX_TARGETS = 0.003, 64


def fixture_labels(texts, charset):
    """The texts as padded labels, as the port's ``engine.collate`` makes them."""
    from dtlr_tpu_torch.train.engine import collate

    b = collate({"texts": texts, "images": np.zeros((len(texts), 1, 1, 3), np.uint8),
                 "valid_hw": np.zeros((len(texts), 2), np.int32)},
                range(len(texts)), charset, MAX_TARGETS)
    return b["labels"], b["valid"]


def ctc_float64(logits, boxes, labels, valid, eps=CTC_EPS):
    """One line's CTC loss over its length, in float64 from the model's
    outputs (1, nq, K) and (1, nq, 4): the blank synthesis and the blank
    frames of dtlr_tpu/ops/ctc.py in numpy, the recursion torch's double
    CTC. At these losses (about 0.01 per line) a float32 CTC over 1800
    frames keeps only a few digits: JAX's subtracts 900*log1p(K*1e-5),
    about 0.585, from optax's value and keeps the difference's rounding."""
    import torch

    logits = np.asarray(logits, np.float64)[0]
    order = np.argsort(np.asarray(boxes)[0, :, 0], kind="stable")
    p = 1.0 / (1.0 + np.exp(-logits[order]))
    s = p.sum(-1)
    under = s < 1.0 - eps
    blank = np.where(under, 1.0 - s, eps)
    scale = np.where(under, 1.0, (1.0 - eps) / np.maximum(s, 1e-12))
    probs = np.concatenate([blank[:, None], p * scale[:, None]], -1)
    blank_frames = np.full_like(probs, 1e-5)
    blank_frames[:, 0] = 1.0
    frames = np.stack([probs, blank_frames], 1).reshape(-1, probs.shape[-1])
    lab = np.asarray(labels)[np.asarray(valid, bool)] + 1
    loss = torch.nn.functional.ctc_loss(
        torch.from_numpy(np.log(frames))[:, None], torch.from_numpy(lab)[None].long(),
        torch.tensor([len(frames)]), torch.tensor([len(lab)]), blank=0, reduction="sum",
        zero_infinity=True)
    return float(loss) / max(len(lab), 1)


def jax_first_step(compute_dtype: str):
    """Per line (B=1) the loss and gradient of the JAX package's CTC
    ``loss_fn`` at ``compute_dtype``; returns the batch's loss, its lines'
    losses, the global gradient norm and the LEAVES' norms."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.ctc import ctc_loss
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz
    from dtlr_tpu_torch.eval.evaluate import load_lines
    from test_torch_smoke_fixture import FIXTURE, FLAGSHIP_CFG, PARAMS

    jax.config.update("jax_platforms", "cpu")
    lines = load_lines(FIXTURE)
    labels, valid = fixture_labels(lines["texts"], lines["charset"])
    cfg = load_config(FLAGSHIP_CFG)
    params = load_params_npz(PARAMS)
    cfg.num_classes = params["params"]["class_embed"]["fc"]["kernel"].shape[-1]
    cfg.dn_labelbook_size = params["params"]["label_enc"].shape[0] - 1
    cfg.compute_dtype = compute_dtype
    model = build_dino_from_config(cfg)

    def loss_fn(p, images, valid_hw, lab, val):  # make_ctc_train_step's, ctc_coef 1
        out = model.apply(p, prep_images(images, valid_hw), valid_hw, None, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        loss = ctc_loss(out["pred_logits"], out["pred_boxes"], lab, val, eps=CTC_EPS)[0]
        return loss, (out["pred_logits"], out["pred_boxes"])

    def norms(tree):
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        return (float(np.sqrt(sum(float((v ** 2).sum()) for v in flat.values()))),
                np.asarray([np.sqrt((flat[k] ** 2).sum()) for k in LEAVES]))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    n = len(lines["texts"])
    losses, losses64, line_norms, line_leaf_norms, total = [], [], [], [], None
    for i in range(n):
        (loss, (logits, boxes)), g = grad_fn(
            params, lines["images"][i:i + 1], lines["valid_hw"][i:i + 1], labels[i:i + 1],
            valid[i:i + 1])
        losses.append(float(loss))
        losses64.append(ctc_float64(np.asarray(logits), np.asarray(boxes), labels[i],
                                    valid[i]))
        g = jax.tree.map(lambda x: np.asarray(x, np.float64), g)
        norm, leaf_norms = norms(g)
        line_norms.append(norm)
        line_leaf_norms.append(leaf_norms)
        total = g if total is None else jax.tree.map(np.add, total, g)
    norm, leaf_norms = norms(jax.tree.map(lambda x: x / n, total))
    return {"loss": float(np.mean(losses)), "line_loss": np.asarray(losses),
            "loss_f64": float(np.mean(losses64)), "line_loss_f64": np.asarray(losses64),
            "grad_norm": norm, "leaf_grad_norm": leaf_norms,
            "line_grad_norm": np.asarray(line_norms),
            "line_leaf_grad_norm": np.stack(line_leaf_norms)}


def make_smoke_train(path: str = ASSET) -> None:
    from dtlr_tpu_torch.eval.evaluate import load_lines
    from test_torch_smoke_fixture import FIXTURE

    lines = load_lines(FIXTURE)
    labels, valid = fixture_labels(lines["texts"], lines["charset"])
    out = {"texts": np.asarray(lines["texts"]), "labels": labels, "valid": valid,
           "leaves": np.asarray(LEAVES), "ctc_eps": np.float32(CTC_EPS)}
    for dt in DTYPES:
        ref = jax_first_step(dt)
        for k, v in ref.items():
            out[f"{k}_{dt}"] = np.asarray(v, np.float64)
    np.savez_compressed(path, **out)


def test_smoke_train_loads_and_matches_the_lines():
    from dtlr_tpu_torch.eval.evaluate import load_lines
    from test_torch_smoke_fixture import FIXTURE

    assert os.path.getsize(ASSET) < 100 << 10
    ref = load_lines(ASSET)
    lines = load_lines(FIXTURE)
    assert ref["texts"] == lines["texts"]
    labels, valid = fixture_labels(lines["texts"], lines["charset"])
    np.testing.assert_array_equal(ref["labels"], labels)
    np.testing.assert_array_equal(ref["valid"], valid)
    assert ref["leaves"] == list(LEAVES)
    for dt in DTYPES:
        assert ref[f"line_loss_{dt}"].shape == ref[f"line_loss_f64_{dt}"].shape == (8,)
        assert np.isclose(ref[f"loss_{dt}"], ref[f"line_loss_{dt}"].mean())
        assert np.isclose(ref[f"loss_f64_{dt}"], ref[f"line_loss_f64_{dt}"].mean())
        # the float32 CTC and the float64 one of the same outputs: a few digits
        np.testing.assert_allclose(ref[f"line_loss_{dt}"], ref[f"line_loss_f64_{dt}"],
                                   rtol=2e-2)
        assert np.isfinite(ref[f"grad_norm_{dt}"]) and ref[f"grad_norm_{dt}"] > 0
        assert ref[f"leaf_grad_norm_{dt}"].shape == (len(LEAVES),)
        assert (ref[f"leaf_grad_norm_{dt}"] > 0).all()
        assert ref[f"line_grad_norm_{dt}"].shape == (8,)
        assert ref[f"line_leaf_grad_norm_{dt}"].shape == (8, len(LEAVES))


@pytest.mark.slow
def test_smoke_train_regenerates(tmp_path):
    """The JAX package, run again, writes the same reference (float32 to
    1e-5 relative; bfloat16 to 1e-3: XLA on the CPU is deterministic but
    the thread count may change its summation order)."""
    from dtlr_tpu_torch.eval.evaluate import load_lines

    path = str(tmp_path / "smoke_train.npz")
    make_smoke_train(path)
    new, ref = load_lines(path), load_lines(ASSET)
    for dt, rel in (("float32", 1e-5), ("bfloat16", 1e-3)):
        for k in ("loss", "line_loss", "loss_f64", "line_loss_f64", "grad_norm",
                  "leaf_grad_norm", "line_grad_norm", "line_leaf_grad_norm"):
            np.testing.assert_allclose(new[f"{k}_{dt}"], ref[f"{k}_{dt}"], rtol=rel,
                                       err_msg=f"{k}_{dt}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    make_smoke_train()
    print(ASSET, os.path.getsize(ASSET))
