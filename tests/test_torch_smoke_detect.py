"""The committed detection fixture (dtlr_tpu_torch/assets/smoke_detect.npz)
and the JAX package's first detection step on it
(dtlr_tpu_torch/assets/smoke_detect_ref.npz), which ``chip_smoke.py``'s
``detect`` phase holds the port to on a machine without JAX or PIL.

``make_fixture()`` renders eight lines as the pretraining stream renders
them (dtlr_tpu/train/pretrain.py with the recipe of
scripts/round4_chain.sh:43-56): ``SyntheticLineGenerator`` with its
166-character default charset, ``max_words=5``, half of the lines drawn
from ``artifacts/corpus_words_val.txt``, batched by ``BucketBatcher`` at
scale 128, max size 1024, height at most 192 and 64 target slots; it
keeps the uint8 images, valid sizes, labels, cxcywh boxes in [0, 1],
validity, texts and the charset.

``make_reference()`` runs the JAX package's ``make_detection_train_step``
loss (the forward in train mode, ``detection_loss`` with the auction,
``matcher_impl="jax"``) on those lines with ``artifacts/r4run_params.npz``
in float32 and in bfloat16, with the CDN noise set to zero
(``dn_label_noise_ratio = dn_box_noise_scale = 0``: the denoising
queries are then the targets themselves in both frameworks, and the
prefix, the mask and every DN term still run). Each line runs alone
(B=1 in the batch's padded frame, a few GB on the CPU): every module
acts per image and every loss term is a sum over images over the
batch's target count, so the batch's terms, loss and gradient are the
lines' weighted by their target counts (``cardinality_error``, a mean
over images, by 1/B). It stores the batch's total and terms, the
gradient's global norm and a few leaves' norms (``LEAVES``), the same
per line, and each line's seven assignments (final layer, five
auxiliary layers, two-stage output) with its two-stage anchors (the
selected proposals' boxes, ``interm_outputs_for_matching_pre``), which
tell a reader whether the port selected the same proposals.

Rebuild both with ``python tests/test_torch_smoke_detect.py`` from the
repository root with ``PYTHONPATH=.`` (needs JAX, PIL and fonts; about
ten minutes on the CPU).
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_detect.npz")
REFERENCE = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_detect_ref.npz")
PARAMS = os.path.join(REPO, "artifacts", "r4run_params.npz")
CONFIG = os.path.join(REPO, "dtlr_tpu", "configs", "Latin_TPU.py")
DTYPES = ("float32", "bfloat16")
#: the leaves whose gradient norms the card's first step is held to
LEAVES = ("params/label_enc",
          "params/class_embed/fc/kernel",
          "params/backbone_net/conv1/kernel",
          "params/transformer/decoder_layer_0/ca_box_gamma",
          "params/transformer/decoder_layer_0/self_attn/q_proj/kernel")
#: the matched outputs, in detection_loss's order
MATCHED = ("final",) + tuple(f"aux_{i}" for i in range(5)) + ("interm",)
N_LINES, MAX_TARGETS, SEED = 8, 64, 323


def make_fixture(path: str = FIXTURE) -> None:
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator

    with open(os.path.join(REPO, "artifacts", "corpus_words_val.txt")) as fh:
        corpus = [l.strip() for l in fh if l.strip()]
    gen = SyntheticLineGenerator(seed=SEED, max_words=5, corpus_lines=corpus, corpus_prob=0.5)
    samples = [gen.sample_dict() for _ in range(N_LINES)]
    batcher = BucketBatcher(iter(samples), batch_size=N_LINES, scales=[128], max_size=1024,
                            max_targets=MAX_TARGETS, w_max=1024, h_max=192, train=False,
                            transfer_uint8=True)
    batch = next(iter(batcher))
    batcher.stop()
    np.savez_compressed(
        path, images=np.asarray(batch.images, np.uint8),
        valid_hw=np.asarray(batch.valid_hw, np.int32),
        labels=np.asarray(batch.labels, np.int32), boxes=np.asarray(batch.boxes, np.float32),
        valid=np.asarray(batch.valid, bool), texts=np.asarray(batch.texts),
        charset=np.asarray(gen.charset))


def jax_model(compute_dtype: str):
    """The pretraining recipe's model (Latin_TPU.py with round4_chain.sh's
    dense_box_bias and max_targets) with the CDN noise at zero."""
    from dtlr_tpu.config import load_config
    from dtlr_tpu.models.dino import build_dino_from_config

    cfg = load_config(CONFIG)
    cfg.dense_box_bias = True
    cfg.max_targets = MAX_TARGETS
    cfg.compute_dtype = compute_dtype
    cfg.dn_label_noise_ratio = 0.0
    cfg.dn_box_noise_scale = 0.0
    return cfg, build_dino_from_config(cfg)


def jax_first_step(compute_dtype: str, lines):
    """Per line (B=1): the loss, its terms, the gradient and the seven
    assignments of the JAX package's detection step at ``compute_dtype``;
    returns them with the batch's values combined from the lines'."""
    import jax
    import jax.numpy as jnp

    from dtlr_tpu.losses.criterion import build_weight_dict, detection_loss
    from dtlr_tpu.ops.matcher import hungarian_match
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz

    jax.config.update("jax_platforms", "cpu")
    cfg, model = jax_model(compute_dtype)
    weight_dict = build_weight_dict(cfg)
    params = load_params_npz(PARAMS)
    num_classes = cfg.num_classes

    def loss_fn(p, batch):  # make_detection_train_step's (train_step.py:65-81)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        key = jax.random.PRNGKey(0)
        out = model.apply(p, prep_images(batch["images"], batch["valid_hw"]),
                          batch["valid_hw"], targets, train=True,
                          rngs={"dn": key, "dropout": jax.random.fold_in(key, 1)})
        total, losses = detection_loss(out, targets, num_classes, weight_dict,
                                       focal_alpha=cfg.focal_alpha, matcher_impl="jax")
        matched = [out] + list(out["aux_outputs"]) + [out["interm_outputs"]]
        assign = jnp.stack([hungarian_match(
            jax.lax.stop_gradient(o["pred_logits"]), jax.lax.stop_gradient(o["pred_boxes"]),
            targets["labels"], targets["boxes"], targets["valid"], impl="jax")
            for o in matched])
        anchors = out["interm_outputs_for_matching_pre"]["pred_boxes"]
        return total, (losses, assign, jax.lax.stop_gradient(anchors))

    def norms(tree):
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        return (float(np.sqrt(sum(float((v ** 2).sum()) for v in flat.values()))),
                np.asarray([np.sqrt((flat[k] ** 2).sum()) for k in LEAVES]))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    n = len(lines["texts"])
    nb_line = np.maximum(lines["valid"].sum(1), 1).astype(np.float64)
    nb = max(float(lines["valid"].sum()), 1.0)
    out = {"line_loss": [], "line_grad_norm": [], "line_leaf_grad_norm": [], "assign": [],
           "anchors": []}
    terms, total_grad, names = None, None, None
    for i in range(n):
        batch = {k: jnp.asarray(lines[k][i:i + 1]) for k in
                 ("images", "valid_hw", "labels", "boxes", "valid")}
        (loss, (losses, assign, anchors)), g = grad_fn(params, batch)
        names = sorted(losses)
        vals = np.asarray([float(losses[k]) for k in names], np.float64)
        out["line_loss"].append(float(loss))
        out["assign"].append(np.asarray(assign)[:, 0])
        out["anchors"].append(np.asarray(anchors, np.float32)[0])
        g = jax.tree.map(lambda x: np.asarray(x, np.float64), g)
        norm, leaf_norms = norms(g)
        out["line_grad_norm"].append(norm)
        out["line_leaf_grad_norm"].append(leaf_norms)
        w = nb_line[i] / nb
        weights = np.asarray([1.0 / n if k == "cardinality_error" else w for k in names])
        terms = vals * weights if terms is None else terms + vals * weights
        out.setdefault("line_terms", []).append(vals)
        total_grad = (jax.tree.map(lambda x: x * w, g) if total_grad is None
                      else jax.tree.map(lambda a, x: a + x * w, total_grad, g))
    norm, leaf_norms = norms(total_grad)
    result = {k: np.asarray(v) for k, v in out.items()}
    result.update(loss=float(np.dot(result["line_loss"], nb_line / nb)), terms=terms,
                  grad_norm=norm, leaf_grad_norm=leaf_norms)
    return names, result


def make_reference(path: str = REFERENCE) -> None:
    from dtlr_tpu_torch.eval.evaluate import load_lines

    lines = load_lines(FIXTURE)
    out = {"leaves": np.asarray(LEAVES), "matched": np.asarray(MATCHED),
           "params": np.asarray([os.path.relpath(PARAMS, REPO)])}
    for dt in DTYPES:
        names, ref = jax_first_step(dt, lines)
        out["terms"] = np.asarray(names)
        for k, v in ref.items():
            kind = {"assign": np.int32, "anchors": np.float32}.get(k, np.float64)
            out[f"{k}_{dt}"] = np.asarray(v, kind)
    np.savez_compressed(path, **out)


def test_fixture_loads():
    from dtlr_tpu_torch.eval.evaluate import load_lines

    assert os.path.getsize(FIXTURE) < 1 << 20
    lines = load_lines(FIXTURE)
    # the flagship bucket, 128 x 1024: S = 2720 keys
    assert lines["images"].dtype == np.uint8 and lines["images"].shape == (N_LINES, 128, 1024, 3)
    assert lines["labels"].shape == lines["valid"].shape == (N_LINES, MAX_TARGETS)
    assert lines["boxes"].shape == (N_LINES, MAX_TARGETS, 4)
    assert len(lines["charset"]) == 166 and len(lines["texts"]) == N_LINES
    valid = lines["valid"]
    assert valid.any(1).all()
    boxes = lines["boxes"][valid]
    assert (boxes >= 0).all() and (boxes <= 1).all() and (boxes[:, 2:] > 0).all()
    # a line's valid labels spell its text without spaces (one box a character)
    for text, lab, v in zip(lines["texts"], lines["labels"], valid):
        spelled = "".join(lines["charset"][j] for j in lab[v])
        assert spelled == text.replace(" ", "")[:MAX_TARGETS] or spelled == text[:MAX_TARGETS]


def test_reference_loads():
    from dtlr_tpu_torch.eval.evaluate import load_lines

    assert os.path.getsize(REFERENCE) < 600 << 10
    ref = load_lines(REFERENCE)
    assert ref["leaves"] == list(LEAVES) and ref["matched"] == list(MATCHED)
    lines = load_lines(FIXTURE)
    for dt in DTYPES:
        assert ref[f"terms_{dt}"].shape == (len(ref["terms"]),)
        assert {"loss_ce", "loss_ce_dn", "loss_bbox_dn_4", "loss_giou_interm"} <= set(ref["terms"])
        assert np.isfinite(ref[f"loss_{dt}"]) and ref[f"grad_norm_{dt}"] > 0
        assert (ref[f"leaf_grad_norm_{dt}"] > 0).all()
        assign = ref[f"assign_{dt}"]
        assert assign.shape == (N_LINES, len(MATCHED), MAX_TARGETS)
        assert ref[f"anchors_{dt}"].shape == (N_LINES, 900, 4)
        assert ref[f"line_terms_{dt}"].shape == (N_LINES, len(ref["terms"]))
        for i in range(N_LINES):
            v = lines["valid"][i]
            assert (assign[i][:, ~v] == -1).all()
            for a in assign[i]:
                assert len(set(a[v].tolist())) == int(v.sum())


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] != ["reference"]:
        make_fixture()
        print(FIXTURE, os.path.getsize(FIXTURE))
    make_reference()
    print(REFERENCE, os.path.getsize(REFERENCE))
