"""The n-gram rescoring entry point (``python -m
dtlr_tpu_torch.ngram.rescore``) at TINY on the CPU, against the JAX
package's rescore pipeline composed from its pieces on the same weights
and lines (JAX's ``main`` builds its model through its ``Trainer`` from a
checkpoint directory; its steps, dtlr_tpu/ngram/rescore.py:159-293, are
repeated here): its ``BucketBatcher``, its forward, ``greedy_decode``'s
frames, ``blank_synthesis(logits * logits_multiplier, boxes, eps=0.003)``, an LM
fit on the charset-filtered corpus, ``rescore_line`` with the YAML's
gating, ``corpus_cer``.

The model is the flagship's architecture at TINY widths (test_torch_model.py)
with a minimal ConvNeXt backbone (test_torch_backbones.py's, registered in
both packages' tables for this module: JAX compiles its forward several
times faster than with ResNet-50, and what is under test is the entry
point around the model), the port's fresh tree perturbed from a numpy seed
with a confident class head (random weights then read every query as some
character, so the decoder has words to rescore); the
lines are the first four of dtlr_tpu_torch/assets/smoke_words.npz; the LM
a 5-gram on 400 lines of artifacts/corpus_words_train.txt.

- The frame posteriors and greedy strings: JAX's within 1e-4 on every
  line whose two-stage selection meets no near tie (float32 on both
  sides), at least three of the four; the n-gram strings JAX's decode of
  the port's posteriors exactly, the CERs, the result line and
  ``<ckpt_dir>/ngram_preds/preds_ngram.txt``.
- ``--sweep_lm 'lm_weight=0.5,0.75'``: one line per point, each point's
  CER JAX's decode's, and ``{"best": ...}`` the first lowest.
- ``dataset: synthetic`` renders JAX's lines and batches, which the
  forward reads as JAX's does (as above); under the default charset its
  166 classes, which the TINY model's head does not fit, are refused; a real
  dataset's line the port does not decode is refused with
  data/images.py's reason.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dtlr_tpu.data.batching import BucketBatcher
from dtlr_tpu.eval.decode import greedy_labels, labels_to_text
from dtlr_tpu.eval.metrics import corpus_cer as jax_corpus_cer
from dtlr_tpu.ngram.lm_decode import CharNgramLM, rescore_line
from dtlr_tpu.ops.ctc import blank_synthesis
from dtlr_tpu.ops.pixels import prep_images as jax_prep_images
from dtlr_tpu_torch.config import loader as TL
from dtlr_tpu_torch.data.images import UnsupportedImage
from dtlr_tpu_torch.ngram import rescore
from dtlr_tpu_torch.train.init import init_params
from dtlr_tpu.models.convnext import CONVNEXT_CONFIGS as JAX_CONVNEXT
from dtlr_tpu_torch.models.convnext import CONVNEXT_CONFIGS
from dtlr_tpu_torch.train import config as TC
from test_torch_backbones import MINIMAL, jax_dino, perturb
from test_torch_deform_fixture import nested
from test_torch_model import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_words.npz")
N_LINES = 4  # two batches of two (the eval batcher drops a partial last batch)
OPTIONS = ["backbone=convnext_minimal", "num_queries=24", "hidden_dim=32", "nheads=4",
           "enc_layers=2", "dec_layers=2", "dim_feedforward=64", "encoder_win=8",
           "compute_dtype=float32", "data_aug_scales=[64]", "data_aug_max_size=1024",
           "image_w_max=1024", "image_h_max=64"]
SETTINGS = {"lm_order": 5, "lm_weight": 0.75, "logits_multiplier": 2.0, "beam": 8,
            "skip_gated_words": True, "batch_size": 2}
POSTERIOR_TOL = 1e-4


def write_yaml(path, **keys):
    path.write_text("".join(f"{k}: {v}\n" for k, v in keys.items()))
    return str(path)


BACKBONE = "convnext_minimal"


@pytest.fixture(scope="module", autouse=True)
def minimal_backbone():
    with pytest.MonkeyPatch.context() as mp:
        for table in (JAX_CONVNEXT, CONVNEXT_CONFIGS):
            mp.setitem(table, BACKBONE, MINIMAL["convnext"])
        mp.setitem(TC.ACCEPTED, "backbone", TC.ACCEPTED["backbone"] + (BACKBONE,))
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The files of a run (lines, config, weights, corpus, YAML) and JAX's
    composed pipeline's strings and posteriors."""
    tmp = tmp_path_factory.mktemp("rescore")
    with np.load(WORDS) as z:
        np.savez(tmp / "lines.npz", **{k: z[k][:N_LINES] if k in ("images", "valid_hw", "texts")
                                       else z[k] for k in z.files})
        charset = [str(c) for c in z["charset"]]
    cfg = TL.apply_options(TL.load_config(os.path.join(REPO, "dtlr_tpu_torch", "configs",
                                                       "Latin_TPU.py")),
                           TL.parse_options(OPTIONS))
    TL.dump_config(dict(cfg), str(tmp / "config_cfg.py"))
    model_cfg = dataclasses.replace(TINY, backbone=BACKBONE, dn_labelbook_size=len(charset) + 1)
    tree = perturb(init_params(model_cfg, len(charset), torch.Generator().manual_seed(0)))
    # confident random classes: the focal prior's bias (every query blank)
    # off and the class head's kernel wider, so that the frames read as
    # characters with rivals and the LM has choices to make
    tree["params/class_embed/fc/bias"] = np.zeros_like(tree["params/class_embed/fc/bias"])
    tree["params/class_embed/fc/kernel"] = tree["params/class_embed/fc/kernel"] * 6.0
    np.savez(tmp / "tiny.npz", **tree)
    with open(os.path.join(REPO, "artifacts", "corpus_words_train.txt")) as fh:
        (tmp / "corpus.txt").write_text("".join(l for _, l in zip(range(400), fh)))
    yaml = write_yaml(tmp / "run.yaml", lines=tmp / "lines.npz", model_config=tmp / "config_cfg.py",
                      params=tmp / "tiny.npz", ckpt_dir=tmp / "run", lm_corpus=tmp / "corpus.txt",
                      **SETTINGS)

    # JAX's pipeline (dtlr_tpu/ngram/rescore.py:159-227)
    jcfg = TL.load_config(str(tmp / "config_cfg.py"))
    with np.load(tmp / "lines.npz") as z:
        a = {k: z[k] for k in z.files}
    samples = [{"image": img[:h, :w].astype(np.float32) / 255.0,
                "labels": np.zeros((0,), np.int32), "boxes": None, "text": str(t)}
               for img, (h, w), t in zip(a["images"], a["valid_hw"], a["texts"])]
    batches = list(BucketBatcher(
        iter(samples), batch_size=SETTINGS["batch_size"], scales=jcfg["data_aug_scales"],
        max_size=jcfg["data_aug_max_size"], max_targets=jcfg["max_targets"], train=False,
        w_max=jcfg["image_w_max"], h_max=jcfg["image_h_max"],
        transfer_uint8=jcfg["transfer_uint8"]))
    jm = jax_dino(BACKBONE).clone(num_classes=len(charset), dn_labelbook_size=len(charset) + 1)
    @jax.jit
    def forward(p, im, vh):
        """The forward, ``greedy_decode``'s frames (its body: the argmax of
        the blank synthesis at eps 0.03 / K) and the posteriors, in one
        program: JAX's eager ops would each compile on their own."""
        o = jm.apply(p, jax_prep_images(im, vh), vh, None, train=False)
        logits, boxes = o["pred_logits"], o["pred_boxes"]
        frames = jnp.argmax(blank_synthesis(logits, boxes, eps=0.03 / logits.shape[-1]), -1)
        return frames, blank_synthesis(logits * SETTINGS["logits_multiplier"], boxes, eps=0.003)

    greedy, probs, gts = [], [], []
    for b in batches:
        frames, p = forward(nested(tree), b.images, b.valid_hw)
        greedy += [labels_to_text(l, charset)
                   for l in greedy_labels(np.asarray(frames, np.int32))]
        probs += list(np.asarray(p))
        gts += list(b.texts)
    cs = set(charset)
    lm = CharNgramLM(order=SETTINGS["lm_order"]).fit(
        [t for t in ("".join(c for c in l if c in cs)
                     for l in (tmp / "corpus.txt").read_text().splitlines(True)) if t])

    def ngram(posteriors, greedy_strings, weight):
        """JAX's decode (rescore.py:207-216) of posteriors."""
        return [rescore_line(p, g, charset, lm, lm_weight=weight, beam=SETTINGS["beam"],
                             no_uppercase_words=True, no_digits=False, no_dash=True)
                for p, g in zip(posteriors, greedy_strings)]

    return {"tmp": tmp, "yaml": yaml, "charset": charset, "greedy": greedy, "probs": probs,
            "gts": gts, "ngram": ngram, "forward": forward, "tree": tree, "jcfg": jcfg}


def check_forward(res, setup):
    """The port's posteriors and greedy strings against JAX's forward:
    within POSTERIOR_TOL on every line whose two-stage selection did not
    meet a near tie, at least all but one."""
    lines = [i for i, (p, j) in enumerate(zip(res["posteriors"], setup["probs"]))
             if np.abs(p - j).max() <= POSTERIOR_TOL]
    assert len(lines) >= N_LINES - 1, lines
    assert [res["greedy"][i] for i in lines] == [setup["greedy"][i] for i in lines]
    assert res["gts"] == setup["gts"]


def test_entry_point_matches_jax(setup, capsys):
    """The decode is held exactly on the port's own posteriors: a beam
    search over near-flat random posteriors can tip on float32 noise
    (measured: one line of four at 1e-5 apart), and the decoder alone is
    held to JAX's exactly by test_torch_ngram.py."""
    res = rescore.main(["--config_path", setup["yaml"], "--device", "cpu"])
    check_forward(res, setup)
    want = setup["ngram"](res["posteriors"], res["greedy"], 0.75)
    assert res["ngram"] == want
    assert any(g != n for g, n in zip(want, res["greedy"]))  # the LM moved a reading
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"greedy_CER": jax_corpus_cer(res["greedy"], setup["gts"]),
                       "ngram_CER": jax_corpus_cer(want, setup["gts"]), "lexicon": False,
                       "n": N_LINES}
    assert {k: res[k] for k in printed} == printed
    assert res["out_dir"] == str(setup["tmp"] / "run" / "ngram_preds")
    with open(os.path.join(res["out_dir"], "preds_ngram.txt")) as fh:
        assert fh.read() == "\n".join(want)
    assert len(res["timing"]["forward_ms_per_batch"]) == 2


def test_sweep_lm_matches_jax(setup, capsys):
    res = rescore.main(["--config_path", setup["yaml"], "--device", "cpu",
                        "--sweep_lm", "lm_weight=0.5,0.75"])
    check_forward(res, setup)
    out = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [p["lm_weight"] for p in out[:-1]] == [0.5, 0.75]
    for point in out[:-1]:
        assert point["lm_order"] == SETTINGS["lm_order"] and point["lexicon"] == "off"
        assert point["n"] == N_LINES and point["beam"] == SETTINGS["beam"]
        want = setup["ngram"](res["posteriors"], res["greedy"], point["lm_weight"])
        assert point["ngram_CER"] == jax_corpus_cer(want, setup["gts"])
    best = min(out[:-1], key=lambda p: p["ngram_CER"])
    assert out[-1] == {"best": best} and res["best"] == best


def test_rendered_lines_match_jax(setup, monkeypatch):
    """``dataset: synthetic`` on the no-accent-with-space charset (the TINY
    head's 65 classes) with ``eval_corpus``: the lines and batches are
    those of JAX's pipeline (dtlr_tpu/ngram/rescore.py:81-108: seed 777,
    every line a corpus window, its generator given the banked faces, its
    ``BucketBatcher``), and the posteriors and greedy strings JAX's
    forward's, as ``check_forward`` holds them."""
    from dtlr_tpu.data.charset import resolve_synthetic_charset
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator
    from dtlr_tpu_torch.eval import evaluate as TE
    from test_torch_pretrain import empty_pools
    from test_torch_synth_fixture import mpl_faces

    tmp, jcfg = setup["tmp"], setup["jcfg"]
    yaml = write_yaml(tmp / "synthetic.yaml", dataset="synthetic",
                      synthetic_charset="no_accent_space", num_images=N_LINES,
                      eval_corpus=tmp / "corpus.txt", model_config=tmp / "config_cfg.py",
                      params=tmp / "tiny.npz", ckpt_dir=tmp / "synth", lm_corpus=tmp / "corpus.txt",
                      **SETTINGS)
    seen = []
    forward_batches = TE.forward_batches

    def recorded(model, batches, max_images=-1):
        def tee():
            for b in batches:
                seen.append({k: np.array(getattr(b, k)) for k in ("images", "valid_hw")})
                yield b
        return forward_batches(model, tee(), max_images)

    monkeypatch.setattr(rescore, "forward_batches", recorded)
    empty_pools()
    res = rescore.main(["--config_path", yaml, "--device", "cpu"])

    empty_pools()
    corpus = [l.strip() for l in (tmp / "corpus.txt").read_text().splitlines() if l.strip()]
    gen = SyntheticLineGenerator(
        charset=resolve_synthetic_charset("no_accent_space"), seed=777,
        max_words=jcfg.get_default("synthetic_max_words", 8),
        plain_background=jcfg.get_default("plain_background", False), corpus_lines=corpus,
        corpus_prob=1.0, fonts=mpl_faces())
    samples = [gen.sample_dict() for _ in range(N_LINES)]
    batches = list(BucketBatcher(
        iter(samples), batch_size=SETTINGS["batch_size"], scales=jcfg["data_aug_scales"],
        max_size=jcfg["data_aug_max_size"], max_targets=jcfg["max_targets"], train=False,
        w_max=jcfg["image_w_max"], h_max=jcfg["image_h_max"],
        transfer_uint8=jcfg["transfer_uint8"]))
    assert len(seen) == len(batches) == N_LINES // SETTINGS["batch_size"]
    for got, b in zip(seen, batches):
        np.testing.assert_array_equal(got["images"], np.asarray(b.images))
        np.testing.assert_array_equal(got["valid_hw"], np.asarray(b.valid_hw))
    greedy, probs = [], []
    for b in batches:
        frames, p = setup["forward"](nested(setup["tree"]), b.images, b.valid_hw)
        greedy += [labels_to_text(l, setup["charset"])
                   for l in greedy_labels(np.asarray(frames, np.int32))]
        probs += list(np.asarray(p))
    check_forward(res, {"probs": probs, "greedy": greedy,
                        "gts": [t for b in batches for t in b.texts]})
    assert res["gts"] == [s["text"] for s in samples]


@pytest.mark.parametrize("dataset,error,reason", [
    ("synthetic", ValueError, "classes and the lines' charset 166"),
    ("RIMES", UnsupportedImage, "4-component")])
def test_jax_datasets_are_refused(setup, dataset, error, reason):
    """The renderer's lines under a model whose head does not fit their
    charset, and a real dataset's line that the port does not decode (a
    RIMES layout whose line is a CMYK JPEG)."""
    root = setup["tmp"] / "data"
    labels = root / "RIMES-2011-Lines" / "labels_corr.pkl"
    labels.parent.mkdir(parents=True, exist_ok=True)
    with open(labels, "wb") as fh:
        pickle.dump({"charset": setup["charset"],
                     "ground_truth": {"test": [{"id": "l0", "text": "a"}]}}, fh)
    (root / "RIMES-2011-Lines" / "Images").mkdir(exist_ok=True)
    Image.new("CMYK", (40, 16), (20, 20, 20, 0)).save(
        root / "RIMES-2011-Lines" / "Images" / "l0.jpg")
    yaml = write_yaml(setup["tmp"] / f"{dataset}.yaml", dataset=dataset, mode="test",
                      data_root=root, params=setup["tmp"] / "tiny.npz", batch_size=1,
                      model_config=setup["tmp"] / "config_cfg.py", num_images=2)
    with pytest.raises(error, match=reason):
        rescore.main(["--config_path", yaml, "--device", "cpu"])


def test_needs_cuda_unless_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rescore.main(["--config_path", setup["yaml"]])
