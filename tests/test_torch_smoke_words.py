"""The n-gram rescoring fixture (dtlr_tpu_torch/assets/smoke_words.npz) and
the JAX package's rescoring of it (dtlr_tpu_torch/assets/smoke_words_ref.npz),
which chip_smoke.py's ``ngram`` phase holds the port's entry point
against.

``smoke_words.npz`` holds the first 16 lines that JAX's
``python -m dtlr_tpu.ngram.rescore --config_path
dtlr_tpu/ngram/synthetic_r4_words.yaml`` renders
(``SyntheticLineGenerator(charset=no_accent_space, seed=777,
max_words=5, corpus_lines=artifacts/corpus_words_val.txt,
corpus_prob=1.0)``, dtlr_tpu/ngram/rescore.py:93-101, ``max_words`` the
flagship recipe's ``synthetic_max_words``): uint8 pixels (the generator's
images are uint8 / 255), valid sizes, texts and the charset, so that a
machine without PIL or fonts reads them through ``NpzLines``.

``smoke_words_ref.npz`` holds what JAX's rescore pipeline makes of them
with ``artifacts/r4ft_params.npz`` and the dumped flagship config: its
batcher (``BucketBatcher`` as rescore.py:159-166 builds it), its forward
in float32 and in the recipe's bfloat16, the greedy strings, the frame
posteriors ``blank_synthesis(logits * 2, boxes, eps=0.003)`` (float32,
kept for fp32), and ``rescore_line``'s strings with the settings of
``chip_smoke.NGRAM_SETTINGS`` (a 6-gram stupid-backoff LM fit on the
charset-filtered ``artifacts/corpus_words_train.txt``, weight 0.75, beam
16, the YAML's gating) in both dtypes, and with the corpus's lexicon
(margin 5.0) in fp32.

Rebuild, from the repository root (needs JAX, PIL and fonts; about 6
minutes on the CPU):

    PYTHONPATH=.:tests python tests/test_torch_smoke_words.py [lines|reference]
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase's paths and settings)

N_LINES = 16
NQ = 900
GENERATOR = {"charset": "no_accent_space", "seed": 777, "max_words": 5,
             "corpus_lines": "artifacts/corpus_words_val.txt", "corpus_prob": 1.0}
STRINGS = ("greedy_fp32", "ngram_fp32", "lexicon_fp32", "greedy_bf16", "ngram_bf16")


def make_lines(path: str = chip_smoke.WORDS, n: int = N_LINES) -> dict:
    """Render the first ``n`` lines of JAX's rescore eval set and write
    them as an npz of uint8 lines."""
    from dtlr_tpu.data.charset import resolve_synthetic_charset
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator

    with open(os.path.join(REPO, GENERATOR["corpus_lines"])) as fh:
        corpus = [l.strip() for l in fh if l.strip()]
    gen = SyntheticLineGenerator(charset=resolve_synthetic_charset(GENERATOR["charset"]),
                                 seed=GENERATOR["seed"], max_words=GENERATOR["max_words"],
                                 plain_background=False, corpus_lines=corpus,
                                 corpus_prob=GENERATOR["corpus_prob"])
    samples = [gen.sample_dict() for _ in range(n)]
    H = max(s["image"].shape[0] for s in samples)
    W = max(s["image"].shape[1] for s in samples)
    images = np.zeros((n, H, W, 3), np.uint8)
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[i, :h, :w] = np.round(s["image"] * 255.0).astype(np.uint8)
        assert np.array_equal(images[i, :h, :w].astype(np.float32) / 255.0, s["image"])
    arrays = {"images": images,
              "valid_hw": np.asarray([s["image"].shape[:2] for s in samples], np.int32),
              "texts": np.asarray([s["text"] for s in samples]),
              "charset": np.asarray(gen.charset), "generator": np.asarray(json.dumps(GENERATOR))}
    np.savez_compressed(path, **arrays)
    return arrays


def jax_batches(lines_path: str):
    """JAX's rescore batcher (dtlr_tpu/ngram/rescore.py:159-166) over the
    npz's lines, with the flagship config."""
    from dtlr_tpu.config import load_config
    from dtlr_tpu.data.batching import BucketBatcher

    cfg = load_config(chip_smoke.FLAGSHIP_CONFIG)
    with np.load(lines_path) as npz:
        a = {k: npz[k] for k in npz.files}
    charset = [str(c) for c in a["charset"]]
    index = {c: i for i, c in enumerate(charset)}
    samples = []
    for img, (h, w), text in zip(a["images"], a["valid_hw"], a["texts"]):
        samples.append({"image": img[:h, :w].astype(np.float32) / 255.0,
                        "labels": np.asarray([index[c] for c in str(text) if c in index],
                                             np.int32),
                        "boxes": None, "text": str(text)})
    batcher = BucketBatcher(
        iter(samples), batch_size=chip_smoke.NGRAM_SETTINGS["batch_size"],
        scales=cfg.data_aug_scales, max_size=cfg.data_aug_max_size,
        max_targets=cfg.get_default("max_targets", 256), train=False,
        w_max=cfg.get_default("image_w_max", 1344), h_max=cfg.get_default("image_h_max", None),
        transfer_uint8=cfg.get_default("transfer_uint8", False))
    batches = list(batcher)
    return batches, charset


def jax_forward(batches, charset, compute_dtype, sub_batch=4):
    """JAX's greedy strings and float32 posteriors of every line."""
    import jax
    import jax.numpy as jnp

    from dtlr_tpu.config import load_config
    from dtlr_tpu.eval.decode import greedy_decode, greedy_labels, labels_to_text
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.ctc import blank_synthesis
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(chip_smoke.FLAGSHIP_CONFIG)
    tree = load_params_npz(chip_smoke.PARAMS)["params"]
    cfg.num_classes = len(charset)
    cfg.dn_labelbook_size = len(charset) + 1
    cfg.compute_dtype = compute_dtype
    model = build_dino_from_config(cfg)
    fwd = jax.jit(lambda p, im, vh: model.apply(p, prep_images(im, vh), vh, None, train=False))
    mult = chip_smoke.NGRAM_SETTINGS["logits_multiplier"]
    greedy, probs = [], []
    for batch in batches:
        for i in range(0, len(batch.texts), sub_batch):
            o = fwd({"params": tree}, batch.images[i:i + sub_batch],
                    batch.valid_hw[i:i + sub_batch])
            logits, boxes = o["pred_logits"], o["pred_boxes"]
            greedy += [labels_to_text(l, charset)
                       for l in greedy_labels(greedy_decode(logits, boxes))]
            probs.append(np.asarray(blank_synthesis(jnp.asarray(logits) * mult,
                                                    jnp.asarray(boxes), eps=0.003), np.float32))
    return greedy, np.concatenate(probs)


def jax_lm(charset):
    """JAX's LM and lexicon, fit as its rescore.py:121-157 fits them."""
    from dtlr_tpu.ngram.lm_decode import CharNgramLM, LexiconTrie

    s = chip_smoke.NGRAM_SETTINGS
    cs_set = set(charset)
    with open(s["lm_corpus"]) as fh:
        text = fh.readlines()
    lm = CharNgramLM(order=s["lm_order"], smoothing=s["lm_smoothing"]).fit(
        [t for t in ("".join(c for c in l if c in cs_set) for l in text) if t])
    words = {"".join(c for c in w if c in cs_set) for l in text for w in l.split()}
    return lm, LexiconTrie(w for w in words if w)


def gate_kw():
    gate = chip_smoke.NGRAM_SETTINGS["skip_gated_words"]
    return dict(no_uppercase_words=gate, no_digits=False, no_dash=gate)


def rescore(rescore_line, probs, greedy, charset, lm, lexicon=None):
    s = chip_smoke.NGRAM_SETTINGS
    return [rescore_line(p, g, charset, lm, lm_weight=s["lm_weight"], beam=s["beam"],
                         lexicon=lexicon,
                         lexicon_margin=chip_smoke.NGRAM_LEXICON["lexicon_margin"], **gate_kw())
            for p, g in zip(probs, greedy)]


def make_reference(path: str = chip_smoke.WORDS_REF, lines_path: str = chip_smoke.WORDS) -> dict:
    """Write the reference (see the module docstring); returns its arrays."""
    from dtlr_tpu.eval.metrics import corpus_cer
    from dtlr_tpu.ngram.lm_decode import rescore_line

    batches, charset = jax_batches(lines_path)
    texts = [t for b in batches for t in b.texts]
    lm, lexicon = jax_lm(charset)
    arrays = {"texts": np.asarray(texts), "settings": np.asarray(json.dumps(
        {**chip_smoke.NGRAM_SETTINGS, **chip_smoke.NGRAM_LEXICON,
         "lm_corpus": os.path.relpath(chip_smoke.LM_CORPUS, REPO)}))}
    for tag, dt in (("fp32", "float32"), ("bf16", "bfloat16")):
        greedy, probs = jax_forward(batches, charset, dt)
        arrays[f"greedy_{tag}"] = np.asarray(greedy)
        arrays[f"ngram_{tag}"] = np.asarray(rescore(rescore_line, probs, greedy, charset, lm))
        if tag == "fp32":
            arrays["probs_fp32"] = probs
            arrays["lexicon_fp32"] = np.asarray(
                rescore(rescore_line, probs, greedy, charset, lm, lexicon))
    for k in STRINGS:
        arrays[f"cer_{k}"] = np.asarray(corpus_cer([str(s) for s in arrays[k]], texts))
    np.savez_compressed(path, **arrays)
    return arrays


def load(path: str) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def test_lines_load():
    from dtlr_tpu_torch.data.charset import resolve_synthetic_charset
    from dtlr_tpu_torch.data.loaders import NpzLines

    assert os.path.getsize(chip_smoke.WORDS) < 4 << 20
    a = load(chip_smoke.WORDS)
    assert a["images"].dtype == np.uint8 and a["images"].shape[0] == N_LINES
    assert a["images"].shape[3] == 3
    assert (a["valid_hw"] <= a["images"].shape[1:3]).all()
    assert json.loads(str(a["generator"])) == GENERATOR
    ds = NpzLines(chip_smoke.WORDS)
    assert ds.charset == resolve_synthetic_charset("no_accent_space")
    assert len(ds) == N_LINES and all(ds.text_of(i) for i in range(N_LINES))
    h, w = a["valid_hw"][0]
    assert ds[0]["image"].shape == (h, w, 3)


def test_reference_loads():
    assert os.path.getsize(chip_smoke.WORDS_REF) < 8 << 20
    ref = load(chip_smoke.WORDS_REF)
    lines = load(chip_smoke.WORDS)
    assert [str(t) for t in ref["texts"]] == [str(t) for t in lines["texts"]]
    for k in STRINGS:
        assert ref[k].shape == (N_LINES,) and ref[k].dtype.kind == "U", k
        assert 0.0 <= float(ref[f"cer_{k}"]) < 0.5, k
    assert ref["probs_fp32"].shape == (N_LINES, NQ, len(lines["charset"]) + 1)
    assert ref["probs_fp32"].dtype == np.float32 and np.isfinite(ref["probs_fp32"]).all()
    settings = json.loads(str(ref["settings"]))
    assert settings["lm_corpus"] == "artifacts/corpus_words_train.txt"
    assert {k: settings[k] for k in chip_smoke.NGRAM_LEXICON} == chip_smoke.NGRAM_LEXICON


@pytest.mark.slow
def test_regenerates(tmp_path):
    """Both files rebuilt equal the committed ones (the rendering exactly,
    the strings exactly, the posteriors to 1e-6)."""
    lines = make_lines(str(tmp_path / "words.npz"))
    want = load(chip_smoke.WORDS)
    assert set(lines) == set(want)
    for k in want:
        assert np.array_equal(lines[k], want[k]), k
    got = make_reference(str(tmp_path / "ref.npz"), chip_smoke.WORDS)
    want = load(chip_smoke.WORDS_REF)
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype.kind in "US":
            assert np.array_equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_port_decoder_on_jax_posteriors():
    """The port's LM, lexicon and ``rescore_line`` on JAX's committed fp32
    posteriors give JAX's n-gram and lexicon strings exactly (the card's
    gate (a), here on the CPU)."""
    from dtlr_tpu_torch.ngram.lm_decode import CharNgramLM, LexiconTrie, rescore_line

    ref = load(chip_smoke.WORDS_REF)
    charset = [str(c) for c in load(chip_smoke.WORDS)["charset"]]
    s = chip_smoke.NGRAM_SETTINGS
    cs_set = set(charset)
    with open(s["lm_corpus"]) as fh:
        text = fh.readlines()
    lm = CharNgramLM(order=s["lm_order"], smoothing=s["lm_smoothing"]).fit(
        [t for t in ("".join(c for c in l if c in cs_set) for l in text) if t])
    lexicon = LexiconTrie(w for w in {"".join(c for c in w if c in cs_set)
                                      for l in text for w in l.split()} if w)
    greedy = [str(g) for g in ref["greedy_fp32"]]
    assert rescore(rescore_line, ref["probs_fp32"], greedy, charset, lm) == \
        [str(x) for x in ref["ngram_fp32"]]
    assert rescore(rescore_line, ref["probs_fp32"], greedy, charset, lm, lexicon) == \
        [str(x) for x in ref["lexicon_fp32"]]


if __name__ == "__main__":
    what = sys.argv[1:] or ["lines", "reference"]
    if "lines" in what:
        make_lines()
        print(chip_smoke.WORDS, os.path.getsize(chip_smoke.WORDS))
    if "reference" in what:
        make_reference()
        print(chip_smoke.WORDS_REF, os.path.getsize(chip_smoke.WORDS_REF))
