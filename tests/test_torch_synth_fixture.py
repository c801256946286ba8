"""The rendered-line fixture (dtlr_tpu_torch/assets/smoke_synth_ref.npz)
and its assets (dtlr_tpu_torch/assets/smoke_synth/), which the card's
``synth`` phase holds the port's renderer and pretraining stream to.

For each of four modes, the JAX package's ``SyntheticLineGenerator``
given the banked faces' TTF paths (matplotlib's, in the bank's order)
renders ``n`` lines from the mode's seed; the fixture keeps each line's
text, labels, float32 boxes and the sha256 of its uint8 pixels (the
image is that uint8 over 255, exactly):

- ``round4``: scripts/round4_chain.sh's stream (canvas backgrounds, at
  most 5 words, artifacts/corpus_words_train.txt's word windows at 0.5);
- ``plain``: ``plain_background=True``;
- ``reference_text``: the reference's text mode with a ``FontSampler``
  from a reference-format JSON (smoke_synth/fonts.json; one path names no
  banked face) and a ``CorpusSampler`` over a wikitext-layout directory
  (smoke_synth/text/en/: headers, ``@-@`` tokens, lines over 100
  characters);
- ``background_dir``: ``synthetic_background_dir`` of committed PNG and
  baseline-JPEG files (smoke_synth/backgrounds/, sizes that the master
  resize shrinks, grows, or both).

Each mode starts from an empty background pool (``set_background_dir``).
It also keeps the sha256 of the first two pretraining batches that JAX's
generator and batcher make for the card's pretraining run
(``PRETRAIN_OPTIONS`` on configs/Latin_TPU.py, seed 0): the held-out
stream's eight lines drawn first, as dtlr_tpu/train/pretrain.py:231-237
draws them, then the training stream through ``BucketBatcher``.

``PYTHONPATH=.:tests python tests/test_torch_synth_fixture.py``
(repository root; needs JAX, PIL and matplotlib's fonts; about a minute)
rewrites the assets and the fixture; the tests here rebuild both and
compare (tests/test_torch_synthetic.py holds the port's lines to them).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "dtlr_tpu_torch", "assets")
SYNTH = os.path.join(ASSETS, "smoke_synth")
FIXTURE = os.path.join(ASSETS, "smoke_synth_ref.npz")
CONFIG = os.path.join(REPO, "dtlr_tpu_torch", "configs", "Latin_TPU.py")
CORPUS_TRAIN = "artifacts/corpus_words_train.txt"
CORPUS_VAL = "artifacts/corpus_words_val.txt"
#: the rendering modes of the card's fixture gate (paths from the repository root)
MODES = [
    {"name": "round4", "seed": 11, "n": 16, "max_words": 5, "corpus_file": CORPUS_TRAIN,
     "corpus_prob": 0.5},
    {"name": "plain", "seed": 12, "n": 16, "max_words": 8, "plain_background": True},
    {"name": "reference_text", "seed": 13, "n": 16, "reference_text": True,
     "font_dict": "dtlr_tpu_torch/assets/smoke_synth/fonts.json",
     "corpus_dir": "dtlr_tpu_torch/assets/smoke_synth/text"},
    {"name": "background_dir", "seed": 14, "n": 16, "max_words": 5,
     "background_dir": "dtlr_tpu_torch/assets/smoke_synth/backgrounds"},
]
#: scripts/round4_chain.sh:52-57's options for the card's pretraining run,
#: with eight held-out lines
PRETRAIN_OPTIONS = [
    "batch_size=8", "use_ema=True", "warmup_steps=200", "max_targets=64",
    "data_aug_scales=[128]", "data_aug_max_size=1024", "image_w_max=1024",
    "image_h_max=192", "synthetic_max_words=5", "eval_set_size=8",
    "save_checkpoint_interval=20", "lr_drop=50000", "batch_norm_type=group",
    "lr_backbone=1e-4", "dense_box_bias=True",
    f'synthetic_corpus_file="{CORPUS_TRAIN}"', f'synthetic_corpus_val_file="{CORPUS_VAL}"',
    "synthetic_corpus_prob=0.5"]
PRETRAIN_SEED, N_BATCHES = 0, 2


def mpl_faces():
    """The banked faces' TTF paths under matplotlib's font directory, in
    the bank's order (what the JAX package's generator is given)."""
    import matplotlib

    from dtlr_tpu_torch.data.fonts import bank_names

    d = os.path.join(matplotlib.get_data_path(), "fonts", "ttf")
    return [os.path.join(d, n) for n in bank_names()]


def repo_path(p):
    return os.path.join(REPO, p)


def generator(pkg: str, mode: dict):
    """The mode's generator of the JAX package (``pkg="jax"``, given the
    banked faces' TTF paths) or of the port, its background pool emptied."""
    if pkg == "jax":
        from dtlr_tpu.data import canvas, corpus, fonts, synthetic
        faces, root = mpl_faces(), os.path.dirname(mpl_faces()[0])
    else:
        from dtlr_tpu_torch.data import canvas, corpus, fonts, synthetic
        faces, root = fonts.discover_fonts(), ""
    canvas.set_background_dir(repo_path(mode["background_dir"]) if mode.get("background_dir")
                              else None)
    kw = dict(seed=mode["seed"], fonts=faces, plain_background=mode.get("plain_background", False))
    if "max_words" in mode:
        kw["max_words"] = mode["max_words"]
    if mode.get("corpus_file"):
        with open(repo_path(mode["corpus_file"])) as fh:
            kw["corpus_lines"] = [l.strip() for l in fh if l.strip()]
        kw["corpus_prob"] = mode["corpus_prob"]
    if mode.get("reference_text"):
        kw["reference_text_mode"] = True
        kw["font_sampler"] = fonts.FontSampler.from_reference_json(
            repo_path(mode["font_dict"]), font_root=root, fallback_fonts=faces,
            rng=np.random.default_rng(mode["seed"] + 13))
        kw["corpus_sampler"] = corpus.CorpusSampler.from_dir(
            repo_path(mode["corpus_dir"]), language="en", mode="train",
            rng=np.random.default_rng(mode["seed"] + 17))
    return synthetic.SyntheticLineGenerator(**kw)


def image_sha256(image: np.ndarray) -> str:
    """sha256 of a float32 line's uint8 pixels (image * 255, exact)."""
    u8 = np.round(np.asarray(image, np.float64) * 255.0).astype(np.uint8)
    assert np.array_equal(u8.astype(np.float32) / 255.0, image)
    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def sample_record(s) -> dict:
    return {"text": s.text, "labels": np.asarray(s.labels).tolist(),
            "boxes": np.asarray(s.boxes, np.float32).tolist(),
            "shape": list(s.image.shape), "sha256": image_sha256(s.image)}


def render_mode(pkg: str, mode: dict, n=None):
    gen = generator(pkg, mode)
    return [gen.sample() for _ in range(mode["n"] if n is None else n)]


def batch_hashes(batch) -> dict:
    h = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    return {"images": h(np.asarray(batch.images, np.uint8)), "labels": h(batch.labels),
            "valid": h(batch.valid), "valid_hw": h(batch.valid_hw),
            "boxes": h(np.asarray(batch.boxes, np.float32)), "texts": list(batch.texts)}


def jax_pretrain_batches(options=PRETRAIN_OPTIONS, seed=PRETRAIN_SEED, n=N_BATCHES,
                         config=CONFIG):
    """JAX's pretraining batches for ``-c config --dataset_file
    synthetic_line_OCR_general --seed seed --options options``
    (dtlr_tpu/train/pretrain.py:103-229) with the banked faces: the
    held-out stream's ``eval_set_size`` lines first, then ``n`` batches of
    the training stream."""
    from dtlr_tpu.config import load_config, parse_options
    from dtlr_tpu.config.loader import apply_options
    from dtlr_tpu.data import canvas
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator

    cfg = apply_options(load_config(config), parse_options(list(options)))
    canvas.set_background_dir(None)
    g = cfg.get_default

    def read(path):
        with open(repo_path(path)) as fh:
            return [l.strip() for l in fh if l.strip()]

    def stream(mode, s):
        path = g("synthetic_corpus_val_file", None) if mode == "val" else None
        path = path or g("synthetic_corpus_file", None)
        return SyntheticLineGenerator(
            plain_background=g("plain_background", False), max_words=g("synthetic_max_words", 30),
            seed=s, fonts=mpl_faces(), corpus_lines=read(path) if path else None,
            corpus_prob=g("synthetic_corpus_prob", 0.5))

    train, val = stream("train", seed), stream("val", seed + 1)
    held_out = [next(iter(val)) for _ in range(int(g("eval_set_size", 200)))]
    space = train.charset.index(" ")
    batcher = BucketBatcher(
        iter(train), batch_size=cfg.batch_size, scales=cfg.data_aug_scales,
        max_size=cfg.data_aug_max_size, max_targets=g("max_targets", 256),
        w_max=g("image_w_max", 1344), h_max=g("image_h_max", None), train=True,
        truly_random_erasing=g("truly_random_erasing", False),
        instance_erasing=g("truly_random_erasing", False), space_label=space, seed=seed,
        transfer_uint8=g("transfer_uint8", False), reuse=g("synthetic_reuse", 1))
    return held_out, [batcher._make_batch() for _ in range(n)]


# ------------------------------------------------------------ the assets

def write_assets():
    """The font dictionary, the wikitext directory and the backgrounds."""
    from PIL import Image

    from dtlr_tpu_torch.data.fonts import ABILITY_NUMBERS, ABILITY_SYMBOLS, bank_names

    os.makedirs(SYNTH, exist_ok=True)
    names = bank_names()
    serif = [n for n in names if "Serif" in n or n.startswith("STIX")]
    mono = [n for n in names if "Mono" in n]
    sans = [n for n in names if n not in serif and n not in mono]
    book = {
        "SANS_SERIF": {ABILITY_SYMBOLS: sans[:3], ABILITY_NUMBERS: sans},
        "MONOSPACE": {ABILITY_SYMBOLS: mono, ABILITY_NUMBERS: mono[:2] + ["NoSuchFace.ttf"]},
        "SERIF": {ABILITY_SYMBOLS: serif[::2], ABILITY_NUMBERS: serif},
        "HANDWRITING": {ABILITY_SYMBOLS: ["DejaVuSerif-Italic.ttf", "STIXGeneralItalic.ttf"],
                        ABILITY_NUMBERS: ["DejaVuSans-Oblique.ttf"]},
        "DISPLAY": {ABILITY_SYMBOLS: ["DejaVuSans-Bold.ttf", "STIXGeneralBol.ttf"],
                    ABILITY_NUMBERS: ["DejaVuSerif-Bold.ttf", "NoSuchFace.ttf"]},
    }
    with open(os.path.join(SYNTH, "fonts.json"), "w") as fh:
        json.dump(book, fh, indent=1)

    rng = np.random.default_rng(2026)
    with open(repo_path(CORPUS_VAL)) as fh:
        words = [l.strip() for l in fh if l.strip()][:400]
    text = os.path.join(SYNTH, "text", "en")
    os.makedirs(text, exist_ok=True)

    def wikitext(lines):
        out = []
        for i, line in enumerate(lines):
            if i % 17 == 0:
                out.append(f" = {line.split(' ')[0].title()} = ")
            ws = line.split(" ")
            if i % 3 == 0 and len(ws) > 3:
                ws.insert(2, "@-@")
            if i % 5 == 0:
                ws.insert(len(ws) // 2, "@.@ 5")
            if i % 7 == 0:
                ws.insert(1, "( note )")
            s = " ".join(ws) + (" , and" if i % 4 == 0 else "") + " ."
            if i % 6 == 0:  # long lines, which truncate_line cuts
                s = s + " " + " ".join(lines[(i + 1) % len(lines)].split(" ")) + " ; " + s
            out.append(" " + s)
        return out

    with open(os.path.join(text, "train_split_00.txt"), "w") as fh:
        fh.write("\n".join(wikitext(words[:300])) + "\n")
    with open(os.path.join(text, "val.txt"), "w") as fh:
        fh.write("\n".join(wikitext(words[300:])) + "\n")

    bg = os.path.join(SYNTH, "backgrounds")
    os.makedirs(bg, exist_ok=True)
    for i, (w, h, ext) in enumerate([(320, 200, "png"), (900, 520, "jpg"), (500, 640, "png"),
                                     (1000, 300, "jpg"), (640, 480, "jpeg")]):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        tone = rng.uniform(170, 240, 3).astype(np.float32)
        shade = 20 * np.sin(xx / rng.uniform(40, 200)) * np.cos(yy / rng.uniform(40, 200))
        img = tone[None, None] + shade[..., None]
        if ext != "png":
            img = img + rng.normal(0, 4, (h, w, 1)).astype(np.float32)
        img = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        path = os.path.join(bg, f"paper{i}.{ext}")
        if ext == "png":
            img.save(path, optimize=True)
        else:
            img.save(path, quality=85)


def fixture_arrays() -> dict:
    modes = []
    for mode in MODES:
        modes.append({**mode, "lines": [sample_record(s) for s in render_mode("jax", mode)]})
    _, batches = jax_pretrain_batches()
    pretrain = {"config": "dtlr_tpu_torch/configs/Latin_TPU.py", "options": PRETRAIN_OPTIONS,
                "seed": PRETRAIN_SEED, "batches": [batch_hashes(b) for b in batches]}
    return {"modes": np.asarray(json.dumps(modes)), "pretrain": np.asarray(json.dumps(pretrain)),
            "numpy_version": np.asarray(np.__version__)}


def write_fixture():
    write_assets()
    np.savez_compressed(FIXTURE, **fixture_arrays())


def load_fixture():
    with np.load(FIXTURE) as z:
        return json.loads(str(z["modes"])), json.loads(str(z["pretrain"]))


# ------------------------------------------------------------------ tests

def test_assets_are_the_helpers_output(tmp_path, monkeypatch):
    """The committed assets equal a rebuild (files byte for byte)."""
    import filecmp

    import test_torch_synth_fixture as me

    monkeypatch.setattr(me, "SYNTH", str(tmp_path / "smoke_synth"))
    me.write_assets()
    for root, _, files in os.walk(tmp_path / "smoke_synth"):
        for f in files:
            got = os.path.join(root, f)
            want = os.path.join(SYNTH, os.path.relpath(got, tmp_path / "smoke_synth"))
            assert filecmp.cmp(got, want, shallow=False), want


def test_fixture_modes_and_jaxs_plain_lines():
    """The committed modes are ``MODES``, each with its ``n`` lines, and
    the plain mode's lines (no background pool) are JAX's rendering now;
    tests/test_torch_synthetic.py holds every mode's lines to JAX's and
    the port's."""
    modes, _ = load_fixture()
    assert [{k: v for k, v in m.items() if k != "lines"} for m in modes] == MODES
    assert all(len(m["lines"]) == m["n"] for m in modes)
    plain = next(m for m in modes if m["name"] == "plain")
    spec = next(m for m in MODES if m["name"] == "plain")
    assert [sample_record(s) for s in render_mode("jax", spec)] == plain["lines"]


def test_pretrain_batches_are_jaxs():
    """The committed first two pretraining batches' hashes equal JAX's
    batches made now."""
    _, pretrain = load_fixture()
    assert pretrain["options"] == PRETRAIN_OPTIONS and pretrain["seed"] == PRETRAIN_SEED
    _, batches = jax_pretrain_batches()
    assert [batch_hashes(b) for b in batches] == pretrain["batches"]


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    write_fixture()


def test_port_pretrain_batches_hash_to_the_fixture():
    """The port's pretraining entry point's streams for the card's run
    (``line_sources`` and the recipe's batcher, as ``pretrain.run`` makes
    them: the held-out lines first) give the committed first two batches,
    hashed as chip_smoke.py's ``synth`` phase hashes the steps' batches."""
    import itertools

    import chip_smoke
    from dtlr_tpu_torch.data import canvas
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.train import pretrain
    from dtlr_tpu_torch.train.config import load_settings

    _, want = load_fixture()
    cfg, _, _, _ = load_settings(CONFIG, PRETRAIN_OPTIONS, "pretrain")
    args = pretrain.parse_args(["--dataset_file", "synthetic_line_OCR_general", "--seed",
                                str(PRETRAIN_SEED)])
    canvas.set_background_dir(None)
    charset, train_iter, val_iter = pretrain.line_sources(args, cfg, PRETRAIN_SEED)
    assert len(list(itertools.islice(val_iter, cfg.eval_set_size))) == 8
    batches = make_batcher(cfg, train_iter, True, PRETRAIN_SEED, charset.index(" "),
                           reuse=cfg.reuse, erasing=cfg.truly_random_erasing)
    try:
        got = [chip_smoke.batch_field_hashes(b) for b in itertools.islice(batches, N_BATCHES)]
    finally:
        batches.stop()
        canvas.set_background_dir(None)
    assert got == want["batches"]
