"""The port's real-dataset loaders (dtlr_tpu_torch/data/loaders.py) against
the JAX package's (dtlr_tpu/data/loaders.py), and the entry points that
build them, on layouts written here in the reference's formats: the
label pickles of tests/test_loaders.py's IAM, READ and copiale layouts,
plus HWDB, RIMES, borg and Google1000 ones, with line images written by
PIL as JPEG and PNG (and TIFF for the ciphers).

- Every dataset: the same length, charset, item order, texts, labels and
  token mode as JAX's, and the same pixels for each PNG, JPEG and TIFF
  line (JAX decodes with PIL).
- ``evaluate --dataset RIMES`` at ``TINY`` gives the record that
  ``--lines`` gives over an npz of the same decoded pixels.
- ``finetune --dataset_file RIMES`` takes a step at ``TINY`` and reads
  the ``val`` split; ``pretrain --dataset_file RIMES --eval`` reads it,
  and a training run is refused (no character boxes).
- ``rescore``'s ``open_lines`` builds a ``dataset: RIMES`` config and
  renders a ``dataset: synthetic`` one, and
  ``dtlr_tpu_torch/ngram/smoke_words.yaml`` parses to the settings of
  chip_smoke.py's ``ngram`` phase.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from dtlr_tpu.data import loaders as JL
from dtlr_tpu_torch.data import loaders as TL
from dtlr_tpu_torch.eval import evaluate as TE
from dtlr_tpu_torch.models.dino import FLAGSHIP
from dtlr_tpu_torch.ngram import rescore
from dtlr_tpu_torch.train import finetune, pretrain
from dtlr_tpu_torch.train.config import RECIPE, apply_options
from dtlr_tpu_torch.train.init import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["abc de", "ce bad", "a", "deed cab", "bead", "dab ace"]
CHARSET = list("abcde ")
TINY_OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
                "dim_feedforward=64", "encoder_win=8", "compute_dtype=float32"]
DATA_OPTIONS = ["data_aug_scales=[64]", "data_aug_max_size=256", "image_w_max=256",
                "image_h_max=64"]


def line_image(i: int, mode: str) -> Image.Image:
    """A dark stroke pattern on paper, 20-40 rows by 60-140 columns."""
    rng = np.random.default_rng(i)
    h, w = 20 + 4 * i, 60 + 16 * i
    yy, xx = np.mgrid[0:h, 0:w]
    ink = (np.sin(xx / (2.0 + i)) > 0.6) & (np.abs(yy - h / 2) < h / 3)
    rgb = np.where(ink[..., None], 40, 225) + rng.integers(-20, 20, (h, w, 3))
    return Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).convert(mode)


def write(path, im: Image.Image, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im.save(path, **kw)


def dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """All seven layouts under one data root."""
    r = str(tmp_path_factory.mktemp("data"))
    # IAM: the default charset; .jpg under imgs/, .png under original/
    iam = {"charset": None, "ground_truth": {
        "train": [{"id": f"a01-{i}", "text": TEXTS[i], "folder": "a01"} for i in range(3)],
        "valid": [{"id": "v01-0", "text": "Hi!", "folder": "v01"}], "test": []}}
    dump(os.path.join(r, "IAM_new", "labels.pkl"), iam)
    for i, ex in enumerate(iam["ground_truth"]["train"] + iam["ground_truth"]["valid"]):
        write(os.path.join(r, "IAM_new", "data", "imgs", "lines", ex["id"] + ".jpg"),
              line_image(i, "RGB"), quality=80)
        write(os.path.join(r, "IAM_new", "data", "original", "lines", ex["id"] + ".png"),
              line_image(i, "L"))
    # READ: code points, '¬' dropped, a dict split, one item with a path
    read = {"charset": [ord(c) for c in "abcde ¬"], "ground_truth": {
        "valid": {0: {"idx": 0, "text": "ab¬c"},
                  1: {"idx": 1, "text": "de a", "path": "READ_2016/images/valid/x1.jpeg"}},
        "train": {}, "test": {}}}
    dump(os.path.join(r, "READ_2016", "labels.pkl"), read)
    write(os.path.join(r, "READ_2016", "images", "valid", "0.jpeg"), line_image(0, "L"),
          format="JPEG", quality=90)
    write(os.path.join(r, "READ_2016", "images", "valid", "x1.jpeg"), line_image(1, "RGB"),
          format="JPEG", subsampling=1)
    # RIMES: character charset, train / val / test lists, .jpg
    rimes = {"charset": CHARSET, "ground_truth": {
        "train": [{"id": f"tr{i}", "text": TEXTS[i]} for i in range(4)],
        "val": [{"id": f"va{i}", "text": TEXTS[4 + i]} for i in range(2)],
        "test": [{"id": f"te{i}", "text": TEXTS[i]} for i in range(2)]}}
    dump(os.path.join(r, "RIMES-2011-Lines", "labels_corr.pkl"), rimes)
    for split in rimes["ground_truth"].values():
        for k, ex in enumerate(split):
            write(os.path.join(r, "RIMES-2011-Lines", "Images", ex["id"] + ".jpg"),
                  line_image(k + len(ex["id"]), "RGB" if k % 2 else "L"), quality=75,
                  subsampling=2)
    # HWDB: the file name under 'idx', val aliases test, .png
    hwdb = {"charset": list("中文字 "), "ground_truth": {
        "train": [], "test": [{"idx": 7, "text": "中文"}, {"idx": 9, "text": "字 中"}]}}
    dump(os.path.join(r, "HWDB", "data.pkl"), hwdb)
    write(os.path.join(r, "HWDB", "test", "7.png"), line_image(2, "L"))
    write(os.path.join(r, "HWDB", "test", "9.png"), line_image(3, "RGB"))
    # the ciphers: copiale tokens, borg characters, .tif images
    dump(os.path.join(r, "old_cipher", "labels_Copiale.pkl"), {
        "charset": ["sym_a", "sym_b", "dot"],
        "ground_truth": {"test": [{"id": "page1.tif", "text": "sym_a dot sym_b"}]}})
    write(os.path.join(r, "copiale", "images", "page1.tif"), line_image(0, "RGB"))
    dump(os.path.join(r, "old_cipher", "labels_Borg.pkl"), {
        "charset": list("xyz"), "ground_truth": {"val": {"b1": "xyzzy", "b2": {"text": "zx"}}}})
    for k, fid in enumerate(("b1", "b2")):
        write(os.path.join(r, "old_cipher", "Borgimages", fid + ".tif"), line_image(k, "L"))
    # Google1000: the permuted charset, images by key (a PNG and a JPEG)
    dump(os.path.join(r, "google", "labels.pkl"), {"ground_truth": {
        "valid": {"p1.png": "The cat", "p2.jpg": {"text": "a dog!"}}}})
    write(os.path.join(r, "google", "images", "p1.png"), line_image(4, "RGB"))
    write(os.path.join(r, "google", "images", "p2.jpg"), line_image(5, "RGB"), quality=60)
    return r


CASES = [("IAM", "train", {}), ("IAM", "val", {}), ("IAM", "train", {"image_folder": "original"}),
         ("READ", "val", {}), ("RIMES", "train", {}), ("RIMES", "valid", {}),
         ("RIMES", "test", {}), ("HWDB", "val", {}), ("copiale", "test", {}),
         ("borg", "val", {}), ("google1000", "val", {})]


@pytest.mark.parametrize("name,mode,kw", CASES)
def test_dataset_equals_jax(root, name, mode, kw):
    port = TL.build_dataset(name, mode, root=root, **kw)
    jax = JL.build_dataset(name, mode, root=root, **kw)
    assert len(port) == len(jax) > 0
    assert port.charset == jax.charset
    assert port.items == jax.items
    assert bool(port.token_based) == bool(getattr(jax, "token_based", False))
    for i in range(len(port)):
        assert port.text_of(i) == jax.text_of(i)
        ex = port.items[i]
        np.testing.assert_array_equal(port.encode(ex["text"], port.drop),
                                      jax[i]["labels"] if name not in ("copiale", "borg")
                                      else jax.encode(ex["text"]))
        got, want = port[i], jax[i]
        assert got["text"] == want["text"] and got["boxes"] is None
        np.testing.assert_array_equal(got["labels"], want["labels"] if name not in (
            "copiale", "borg") else jax.encode(ex["text"]))
        assert got["image"].dtype == want["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])


def test_registry_keeps_only_the_renderer_refused(root):
    """No dataset is refused: the renderer's name builds the generator."""
    assert not hasattr(TL, "NEEDS_PIL")
    from dtlr_tpu_torch.data.synthetic import SyntheticLineGenerator

    gen = TL.build_dataset("synthetic_line_OCR_general", "train", seed=1, max_words=2)
    assert isinstance(gen, SyntheticLineGenerator) and len(gen.charset) == 166
    assert TL.permuted_latin_charset() == JL.permuted_latin_charset()
    with pytest.raises(KeyError, match="split 'train'"):
        TL.build_dataset("borg", "train", root=root)
    with pytest.raises(FileNotFoundError):
        TL.build_dataset("IAM", "test", root=os.path.join(root, "absent"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A TINY snapshot whose class head fits the RIMES layout's charset."""
    d = tmp_path_factory.mktemp("tiny")
    _, model_cfg = apply_options(RECIPE, dataclasses.replace(FLAGSHIP, compute_dtype="float32"),
                                 TINY_OPTIONS)
    tree = init_params(dataclasses.replace(model_cfg, dn_labelbook_size=len(CHARSET) + 1),
                       len(CHARSET), torch.Generator().manual_seed(0))
    np.savez(d / "tiny.npz", **tree)
    return str(d / "tiny.npz")


def test_evaluate_dataset_equals_lines(root, tiny, tmp_path):
    ds = TL.build_dataset("RIMES", "test", root=root)
    decoded = [np.round(ds[i]["image"] * 255).astype(np.uint8) for i in range(len(ds))]
    hmax, wmax = max(d.shape[0] for d in decoded), max(d.shape[1] for d in decoded)
    images = np.zeros((len(decoded), hmax, wmax, 3), np.uint8)
    for i, d in enumerate(decoded):
        images[i, :d.shape[0], :d.shape[1]] = d
    texts = [ds.text_of(i) for i in range(len(ds))]
    np.savez(tmp_path / "rimes.npz", images=images, texts=np.asarray(texts),
             valid_hw=np.asarray([d.shape[:2] for d in decoded], np.int32),
             charset=np.asarray(ds.charset))
    common = ["--params", tiny, "--device", "cpu", "--batch_size", "2", "--NMS", "0.5",
              "--TH", "0.1", "--options", *TINY_OPTIONS, *DATA_OPTIONS]
    by_dataset = TE.main(["--dataset", "RIMES", "--mode", "test", "--data_root", root,
                          "--out_dir", str(tmp_path / "a"), *common])
    by_lines = TE.main(["--lines", str(tmp_path / "rimes.npz"), "--out_dir",
                        str(tmp_path / "b"), *common])
    assert by_dataset["lines"] == by_lines["lines"] == 2
    assert by_dataset["records"] == by_lines["records"]
    assert by_dataset["best"]["preds"] == by_lines["best"]["preds"]
    assert by_dataset["best"]["gts"] == TEXTS[:2]
    default_dir = TE.main(["--dataset", "RIMES", "--data_root", root, *common])["out_dir"]
    assert default_dir.endswith(os.path.join("stats_dect", "RIMES"))


def test_finetune_and_pretrain_take_the_dataset(root, tiny, tmp_path):
    res = finetune.main(["--dataset_file", "RIMES", "--data_root", root, "--pretrain_dir", tiny,
                         "--full_model", "--output_dir", str(tmp_path / "ft"), "--device", "cpu",
                         "--epochs", "1", "--options", *TINY_OPTIONS, *DATA_OPTIONS,
                         "batch_size=2", "max_iterations=1"])
    assert res["train"]["iterations"] == 1 and np.isfinite(res["train"]["loss"])
    assert res["eval"]["n"] == 2  # the val split
    common = ["--dataset_file", "RIMES", "--data_root", root, "--params", tiny, "--device",
              "cpu", "--options", *TINY_OPTIONS, *DATA_OPTIONS, "batch_size=2",
              "eval_set_size=2"]
    ev = pretrain.main([*common, "--output_dir", str(tmp_path / "pt"), "--eval"])
    assert ev["evals"][0]["n"] == 2
    with pytest.raises(ValueError, match="no character boxes"):
        pretrain.main([*common, "--output_dir", str(tmp_path / "pt2"), "--epochs", "1",
                       "--steps_per_epoch", "1"])


def test_rescore_opens_a_dataset_and_parses_the_shipped_config(root):
    ds = rescore.open_lines({"dataset": "RIMES", "data_root": root})
    assert isinstance(ds, TL.RIMES) and [e["id"] for e in ds.items] == ["te0", "te1"]
    assert len(rescore.open_lines({"dataset": "RIMES", "data_root": root, "mode": "val"})) == 2
    rendered = rescore.open_lines({"dataset": "synthetic", "num_images": 2})
    assert len(rendered) == 2 and len(rendered.charset) == 166
    assert rendered[0]["image"].dtype == np.float32 and rendered[0]["text"]
    ycfg = rescore.load_yaml(os.path.join(REPO, "dtlr_tpu_torch", "ngram", "smoke_words.yaml"))
    import chip_smoke

    want = {"lines": "dtlr_tpu_torch/assets/smoke_words.npz",
            "params": "artifacts/r4ft_params.npz",
            "model_config": "outputs/finetune_r4b/config_cfg.py",
            "lm_corpus": "artifacts/corpus_words_train.txt"}
    assert {k: ycfg[k] for k in want} == want
    for key, value in chip_smoke.NGRAM_SETTINGS.items():
        if key != "lm_corpus":
            assert ycfg[key] == value, key
    for key in ("lines", "params", "model_config", "lm_corpus"):
        assert os.path.exists(os.path.join(REPO, ycfg[key])), key
