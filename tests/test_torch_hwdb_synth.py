"""The port's HWDB_synth stream (dtlr_tpu_torch/data/hwdb_synth.py)
against the JAX package's (dtlr_tpu/data/hwdb_synth.py) on the committed
GNT fixture bank (``dtlr_tpu_torch/assets/smoke_hwdb.gnt``): the parsed
records, the generated lines (image, labels, boxes, text) and the
pretraining recipe's first batches over the stream, all bit for bit; the
label space from a charset pickle. JAX's upscale is PIL's; the port's is
its copy of PIL's 8-bit resampler.

``python tests/test_torch_hwdb_synth.py`` (repository root,
``PYTHONPATH=.:tests``, needs JAX and PIL) rewrites the fixture bank and
``smoke_hwdb_ref.json``, JAX's first batches that chip_smoke.py's
``pretrain`` phase holds the card's run to.
"""

import hashlib
import importlib.util
import json
import os
import pickle
import shutil
import struct
import sys

import numpy as np
import pytest

from dtlr_tpu.data import batching as JB
from dtlr_tpu.data import hwdb_synth as JH
from dtlr_tpu_torch.config import load_config, parse_options
from dtlr_tpu_torch.config.loader import apply_options
from dtlr_tpu_torch.data import batching as TB
from dtlr_tpu_torch.data import hwdb_synth as TH
from dtlr_tpu_torch.data.loaders import build_dataset
from dtlr_tpu_torch.train.config import from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_hwdb.gnt")
REF = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_hwdb_ref.json")
CONFIG = os.path.join(REPO, "dtlr_tpu_torch", "configs", "Chinese_TPU.py")
#: scripts/hwdb_real.sh's options (eval_set_size 8, not 64, in the card's run)
HWDB_OPTIONS = ["batch_size=4", "max_targets=64", "data_aug_scales=[96]",
                "data_aug_max_size=1024", "image_w_max=1024", "image_h_max=160",
                "hwdb_glyphs_per_line=[5,25]", "eval_set_size=8"]
#: the bank: GB2312 level-1 characters, exemplars of each
N_CHARS, PER_CHAR = 36, 3
#: the card's run: --seed 0 as scripts/hwdb_real.sh, its first batches
SEED, N_BATCHES = 0, 3


def _fake_gnt():
    spec = importlib.util.spec_from_file_location(
        "make_fake_gnt", os.path.join(REPO, "scripts", "make_fake_gnt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bank_chars():
    """N_CHARS GB2312 level-1 characters, one from each of rows 0xB0 on."""
    return [bytes([0xB0 + i, 0xA1 + (7 * i) % 94]).decode("gb2312") for i in range(N_CHARS)]


def make_gnt(path: str) -> None:
    """The fixture bank: class-consistent stroke glyphs (a skeleton per
    character, jittered per exemplar) of scripts/make_fake_gnt.py, in
    CASIA's GNT records."""
    fake = _fake_gnt()
    rng = np.random.default_rng(0)
    with open(path, "wb") as fh:
        for ci, c in enumerate(bank_chars()):
            skeleton = fake.char_skeleton(np.random.default_rng(100_003 + ci))
            for _ in range(PER_CHAR):
                bmp = fake.draw_glyph(skeleton, rng)
                h, w = bmp.shape
                fh.write(struct.pack("<I2sHH", 10 + w * h, c.encode("gbk"), w, h))
                fh.write(bmp.tobytes())


def bank_root(tmp_dir) -> str:
    """A data root with the fixture bank under HWDB_gnt/, as the entry
    points take it."""
    os.makedirs(os.path.join(tmp_dir, "HWDB_gnt"), exist_ok=True)
    shutil.copy(BANK, os.path.join(tmp_dir, "HWDB_gnt", "smoke_hwdb.gnt"))
    return str(tmp_dir)


def recipe():
    cfg = apply_options(load_config(CONFIG), parse_options(HWDB_OPTIONS))
    return from_config(cfg, "pretrain")[0]


def batch_hashes(batch) -> dict:
    h = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    return {"images": h(np.asarray(batch.images, np.uint8)), "labels": h(batch.labels),
            "valid": h(batch.valid), "valid_hw": h(batch.valid_hw),
            "boxes": h(np.asarray(batch.boxes, np.float32)), "texts": list(batch.texts)}


def jax_batches(root: str, n: int = N_BATCHES):
    """JAX's pretraining batches over the stream
    (dtlr_tpu/train/pretrain.py:171-229) with the recipe of Chinese_TPU.py
    and hwdb_real.sh's options."""
    cfg = recipe()
    src = JH.SyntheticHWDBGenerator(root=root, seed=SEED,
                                    glyphs_per_line=tuple(cfg.hwdb_glyphs_per_line))
    batcher = JB.BucketBatcher(
        iter(src), batch_size=cfg.batch_size, scales=cfg.data_aug_scales,
        max_size=cfg.data_aug_max_size, max_targets=cfg.max_targets, w_max=cfg.image_w_max,
        h_max=cfg.image_h_max, train=True, truly_random_erasing=cfg.truly_random_erasing,
        instance_erasing=cfg.truly_random_erasing, space_label=-1, seed=SEED,
        transfer_uint8=cfg.transfer_uint8, reuse=cfg.reuse)
    return [batcher._make_batch() for _ in range(n)]


def port_batches(root: str, n: int = N_BATCHES):
    cfg = recipe()
    src = TH.hwdb_stream(root, SEED, cfg.hwdb_charset_pickle, cfg.hwdb_glyphs_per_line)
    batcher = TB.make_batcher(cfg, iter(src), True, SEED, -1, reuse=cfg.reuse,
                              erasing=cfg.truly_random_erasing)
    return [batcher._make_batch() for _ in range(n)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bank_root(tmp_path_factory.mktemp("hwdb"))


def test_fixture_bank_is_the_helpers_output(tmp_path):
    make_gnt(str(tmp_path / "bank.gnt"))
    with open(BANK, "rb") as a, open(tmp_path / "bank.gnt", "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(BANK) <= 400_000


def test_parse_gnt_and_bank_match_jax(root):
    got, want = TH.parse_gnt(BANK), JH.parse_gnt(BANK)
    assert len(got) == len(want) == N_CHARS * PER_CHAR
    for (c, b), (jc, jb) in zip(got, want):
        assert c == jc and np.array_equal(b, jb)
    assert len(TH.parse_gnt(BANK, max_samples=5)) == 5
    bank = TH.GlyphBank(os.path.join(root, "HWDB_gnt"))
    assert bank.chars == JH.GlyphBank(os.path.join(root, "HWDB_gnt")).chars
    assert bank.chars == sorted(bank_chars())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_lines_match_jax_bit_for_bit(root, seed):
    got = TH.SyntheticHWDBGenerator(root=root, seed=seed, glyphs_per_line=(5, 25))
    want = JH.SyntheticHWDBGenerator(root=root, seed=seed, glyphs_per_line=(5, 25))
    for _ in range(4):
        g, w = got.sample(), want.sample()
        assert g["text"] == w["text"]
        for k in ("image", "labels", "boxes"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_registry_builds_the_stream(root):
    ds = build_dataset("HWDB_synth", "train", root=root, seed=3, glyphs_per_line=(5, 6))
    want = JH.SyntheticHWDBGenerator(root=root, seed=3, glyphs_per_line=(5, 6))
    assert ds.charset == want.charset
    assert np.array_equal(next(iter(ds))["image"], want.sample()["image"])


def test_recipe_batches_match_jax_and_the_committed_reference(root):
    got, want = port_batches(root), jax_batches(root)
    for g, w in zip(got, want):
        for f in ("images", "valid_hw", "labels", "boxes", "valid"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert g.texts == w.texts
    with open(REF) as fh:
        ref = json.load(fh)
    assert [batch_hashes(b) for b in got] == ref["batches"]
    assert ref["seed"] == SEED and ref["options"] == HWDB_OPTIONS


def test_label_space_from_a_charset_pickle(root, tmp_path):
    """A config's hwdb_charset_pickle sets the label space (code points or
    characters), the bank's characters otherwise; the lines use the
    bank's characters that it has, labelled by their index in it."""
    space = ["一"] + sorted(bank_chars())[::2] + ["丁"]
    path = tmp_path / "charset.pkl"
    with open(path, "wb") as fh:
        pickle.dump([ord(c) for c in space[:3]] + space[3:], fh)
    assert TH.hwdb_charset(str(path)) == space and TH.hwdb_charset(None) is None
    gen = TH.hwdb_stream(root, 5, str(path), (5, 9))
    want = JH.SyntheticHWDBGenerator(root=root, seed=5, charset=space, glyphs_per_line=(5, 9))
    assert gen.charset == space
    for _ in range(3):
        g, w = gen.sample(), want.sample()
        assert g["text"] == w["text"] and np.array_equal(g["labels"], w["labels"])
        assert all(space[l] == c for l, c in zip(g["labels"], g["text"]))
        assert set(g["text"]) <= set(space[1:-1])


def write_reference():
    import tempfile

    make_gnt(BANK)
    with tempfile.TemporaryDirectory() as d:
        batches = jax_batches(bank_root(d))
    with open(REF, "w") as fh:
        json.dump({"config": "dtlr_tpu_torch/configs/Chinese_TPU.py", "options": HWDB_OPTIONS,
                   "seed": SEED, "numpy_version": np.__version__,
                   "batches": [batch_hashes(b) for b in batches]}, fh, indent=1,
                  ensure_ascii=False)
    print(f"wrote {BANK} ({os.path.getsize(BANK)} bytes) and {REF}")


if __name__ == "__main__":
    sys.exit(write_reference())
