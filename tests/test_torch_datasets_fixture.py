"""The real-dataset fixture of chip_smoke.py's ``datasets`` phase
(dtlr_tpu_torch/assets/smoke_datasets/), written by ``make_datasets_fixture``
with PIL and the JAX package:

- a RIMES layout: ``RIMES-2011-Lines/labels_corr.pkl`` with the flagship's
  65-character charset (``assets/smoke_words.npz``'s), the 16 lines of
  smoke_words.npz cropped to their valid sizes, ``train`` lines 0-7 and
  ``val`` and ``test`` lines 8-15; ``Images/<id>.jpg`` written by PIL,
  lines 0-7 as RGB at quality 75 with 4:2:0 subsampling, lines 8-15 as
  gray at quality 90;
- an HWDB layout: ``HWDB/data.pkl`` with the same charset and the 16
  lines as ``HWDB/test/<idx>.png``, 0-7 gray and 8-15 RGB;
- ``smoke_datasets_ref.json``: per file the sha256 of PIL's
  ``convert("RGB")`` pixels (the card has no PIL); the JAX package's
  evaluate strings on both layouts' ``test`` split (its greedy decode:
  its ``build_dataset``, its ``BucketBatcher`` as its evaluate builds it,
  its forward with ``artifacts/r4ft_params.npz`` and the flagship's
  config) in float32 and bfloat16; and the sha256 of the images of JAX's
  first two training batches of the finetune recipe over the RIMES
  ``train`` split (its ``dataset_iter`` and ``BucketBatcher``, seed 42).

Rebuild from the repository root (needs JAX and PIL; a few minutes on the
CPU, one forward of four lines at a time):

    PYTHONPATH=.:tests python tests/test_torch_datasets_fixture.py

The fast tests load the fixture and hold the port's decoders and batcher
to the recorded hashes; the slow one rebuilds it and compares.
"""

import hashlib
import json
import os
import pickle
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase's paths and settings)

FIXTURE = chip_smoke.DATASETS_ROOT
REF = chip_smoke.DATASETS_REF
N_LINES, SPLIT = 16, 8
TRAIN_BATCHES, SEED = 2, 42


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def rimes_id(i: int) -> str:
    return f"line{i:02d}"


def layout_files(root: str):
    """(relative path, PIL mode, save options) of every line image."""
    files = []
    for i in range(N_LINES):
        rgb = i < SPLIT
        files.append((os.path.join("RIMES-2011-Lines", "Images", rimes_id(i) + ".jpg"),
                      "RGB" if rgb else "L",
                      {"quality": 75, "subsampling": 2} if rgb else {"quality": 90}))
    for i in range(N_LINES):
        files.append((os.path.join("HWDB", "test", f"{i}.png"), "L" if i < SPLIT else "RGB",
                      {"optimize": True}))
    return files


def write_layouts(root: str):
    """The two layouts from smoke_words.npz's lines; returns the texts and
    the charset."""
    from PIL import Image

    with np.load(chip_smoke.WORDS) as z:
        images, valid_hw = z["images"], z["valid_hw"]
        texts = [str(t) for t in z["texts"]]
        charset = [str(c) for c in z["charset"]]
    lines = [images[i, :h, :w] for i, (h, w) in enumerate(valid_hw)]
    rimes = {"charset": charset, "ground_truth": {
        "train": [{"id": rimes_id(i), "text": texts[i]} for i in range(SPLIT)],
        "val": [{"id": rimes_id(i), "text": texts[i]} for i in range(SPLIT, N_LINES)],
        "test": [{"id": rimes_id(i), "text": texts[i]} for i in range(SPLIT, N_LINES)]}}
    hwdb = {"charset": charset, "ground_truth": {
        "train": [], "test": [{"idx": i, "text": texts[i]} for i in range(N_LINES)]}}
    for rel, obj in ((os.path.join("RIMES-2011-Lines", "labels_corr.pkl"), rimes),
                     (os.path.join("HWDB", "data.pkl"), hwdb)):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as fh:
            pickle.dump(obj, fh, protocol=4)
    for k, (rel, mode, kw) in enumerate(layout_files(root)):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(lines[k % N_LINES]).convert(mode).save(path, **kw)
    return texts, charset


def jax_eval_strings(root: str, name: str, compute_dtype: str):
    """The JAX package's evaluate (greedy decode) on ``name``'s test split."""
    from dtlr_tpu.config import load_config
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.loaders import build_dataset
    from test_torch_smoke_words import jax_forward

    cfg = load_config(chip_smoke.FLAGSHIP_CONFIG)
    ds = build_dataset(name, "test", root=root)
    batches = list(BucketBatcher(
        (ds[i] for i in range(len(ds))), batch_size=8, scales=cfg.data_aug_scales,
        max_size=cfg.data_aug_max_size, max_targets=cfg.get_default("max_targets", 256),
        w_max=cfg.get_default("image_w_max", 1344), h_max=cfg.get_default("image_h_max", None),
        train=False, transfer_uint8=cfg.get_default("transfer_uint8", False)))
    greedy, _ = jax_forward(batches, ds.charset, compute_dtype)
    return greedy, [t for b in batches for t in b.texts]


def jax_train_batches(root: str):
    """The images' sha256 of JAX's first training batches of the finetune
    recipe over the RIMES train split (dtlr_tpu/train/finetune.py:194-220)."""
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.data.loaders import build_dataset
    from dtlr_tpu.train.finetune import dataset_iter
    from dtlr_tpu_torch.train.config import RECIPE

    ds = build_dataset("RIMES", "train", root=root)
    batcher = BucketBatcher(
        dataset_iter(ds), batch_size=RECIPE.batch_size, scales=list(RECIPE.data_aug_scales),
        max_size=RECIPE.data_aug_max_size, max_targets=RECIPE.max_targets,
        w_max=RECIPE.image_w_max, h_max=RECIPE.image_h_max, train=True,
        space_label=ds.charset.index(" "), seed=SEED, transfer_uint8=RECIPE.transfer_uint8)
    out = []
    for batch in batcher:
        out.append(sha256(batch.images))
        if len(out) == TRAIN_BATCHES:
            break
    batcher.stop()
    return out


def make_datasets_fixture(root: str = FIXTURE, ref_path: str = REF) -> dict:
    """Write the layouts and the reference (see the module docstring)."""
    import PIL
    import PIL.features
    from PIL import Image

    from dtlr_tpu.eval.metrics import corpus_cer

    texts, _ = write_layouts(root)
    pixels = {}
    for rel, _, _ in layout_files(root):
        with Image.open(os.path.join(root, rel)) as im:
            pixels[rel.replace(os.sep, "/")] = sha256(np.asarray(im.convert("RGB")))
    ref = {"pillow": PIL.__version__,
           "libjpeg_turbo": PIL.features.version_feature("libjpeg_turbo"),
           "numpy": np.__version__, "pixels_sha256": pixels, "evaluate": {},
           "finetune_batches_sha256": jax_train_batches(root)}
    for name in ("RIMES", "HWDB"):
        for dt in ("float32", "bfloat16"):
            strings, gts = jax_eval_strings(root, name, dt)
            ref["evaluate"].setdefault(name, {"texts": gts})[dt] = {
                "strings": strings, "cer_vs_texts": corpus_cer(strings, gts)}
    with open(ref_path, "w") as fh:
        json.dump(ref, fh, indent=1, ensure_ascii=False)
    return ref


def load_ref() -> dict:
    with open(REF) as fh:
        return json.load(fh)


def test_fixture_is_small_and_complete():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert total < 2 << 20, total
    ref = load_ref()
    assert len(ref["pixels_sha256"]) == 2 * N_LINES
    for name, n in (("RIMES", N_LINES - SPLIT), ("HWDB", N_LINES)):
        for dt in ("float32", "bfloat16"):
            assert len(ref["evaluate"][name][dt]["strings"]) == n
    assert len(ref["finetune_batches_sha256"]) == TRAIN_BATCHES


@pytest.mark.parametrize("native", [True, False])
def test_decoders_give_pils_pixels(native):
    from dtlr_tpu_torch.data.images import decode_image

    for rel, want in load_ref()["pixels_sha256"].items():
        with open(os.path.join(FIXTURE, rel), "rb") as fh:
            assert sha256(decode_image(fh.read(), native=native)) == want, rel


def test_port_training_batches_are_jaxs():
    """The port's finetune batcher over the RIMES train split (what
    ``finetune --dataset_file RIMES`` builds) against JAX's hashes."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import build_dataset, dataset_iter
    from dtlr_tpu_torch.train.config import RECIPE

    ds = build_dataset("RIMES", "train", root=FIXTURE)
    batcher = make_batcher(RECIPE, dataset_iter(ds), True, SEED, ds.charset.index(" "))
    got = [sha256(batcher._make_batch().images) for _ in range(TRAIN_BATCHES)]
    assert got == load_ref()["finetune_batches_sha256"]


@pytest.mark.slow
def test_regenerates(tmp_path):
    """The fixture rebuilt equals the committed one: every file byte for
    byte, the hashes and JAX's strings exactly."""
    root = str(tmp_path / "fixture")
    ref = make_datasets_fixture(root, str(tmp_path / "ref.json"))
    assert ref == load_ref()
    for rel, _, _ in layout_files(root):
        with open(os.path.join(root, rel), "rb") as a, open(os.path.join(FIXTURE, rel), "rb") as b:
            assert a.read() == b.read(), rel


if __name__ == "__main__":
    make_datasets_fixture()
