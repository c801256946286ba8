"""The committed references of ``chip_smoke.py``'s ``data`` and ``sweep``
phases, written by the JAX package on the CPU:

- ``dtlr_tpu_torch/assets/smoke_data.npz`` (``make_data_asset``): the
  first 4 batches of the JAX package's ``BucketBatcher`` in the
  finetune recipe over ``smoke_lines.npz`` (train, seed 42: resize to
  128 rows, at most 192, four random erasings, 64-row buckets, uint8)
  and in the pretraining recipe over ``smoke_detect.npz`` (the same with
  the reuse pool of 4, character boxes), the lines in JAX's training
  order (``dataset_iter``: reshuffled from ``default_rng(0)``). Per batch
  the sha256 of the uint8 images and the labels, validity, valid sizes
  and boxes; numpy's version beside them.
- ``dtlr_tpu_torch/assets/smoke_sweep.json`` (``make_sweep_asset``): the
  JAX package's ``evaluate --sweep`` on ``smoke_lines.npz`` with
  ``artifacts/r4ft_params.npz`` and the flagship's config
  (outputs/finetune_r4b/config_cfg.py) in float32 and in bfloat16, run by
  its own ``main`` with its forward memoized per batch
  (``run_jax_evaluate``): every point's record, the skipped points, the
  all-empty TH and the best record.

Rebuild both with ``python tests/test_torch_smoke_data.py`` from the
repository root with ``PYTHONPATH=.`` (needs JAX; a few minutes on the
CPU). The fast tests below load them and hold the port's batcher to the
data asset on the CPU.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "dtlr_tpu_torch", "assets")
DATA = os.path.join(ASSETS, "smoke_data.npz")
SWEEP = os.path.join(ASSETS, "smoke_sweep.json")
LINES = os.path.join(ASSETS, "smoke_lines.npz")
DETECT_LINES = os.path.join(ASSETS, "smoke_detect.npz")
PARAMS = os.path.join(REPO, "artifacts", "r4ft_params.npz")
FLAGSHIP_CFG = os.path.join(REPO, "outputs", "finetune_r4b", "config_cfg.py")
N_BATCHES, SEED = 4, 42
#: recipe -> (lines, reuse)
RECIPES = {"finetune": (LINES, 1), "pretrain": (DETECT_LINES, 4)}
FIELDS = ("labels", "valid", "valid_hw", "boxes")


def image_sha256(images) -> str:
    return hashlib.sha256(np.ascontiguousarray(images, np.uint8).tobytes()).hexdigest()


def jax_batches(recipe: str, n: int = N_BATCHES):
    """The JAX package's first ``n`` training batches of ``recipe``."""
    from dtlr_tpu.data.batching import BucketBatcher
    from dtlr_tpu.train.finetune import dataset_iter
    from dtlr_tpu_torch.data.loaders import NpzLines
    from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION

    cfg = RECIPE if recipe == "finetune" else RECIPE_DETECTION
    path, reuse = RECIPES[recipe]
    ds = NpzLines(path)
    batcher = BucketBatcher(
        dataset_iter(ds), batch_size=cfg.batch_size, scales=[128], max_size=1024,
        max_targets=64, w_max=1024, h_max=192, train=True, space_label=ds.charset.index(" "),
        seed=SEED, transfer_uint8=True, reuse=reuse)
    out = []
    for batch in batcher:
        out.append(batch)
        if len(out) == n:
            break
    batcher.stop()
    return out


def make_data_asset(path: str = DATA) -> None:
    from test_torch_transforms import load_native_helper

    assert load_native_helper()  # JAX's upscale must take its C++ helper
    arrays = {"numpy_version": np.asarray([np.__version__])}
    for recipe in RECIPES:
        batches = jax_batches(recipe)
        arrays[f"{recipe}_images_sha256"] = np.asarray([image_sha256(b.images) for b in batches])
        arrays[f"{recipe}_images_shape"] = np.asarray([b.images.shape for b in batches])
        for f in FIELDS:
            arrays[f"{recipe}_{f}"] = np.stack([getattr(b, f) for b in batches])
    np.savez_compressed(path, **arrays)


def jax_flagship_forward(compute_dtype: str):
    """The JAX package's eval forward of the flagship checkpoint."""
    import jax

    from dtlr_tpu.config import load_config
    from dtlr_tpu.models.dino import build_dino_from_config
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu.train.checkpoints import load_params_npz

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(FLAGSHIP_CFG)
    tree = load_params_npz(PARAMS)["params"]
    cfg.num_classes = tree["class_embed"]["fc"]["kernel"].shape[-1]
    cfg.dn_labelbook_size = tree["label_enc"].shape[0] - 1
    cfg.compute_dtype = compute_dtype
    model = build_dino_from_config(cfg)
    fwd = jax.jit(lambda im, vh: model.apply({"params": tree}, prep_images(im, vh), vh, None,
                                             train=False))

    def forward(images, valid_hw):
        o = fwd(images, valid_hw)
        return np.asarray(o["pred_logits"], np.float32), np.asarray(o["pred_boxes"], np.float32)

    return forward


def make_sweep_asset(path: str = SWEEP) -> None:
    import tempfile

    from dtlr_tpu_torch.data.loaders import NpzLines
    from test_torch_evaluate_cli import run_jax_evaluate
    from test_torch_transforms import load_native_helper

    assert load_native_helper()
    out = {}
    for dt in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
            records, skipped = run_jax_evaluate(
                mp, jax_flagship_forward(dt),
                ["--dataset", "lines", "--config", FLAGSHIP_CFG, "--ckpt_dir", tmp,
                 "--sweep", "--batch_size", "8"],
                dataset=NpzLines(LINES))
            with open(os.path.join(tmp, "stats_dect", "lines", "stats.json")) as fh:
                best = json.load(fh)
        # every point after the all-empty one is skipped
        out[dt] = {"records": records, "skipped": skipped, "best": best,
                   "empty_th": records[-1]["TH"] if skipped else None}
    out["numpy_version"] = np.__version__
    out["lines"] = os.path.relpath(LINES, REPO)
    out["params"] = os.path.relpath(PARAMS, REPO)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)


def test_data_asset_loads():
    with np.load(DATA) as z:
        for recipe in RECIPES:
            assert z[f"{recipe}_images_sha256"].shape == (N_BATCHES,)
            assert (z[f"{recipe}_images_shape"][:, 1:] == (128, 1024, 3)).all()
            assert z[f"{recipe}_labels"].shape == (N_BATCHES, 8, 64)
            assert z[f"{recipe}_boxes"].shape == (N_BATCHES, 8, 64, 4)
            assert z[f"{recipe}_valid_hw"].shape == (N_BATCHES, 8, 2)
        # the pretraining batches carry boxes, the finetune's none
        assert z["pretrain_boxes"].any() and not z["finetune_boxes"].any()


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_port_batches_match_the_data_asset(recipe):
    """The port's batcher, built as its entry points build it, gives the
    committed batches bit for bit."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import NpzLines, dataset_iter
    from dtlr_tpu_torch.train.config import RECIPE, RECIPE_DETECTION

    cfg = RECIPE if recipe == "finetune" else RECIPE_DETECTION
    path, reuse = RECIPES[recipe]
    ds = NpzLines(path)
    batcher = make_batcher(cfg, dataset_iter(ds), True, SEED, ds.charset.index(" "),
                           reuse=cfg.reuse)
    got = []
    for batch in batcher:
        got.append(batch)
        if len(got) == N_BATCHES:
            break
    batcher.stop()
    assert cfg.reuse == reuse
    with np.load(DATA) as z:
        assert [image_sha256(b.images) for b in got] == list(z[f"{recipe}_images_sha256"])
        for f in FIELDS:
            np.testing.assert_array_equal(np.stack([getattr(b, f) for b in got]),
                                          z[f"{recipe}_{f}"], err_msg=f)


def test_sweep_asset_loads():
    with open(SWEEP) as fh:
        ref = json.load(fh)
    for dt in ("float32", "bfloat16"):
        r = ref[dt]
        assert len(r["records"]) + len(r["skipped"]) == 90
        assert {"TH", "NMS", "CER", "WER", "CER_corpus"} <= set(r["records"][0])
        best = min(r["records"], key=lambda x: x["CER"])
        assert r["best"]["CER"] == best["CER"]


@pytest.mark.slow
def test_data_asset_is_current(tmp_path):
    make_data_asset(str(tmp_path / "data.npz"))
    with np.load(tmp_path / "data.npz") as new, np.load(DATA) as old:
        for k in old.files:
            if k != "numpy_version":
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)


@pytest.mark.slow
def test_sweep_asset_is_current(tmp_path):
    make_sweep_asset(str(tmp_path / "sweep.json"))
    new, old = (json.load(open(p)) for p in (tmp_path / "sweep.json", SWEEP))
    for dt in ("float32", "bfloat16"):
        assert new[dt] == old[dt]


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    which = sys.argv[1:] or ["data", "sweep"]
    if "data" in which:
        make_data_asset()
    if "sweep" in which:
        make_sweep_asset()
