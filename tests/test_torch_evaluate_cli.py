"""The port's evaluate CLI (dtlr_tpu_torch/eval/evaluate.py) against the
JAX package's (dtlr_tpu/eval/evaluate.py ``main``).

``run_jax_evaluate`` runs the JAX package's own ``main`` (its grid, its
all-empty skip, its best point, its files) with the model behind its
trainer replaced by a given forward (``_eval_fn``) and its dataset by
given lines. JAX's loop runs the forward again for every grid point;
the replacement memoizes it per batch, which changes nothing since the
eval forward is deterministic. JAX's batchers are recorded and stopped.

- (a) ``test_sweep_on_jax_outputs``: one set of seeded outputs per batch
  fed to both CLIs (the port's forward replaced the same way), in every
  metric mode, with and without ``--max_images``, the whole sweep, the
  sweep around one TH, one point and the greedy decode: the same
  records, skipped points, best point and files. Exactly, but ``detections.json``, whose scores and boxes
  come from two sigmoids: within 1e-6.
- ``test_hwdb_stream_with_a_runs_config``: as (a), on the HWDB_synth
  lines that both CLIs draw from the fixture glyph bank (seed 321 +
  ``--eval_seed``), with a training run's dumped ``config_cfg.py`` as
  ``--config`` (Chinese_TPU.py and scripts/hwdb_real.sh's options), in
  the ``chinese`` metric mode at hwdb_real.sh's point: the same records
  and files, exactly.
- ``test_rendered_eval_set``: as (a), on the Latin lines that both CLIs
  render (``--dataset synthetic``, seed 123 + ``--eval_seed``, JAX's
  generator given the banked faces): the same batches reach the forward,
  and the records and files are the same, exactly.
- (b) ``test_cli_end_to_end_tiny``: the CLI end to end at ``TINY`` on
  weights exported from the JAX model, over the lines JAX's synthetic
  eval set draws (seed 123), written to an npz as ``synthetic_lines``
  does, on the lines whose two-stage selection is JAX's (the others must
  differ by a near tie of proposal scores): each point's CER, WER and
  corpus CER within 0.02 of JAX's (about a character in a line of 50:
  float32 on both sides, and a score within the forward's 1e-4 of a TH
  could move one), the same skipped points and best point.
"""

import ast
import hashlib
import json
import os
import types

import numpy as np
import pytest
import torch

from dtlr_tpu_torch.eval import evaluate as TE
from test_torch_transforms import native_helper  # noqa: F401 (JAX's resize helper, autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def image_key(images) -> str:
    return hashlib.sha1(np.ascontiguousarray(np.asarray(images)).tobytes()).hexdigest()


def jax_config(path, scales, max_size, w_max, num_classes, extra=""):
    """A config file for the JAX CLI: the data settings and the class count
    (its model is never built from it here)."""
    path.write_text(
        f"num_classes = {num_classes}\ndn_labelbook_size = {num_classes + 1}\n"
        f"data_aug_scales = {list(scales)}\ndata_aug_max_size = {max_size}\n"
        f"image_w_max = {w_max}\nmax_targets = 64\ntransfer_uint8 = True\n"
        f"num_select = 300\n{extra}")
    return str(path)


def run_jax_evaluate(monkeypatch, forward, argv, dataset=None):
    """The JAX package's evaluate ``main(argv)`` with ``forward(images,
    valid_hw) -> (logits, boxes)`` as its model (memoized per batch) and,
    if given, ``dataset`` as its dataset. Returns the records it logged
    and the points it skipped. JAX's NMS keep mask, which its sweep
    computes again for every TH of an NMS value (eagerly, a fresh scan
    compile each call), is memoized by its inputs: the same function of
    the same arrays, computed once."""
    from dtlr_tpu.eval import decode as JD
    from dtlr_tpu.eval import evaluate as JE

    logged, batchers, memo, masks = [], [], {}, {}
    nms_mask = JD.batched_nms_mask

    def batched_nms_mask(boxes, scores, iou_threshold):
        key = (image_key(boxes), image_key(scores), float(iou_threshold))
        if key not in masks:
            masks[key] = nms_mask(boxes, scores, iou_threshold)
        return masks[key]

    def eval_fn(params, arrays):
        key = image_key(arrays["images"])
        if key not in memo:
            logits, boxes = forward(arrays["images"], arrays["valid_hw"])
            memo[key] = {"pred_logits": np.asarray(logits, np.float32),
                         "pred_boxes": np.asarray(boxes, np.float32)}
        return memo[key]

    class Trainer:
        def __init__(self, cfg, mode="ctc", output_dir=None, charset=None, **kw):
            self.logger = types.SimpleNamespace(info=logged.append)
            self.state = types.SimpleNamespace(params={}, ema_params=None)
            self._eval_fn = eval_fn

        def init_params(self, arrays):
            return {}

        def build(self, params):
            pass

        def try_resume(self, name="checkpoint"):
            return True

    class RecordedBatcher(JE.BucketBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            batchers.append(self)

    monkeypatch.setattr(JD, "batched_nms_mask", batched_nms_mask)
    monkeypatch.setattr(JE, "Trainer", Trainer)
    monkeypatch.setattr(JE, "BucketBatcher", RecordedBatcher)
    if dataset is not None:
        monkeypatch.setattr(JE, "build_dataset", lambda *a, **kw: dataset)
    try:
        JE.main(argv)
    finally:
        for b in batchers:
            b.stop()
    records = [ast.literal_eval(m[len("eval "):]) for m in logged if m.startswith("eval ")]
    skipped = []
    for m in logged:
        if m.startswith("skip "):
            th, nms = m.split(":")[0][len("skip "):].split(" ")
            skipped.append({"TH": float(th[3:]), "NMS": float(nms[4:])})
    return records, skipped


def port_forward_from(forward):
    """The port's ``forward_lines`` replaced by ``forward`` on the batch's
    uint8 images."""
    def forward_lines(model, images, valid_hw):
        logits, boxes = forward(images, valid_hw)
        return {"pred_logits": torch.from_numpy(np.asarray(logits, np.float32)),
                "pred_boxes": torch.from_numpy(np.asarray(boxes, np.float32))}
    return forward_lines


# ----------------------------------------------------------------- (a)
CHARSETS = {"default": list("abcdefgh "), "CER_only": list("abcdefgh "),
            "chinese": list("一二三四五六七八九"), "cipher": ["aa", "bb", "cc", "dd", "ee"]}
NQ = 30


def write_lines(path, charset, n=11, seed=0):
    """``n`` seeded uint8 lines of ragged sizes with texts of the charset."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, 40, 300, 3), np.uint8)
    valid_hw = np.zeros((n, 2), np.int32)
    texts = []
    token = len(charset[0]) > 1
    for i in range(n):
        h, w = int(rng.integers(20, 40)), int(rng.integers(40, 300))
        images[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        valid_hw[i] = (h, w)
        chars = [c for c in charset if c != " "]
        k = int(rng.integers(1, 10))
        words = ["".join(rng.choice(chars, int(rng.integers(1, 4)))) if not token
                 else " ".join(rng.choice(chars, int(rng.integers(1, 4)))) for _ in range(k // 3 + 1)]
        texts.append(" ".join(words))
    np.savez(path, images=images, valid_hw=valid_hw, texts=np.asarray(texts),
             charset=np.asarray(charset))


def seeded_forward(num_classes):
    """Outputs drawn from the batch's images: scores up to sigmoid(0.45)
    (so every prediction is empty from TH 0.7), boxes along the line
    that overlap at many NMS thresholds."""
    def forward(images, valid_hw):
        rng = np.random.default_rng(int(image_key(images)[:8], 16))
        B = len(images)
        logits = np.minimum(rng.normal(-2.5, 2.0, (B, NQ, num_classes)), 0.45)
        boxes = np.stack([rng.uniform(0.05, 0.95, (B, NQ)), rng.uniform(0.45, 0.55, (B, NQ)),
                          rng.uniform(0.02, 0.12, (B, NQ)), rng.uniform(0.3, 0.6, (B, NQ))], -1)
        return logits.astype(np.float32), boxes.astype(np.float32)
    return forward


def read_files(out_dir):
    return {f: open(os.path.join(out_dir, f), encoding="utf-8").read()
            for f in ("preds.txt", "gts.txt", "char_cer_impact.txt", "stats.json")}


@pytest.mark.parametrize("mode,decode,max_images", [
    ("default", "sweep", -1), ("default", "sweep_th", 5), ("CER_only", "sweep_th", -1),
    ("chinese", "sweep_th", 6), ("cipher", "sweep_th", -1), ("default", "point", -1),
    ("default", "greedy", 9)])
def test_sweep_on_jax_outputs(monkeypatch, tmp_path, capsys, mode, decode, max_images):
    charset = CHARSETS[mode]
    lines = tmp_path / "lines.npz"
    write_lines(lines, charset)
    forward = seeded_forward(len(charset))
    flags = {"sweep": ["--sweep"], "sweep_th": ["--sweep", "--sweep_th", "0.6"],
             "point": ["--TH", "0.3", "--NMS", "0.5"], "greedy": []}[decode]
    common = ["--metrics", mode, "--batch_size", "4", "--max_images", str(max_images),
              "--dump_detections", *flags]

    from dtlr_tpu_torch.data.loaders import NpzLines

    cfg = jax_config(tmp_path / "cfg.py", [32], 256, 256, len(charset))
    want_records, want_skipped = run_jax_evaluate(
        monkeypatch, forward, ["--dataset", "lines", "--config", cfg, "--ckpt_dir",
                               str(tmp_path / "jax"), *common], dataset=NpzLines(str(lines)))
    jax_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(TE, "load_weights", lambda *a: {
        "params/class_embed/fc/kernel": np.zeros((1, len(charset)), np.float32)})
    monkeypatch.setattr(TE, "model_from_tree", lambda *a, **kw: None)
    monkeypatch.setattr(TE, "forward_lines", port_forward_from(forward))
    res = TE.main(["--params", str(tmp_path / "unused.npz"), "--lines", str(lines),
                   "--out_dir", str(tmp_path / "port"), "--device", "cpu", "--options",
                   "data_aug_scales=32", "data_aug_max_size=256", "image_w_max=256",
                   "image_h_max=none", *common])
    port_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert res["records"] == want_records
    assert res["skipped"] == want_skipped
    assert port_printed == jax_printed == res["best"]["record"]
    if decode.startswith("sweep"):
        assert len(want_records) + len(want_skipped) == (90 if decode == "sweep" else 27)
        assert want_skipped  # every prediction is empty from TH 0.7
    # both drop the last, partial batch (3 of 11 lines); --max_images
    # stops after the batch that reaches it
    n_lines = 8 if max_images < 0 else min(8, -(-max_images // 4) * 4)
    assert res["lines"] == n_lines
    jax_dir = tmp_path / "jax" / "stats_dect" / "lines"
    assert read_files(tmp_path / "port") == read_files(jax_dir)
    got = json.load(open(tmp_path / "port" / "detections.json"))
    want = json.load(open(jax_dir / "detections.json"))
    assert [(d["image_id"], d["category_id"]) for d in got] == [
        (d["image_id"], d["category_id"]) for d in want]
    np.testing.assert_allclose([d["bbox"] + [d["score"]] for d in got],
                               [d["bbox"] + [d["score"]] for d in want], rtol=0, atol=1e-6)


def test_weights_from_a_train_state(tmp_path):
    """--ckpt_dir reads the newest state of ``checkpoint`` (else
    ``checkpoint_best_regular``); --ema its EMA weights, and raises
    without them."""
    from dtlr_tpu_torch.train import checkpoints as ckpt

    params = {"class_embed.fc.weight": torch.ones(3, 2),
              "transformer.decoder_layer_0.ca_box_gamma": torch.ones(4)}
    ema = {k: 2 * v for k, v in params.items()}
    ckpt.save_checkpoint(str(tmp_path / "a" / "checkpoint_best_regular"), 7,
                         {"params": params, "ema_params": ema})
    tree = TE.load_weights(None, str(tmp_path / "a"), ema=False)
    assert (tree["params/class_embed/fc/kernel"] == 1).all()
    tree = TE.load_weights(None, str(tmp_path / "a"), ema=True)
    assert (tree["params/class_embed/fc/kernel"] == 2).all()
    ckpt.save_checkpoint(str(tmp_path / "b" / "checkpoint"), 1,
                         {"params": params, "ema_params": None})
    with pytest.raises(ValueError, match="EMA"):
        TE.load_weights(None, str(tmp_path / "b"), ema=True)
    with pytest.raises(FileNotFoundError):
        TE.load_weights(None, str(tmp_path / "c"), ema=False)
    with pytest.raises(ValueError, match="EMA"):
        TE.load_weights(str(tmp_path / "p.npz"), None, ema=True)


@pytest.mark.parametrize("eval_seed", [0, 2])
def test_hwdb_stream_with_a_runs_config(monkeypatch, tmp_path, capsys, eval_seed):
    from dtlr_tpu_torch.config import load_config, parse_options
    from dtlr_tpu_torch.config.loader import apply_options
    from dtlr_tpu_torch.train.config import dump_run_config, from_config
    from test_torch_hwdb_synth import CONFIG, HWDB_OPTIONS, bank_chars, bank_root

    root = bank_root(tmp_path / "data")
    n = len(bank_chars())
    cfg = apply_options(load_config(CONFIG), parse_options(HWDB_OPTIONS))
    train_cfg, model_cfg, _ = from_config(cfg, "pretrain")
    run_cfg = str(tmp_path / "run" / "config_cfg.py")
    dump_run_config(run_cfg, cfg, train_cfg, model_cfg, n, n)
    forward = seeded_forward(n)
    common = ["--dataset", "HWDB_synth", "--data_root", root, "--config", run_cfg,
              "--metrics", "chinese", "--TH", "0.2", "--NMS", "0.5", "--max_images", "6",
              "--batch_size", "4", "--eval_seed", str(eval_seed)]
    want_records, _ = run_jax_evaluate(
        monkeypatch, forward, ["--mode", "val", "--ckpt_dir", str(tmp_path / "jax"), *common])
    jax_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(TE, "load_weights", lambda *a: {
        "params/class_embed/fc/kernel": np.zeros((1, n), np.float32)})
    models = []
    monkeypatch.setattr(TE, "model_from_tree", lambda tree, cfg, device: models.append(cfg))
    monkeypatch.setattr(TE, "forward_lines", port_forward_from(forward))
    res = TE.main(["--ckpt_dir", str(tmp_path / "run"), "--device", "cpu", *common])
    port_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["records"] == want_records and len(want_records) == 1
    assert port_printed == jax_printed and {"AR", "CR"} <= set(port_printed)
    assert res["lines"] == 4  # the last, partial batch is dropped, as JAX drops it
    assert models == [model_cfg]  # the run's geometry and bfloat16
    assert read_files(tmp_path / "run" / "stats_dect" / "HWDB_synth") == read_files(
        tmp_path / "jax" / "stats_dect" / "HWDB_synth")


def test_rendered_eval_set(monkeypatch, tmp_path, capsys):
    """``--dataset synthetic``: both CLIs render the eval set (seed 123 +
    ``--eval_seed``, the config's renderer keys; JAX's generator given the
    banked faces) and batch it: the same batches reach the forward, and
    the records and files are JAX's, exactly."""
    from dtlr_tpu.data import synthetic as jax_synthetic
    from test_torch_pretrain import empty_pools
    from test_torch_synth_fixture import mpl_faces

    n = 166
    corpus = os.path.join(REPO, "artifacts", "corpus_words_val.txt")
    cfg = jax_config(tmp_path / "cfg.py", [64], 512, 512, n,
                     f"synthetic_max_words = 3\nsynthetic_corpus_val_file = {corpus!r}\n")
    forward, seen = seeded_forward(n), {"jax": [], "port": []}

    def recorded(who):
        def f(images, valid_hw):
            seen[who].append(image_key(images))
            return forward(images, valid_hw)
        return f

    common = ["--dataset", "synthetic", "--TH", "0.2", "--NMS", "0.5", "--max_images", "6",
              "--batch_size", "2", "--eval_seed", "1"]
    monkeypatch.setattr(jax_synthetic, "discover_fonts", mpl_faces)
    empty_pools()
    want_records, _ = run_jax_evaluate(
        monkeypatch, recorded("jax"), ["--mode", "val", "--config", cfg, "--ckpt_dir",
                                       str(tmp_path / "jax"), *common])
    jax_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(TE, "load_weights", lambda *a: {
        "params/class_embed/fc/kernel": np.zeros((1, n), np.float32)})
    monkeypatch.setattr(TE, "model_from_tree", lambda *a, **kw: None)
    monkeypatch.setattr(TE, "forward_lines", port_forward_from(recorded("port")))
    empty_pools()
    res = TE.main(["--params", str(tmp_path / "unused.npz"), "--out_dir",
                   str(tmp_path / "port"), "--device", "cpu", *common, "--options",
                   "data_aug_scales=64", "data_aug_max_size=512", "image_w_max=512",
                   "image_h_max=none", "max_targets=64", "synthetic_max_words=3",
                   f"synthetic_corpus_val_file={corpus}"])
    port_printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(seen["port"]) == 3 and seen["port"] == seen["jax"]
    assert res["records"] == want_records and len(want_records) == 1
    assert port_printed == jax_printed and res["lines"] == 6
    assert read_files(tmp_path / "port") == read_files(tmp_path / "jax" / "stats_dect" /
                                                         "synthetic")


# ----------------------------------------------------------------- (b)
def synthetic_lines(path, n, seed=123, max_words=8):
    """The first ``n`` lines of JAX's synthetic eval set (its evaluate.py
    draws them from ``SyntheticLineGenerator(seed=123)`` with the default
    charset), as an npz the port reads: uint8 pixels (the generator's
    images are uint8 / 255), valid sizes, texts and the charset."""
    from dtlr_tpu.data.charset import resolve_synthetic_charset
    from dtlr_tpu.data.synthetic import SyntheticLineGenerator

    gen = SyntheticLineGenerator(charset=resolve_synthetic_charset("default"), seed=seed,
                                 max_words=max_words)
    samples = [gen.sample_dict() for _ in range(n)]
    H = max(s["image"].shape[0] for s in samples)
    W = max(s["image"].shape[1] for s in samples)
    images = np.zeros((n, H, W, 3), np.uint8)
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[i, :h, :w] = np.round(s["image"] * 255.0).astype(np.uint8)
        assert np.array_equal(images[i, :h, :w].astype(np.float32) / 255.0, s["image"])
    np.savez(path, images=images,
             valid_hw=np.asarray([s["image"].shape[:2] for s in samples], np.int32),
             texts=np.asarray([s["text"] for s in samples]), charset=np.asarray(gen.charset))
    return gen.charset


TINY_OPTIONS = ["num_queries=24", "hidden_dim=32", "nheads=4", "enc_layers=2", "dec_layers=2",
                "dim_feedforward=64", "encoder_win=8"]
DATA_OPTIONS = ["data_aug_scales=64", "data_aug_max_size=512", "image_w_max=512",
                "image_h_max=none"]
SWAP_GAP_TOL = 1e-3


def held_lines(jax_forward, port_model, lines_path, cfg):
    """Each line alone (a batch of one, as the CLIs below take them)
    through both forwards: the lines whose two-stage selection is JAX's
    slot for slot, and the largest score gap behind a swapped slot
    elsewhere (``agreement``'s rule, dtlr_tpu_torch/eval/evaluate.py)."""
    from dtlr_tpu_torch.data.batching import make_batcher
    from dtlr_tpu_torch.data.loaders import NpzLines, eval_iter

    held, gap = [], 0.0
    batches = make_batcher(cfg, eval_iter(NpzLines(str(lines_path))), False, 0)
    for i, batch in enumerate(batches):
        o = jax_forward(batch.images, batch.valid_hw, full=True)
        p = TE.forward_lines(port_model, batch.images, batch.valid_hw)
        anchors = np.asarray(o["interm_outputs_for_matching_pre"]["pred_boxes"])
        same = np.abs(p["interm_outputs_for_matching_pre"]["pred_boxes"].numpy()
                      - anchors).max(-1)[0] < 1e-6
        if same.all():
            held.append(i)
        gaps = np.abs(p["interm_outputs"]["pred_logits"].max(-1).values.numpy()
                      - np.asarray(o["interm_outputs"]["pred_logits"]).max(-1))[0][~same]
        gap = max(gap, float(gaps.max(initial=0.0)))
    batches.stop()
    return held, gap


def test_cli_end_to_end_tiny(monkeypatch, tmp_path, capsys):
    """Lines whose two-stage selection differs from JAX's by a near tie of
    proposal scores (at TINY the random full-depth ResNet-50 leaves about
    1e-4 of noise in them, and ties within it occur: one line of eight
    here, a gap of 6e-6) read otherwise through the decoder (the slot's
    learned query meets another anchor), so the CLIs are compared on the
    lines whose selection is JAX's, each in a batch of its own."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dtlr_tpu.models.dino import DINO as JaxDINO
    from dtlr_tpu.ops.pixels import prep_images
    from dtlr_tpu_torch.data.loaders import NpzLines
    from dtlr_tpu_torch.models.dino import FLAGSHIP
    from dtlr_tpu_torch.train.config import RECIPE, apply_options
    from test_torch_grad_stops import flat
    from test_torch_model import TINY, make_lines, perturbed_params

    n = 8
    charset = synthetic_lines(tmp_path / "lines.npz", n)
    model = JaxDINO(
        num_classes=len(charset), num_queries=TINY.num_queries, hidden_dim=TINY.hidden_dim,
        n_heads=TINY.nheads, num_encoder_layers=TINY.enc_layers,
        num_decoder_layers=TINY.dec_layers, d_ffn=TINY.dim_feedforward, num_feature_levels=4,
        use_dn=False, dn_labelbook_size=len(charset) + 1, norm_kind="group",
        encoder_type="windowed", encoder_win=TINY.encoder_win, decoder_ca="dense",
        dense_box_bias=True, flash_attn=False, dtype=jnp.float32)
    params = perturbed_params(model, *make_lines())
    tree = flat(params)
    np.savez(tmp_path / "tiny.npz", **tree)
    fwd = jax.jit(lambda im, vh: model.apply(params, prep_images(im, vh), vh, None,
                                             train=False))

    def forward(images, valid_hw, full=False):
        o = fwd(jnp.asarray(images), jnp.asarray(valid_hw))
        return o if full else (o["pred_logits"], o["pred_boxes"])

    data_cfg, model_cfg = apply_options(
        RECIPE, dataclasses.replace(FLAGSHIP, compute_dtype="float32"),
        TINY_OPTIONS + DATA_OPTIONS)
    held, gap = held_lines(forward, TE.model_from_tree(tree, model_cfg, "cpu"),
                           tmp_path / "lines.npz", dataclasses.replace(data_cfg, batch_size=1))
    assert len(held) >= n - 2 and gap <= SWAP_GAP_TOL, (held, gap)
    with np.load(tmp_path / "lines.npz") as z:
        np.savez(tmp_path / "held.npz", **{k: z[k][held] if k != "charset" else z[k]
                                           for k in z.files})

    data = ["--batch_size", "1", "--sweep"]
    cfg = jax_config(tmp_path / "cfg.py", [64], 512, 512, len(charset))
    want_records, want_skipped = run_jax_evaluate(
        monkeypatch, forward, ["--dataset", "lines", "--config", cfg, "--ckpt_dir",
                               str(tmp_path / "jax"), *data],
        dataset=NpzLines(str(tmp_path / "held.npz")))
    capsys.readouterr()
    res = TE.main(["--params", str(tmp_path / "tiny.npz"), "--lines", str(tmp_path / "held.npz"),
                   "--device", "cpu", "--compute_dtype", "float32", "--options", *TINY_OPTIONS,
                   *DATA_OPTIONS, *data])
    assert res["out_dir"] == str(tmp_path / "stats_dect" / "held")
    assert res["lines"] == len(held)
    assert [(r["TH"], r["NMS"]) for r in res["records"]] == [
        (r["TH"], r["NMS"]) for r in want_records]
    assert res["skipped"] == want_skipped
    for got, want in zip(res["records"], want_records):
        for k in ("CER", "WER", "CER_corpus"):
            assert abs(got[k] - want[k]) <= 0.02, (got, want)
    best = json.load(open(tmp_path / "jax" / "stats_dect" / "lines" / "stats.json"))
    assert (res["best"]["record"]["TH"], res["best"]["record"]["NMS"]) == (best["TH"], best["NMS"])
    for f in ("preds.txt", "gts.txt", "char_cer_impact.txt", "stats.json"):
        assert os.path.exists(os.path.join(res["out_dir"], f))
