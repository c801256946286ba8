"""The evaluation snapshot (dtlr_tpu_torch/utils/visualizer.py) against
PIL and the JAX package's (dtlr_tpu/utils/visualizer.py), pixel for
pixel:

- ``rectangle`` against ``ImageDraw.rectangle`` on boxes of every size,
  thin ones and ones over the edges included;
- ``text`` against ``ImageDraw.text`` with the default font: every glyph
  of the bank and a character the font lacks, at random sub-pixel starts
  (negative ones, and the 1/64 quanta's halves), clipped at the edges;
- ``save_snapshot`` on the committed arrays (``assets/smoke_snapshot.npz``:
  a fixture line, JAX's boxes above TH 0.3 with seeded labels of the
  166-class charset, seeded ground truth) against JAX's snapshot of them
  (the pixels it changed, stored beside), and against JAX's
  ``save_snapshot`` run here on a normalized line;
- ``Trainer.evaluate_ctc(snapshot=True)`` writes the snapshot, and a
  failure in it is logged, not raised.

``python tests/test_torch_visualizer.py [glyphs|snapshot]`` (repository
root, ``PYTHONPATH=.:tests``, needs PIL; the snapshot also JAX) rewrites
``dtlr_tpu_torch/assets/aileron10_glyphs.npz`` (about a minute: every
glyph of PIL's default font at each of 130 x 66 start states) and
``smoke_snapshot.npz``; ``-m slow`` here rebuilds both and compares.
"""

import math
import os
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from dtlr_tpu_torch.data import images as I
from dtlr_tpu_torch.data.charset import load_default_charset
from dtlr_tpu_torch.utils import visualizer as V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_lines.npz")
SNAPSHOT = os.path.join(REPO, "dtlr_tpu_torch", "assets", "smoke_snapshot.npz")


# ------------------------------------------------------------- the bank

def state_start(state: int, vertical: bool) -> float:
    """A start whose state (``visualizer.start_state``) is ``state``."""
    if vertical:
        positive, q = state > 0, state - 1
    else:
        positive, q = state > 64, (state - 65 if state > 64 else state - 64)
    if positive:
        return 1e-6 if q == 0 else (0.999 if q == 64 else q / 64)
    return -0.999 if q == -64 else q / 64


def pil_mask(font, ch: str, sx: float, sy: float):
    core, offset = font.getmask2(ch, "L", start=(sx, sy), anchor="la")
    mask = np.asarray(Image.new("L", (1, 1))._new(core)) if core.size[0] * core.size[1] else (
        np.zeros((core.size[1], core.size[0]), np.uint8))
    return mask, tuple(offset)


def covered_code_points(font):
    """The BMP code points whose glyph is not the missing one (compared at
    start (0, 0))."""
    missing = pil_mask(font, "￿", 0.0, 0.0)
    out = []
    for cp in range(0x20, 0x10000):
        if 0xD800 <= cp < 0xE000:
            continue
        m = pil_mask(font, chr(cp), 0.0, 0.0)
        if m[1] != missing[1] or not np.array_equal(m[0], missing[0]):
            out.append(cp)
    return out


def build_glyph_bank():
    font = ImageFont.load_default()
    assert font.font.family == "Aileron" and font.size == 10, "PIL's default font changed"
    points = [-1] + covered_code_points(font)
    masks, starts, data, ids = [], [], [], {}
    table = np.zeros((len(points), 130, 66), np.uint16)
    pos = 0
    for g, cp in enumerate(points):
        ch = "￿" if cp < 0 else chr(cp)
        for xs in range(130):
            for ys in range(66):
                m, (ox, oy) = pil_mask(font, ch, state_start(xs, False), state_start(ys, True))
                key = (m.shape, ox, oy, m.tobytes())
                if key not in ids:
                    ids[key] = len(masks)
                    masks.append((m.shape[0], m.shape[1], ox, oy))
                    starts.append(pos)
                    data.append(m.reshape(-1))
                    pos += m.size
                table[g, xs, ys] = ids[key]
    return {"codepoints": np.asarray(points, np.int32), "table": table,
            "masks": np.asarray(masks, np.int32), "starts": np.asarray(starts, np.int64),
            "data": np.concatenate(data).astype(np.uint8)}


def test_start_states_cover_the_quanta():
    for state in range(130):
        assert V.start_state(state_start(state, False), False) == state
    for state in range(66):
        assert V.start_state(state_start(state, True), True) == state
    assert V.start_state(0.5 / 64, False) == 66  # half a quantum rounds away from zero
    assert V.start_state(-0.5 / 64, False) == 63


def pil_text(base, xy, label, color):
    im = Image.fromarray(base.copy())
    ImageDraw.Draw(im).text(xy, label, fill=color)
    return np.asarray(im)


def test_every_glyph_at_random_starts_is_pil_s():
    bank = V.glyph_bank()
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in bank.index if c >= 0] + ["é", "一"]
    base = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    for i, ch in enumerate(chars):
        for _ in range(2):
            x = float(rng.uniform(-6, 40))
            y = float(rng.uniform(0, 20)) if i % 5 else float(rng.integers(0, 20))
            if i % 7 == 0:
                x = math.floor(x) + rng.integers(-64, 64) / 64 + 1 / 128  # a quantum's half
            got = base.copy()
            V.text(got, (x, y), ch, (255, 40, 40))
            np.testing.assert_array_equal(got, pil_text(base, (x, y), ch, (255, 40, 40)),
                                          err_msg=f"{ch!r} at {(x, y)}")


def test_rectangle_is_pil_s():
    rng = np.random.default_rng(1)
    for i in range(200):
        base = rng.integers(0, 256, (20, 40, 3), dtype=np.uint8)
        x0, y0 = float(rng.uniform(-10, 45)), float(rng.uniform(-10, 25))
        w, h = (float(rng.uniform(0, 1.5)), float(rng.uniform(0, 1.5))) if i % 4 == 0 else (
            float(rng.uniform(0, 20)), float(rng.uniform(0, 8)))
        want = Image.fromarray(base.copy())
        ImageDraw.Draw(want).rectangle([x0, y0, x0 + w, y0 + h], outline=(40, 120, 255),
                                       width=1)
        got = base.copy()
        V.rectangle(got, (x0, y0, x0 + w, y0 + h), (40, 120, 255))
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError):
        V.rectangle(base, (5.0, 1.0, 4.0, 2.0), (0, 0, 0))


# --------------------------------------------------------- the snapshot

def snapshot_inputs():
    """The committed line 0 of the fixture, JAX's boxes above TH 0.3 on it
    with seeded labels of the 166-class charset (accented characters the
    font lacks among them), four boxes over the edges, and seeded ground
    truth."""
    with np.load(LINES) as z:
        image, valid_hw = z["images"][0], z["valid_hw"][0]
        boxes = z["jax_pred_boxes"][0]
        keep = 1 / (1 + np.exp(-z["jax_max_logit"][0])) > 0.3
    rng = np.random.default_rng(17)
    edges = np.asarray([[0.001, 0.02, 0.01, 0.05], [0.999, 0.99, 0.02, 0.08],
                        [0.5, 0.5, 1.2, 1.3], [0.003, 0.9, 0.004, 0.3]], np.float32)
    pred = np.concatenate([boxes[keep], edges]).astype(np.float32)
    labels = rng.integers(0, 166, len(pred))
    gt = np.concatenate([rng.uniform(0.05, 0.95, (12, 2)), rng.uniform(0.005, 0.1, (12, 2))],
                        1).astype(np.float32)
    return image, valid_hw, pred, labels, gt


def build_snapshot(tmp_dir):
    """JAX's snapshot of ``snapshot_inputs``: the inputs and the pixels
    that JAX's ``save_snapshot`` changed in the line."""
    from dtlr_tpu.utils.visualizer import save_snapshot

    image, valid_hw, pred, labels, gt = snapshot_inputs()
    path = save_snapshot(tmp_dir, 3, image, pred, labels, load_default_charset(),
                         valid_hw=valid_hw, gt_boxes=gt)
    out = np.asarray(Image.open(path).convert("RGB"))
    changed = np.flatnonzero((out != image).any(-1))
    return {"valid_hw": valid_hw, "pred_boxes": pred, "pred_labels": labels, "gt_boxes": gt,
            "changed": changed, "values": out.reshape(-1, 3)[changed]}


def snapshot_reference():
    with np.load(SNAPSHOT) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(LINES) as z:
        image = z["images"][0]
    want = image.reshape(-1, 3).copy()
    want[ref["changed"]] = ref["values"]
    return image, ref, want.reshape(image.shape)


def test_save_snapshot_is_jax_s_committed(tmp_path):
    image, ref, want = snapshot_reference()
    assert len(ref["changed"]) > 1000  # boxes and labels were drawn
    path = V.save_snapshot(str(tmp_path / "snapshots"), 3, image, ref["pred_boxes"],
                           ref["pred_labels"], load_default_charset(), valid_hw=ref["valid_hw"],
                           gt_boxes=ref["gt_boxes"])
    assert os.path.basename(path) == "snapshot_epoch0003.png"
    with open(path, "rb") as fh:
        data = fh.read()
    np.testing.assert_array_equal(I.decode_image(data, native=False), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_save_snapshot_of_a_normalized_line_is_jax_s(tmp_path):
    """A float (normalized) line: ``denormalize`` first, as JAX's does."""
    from dtlr_tpu.utils.visualizer import save_snapshot as jax_save

    image, valid_hw, pred, labels, gt = snapshot_inputs()
    x = ((image[:, :300] / np.float32(255) - V.IMAGENET_MEAN) / V.IMAGENET_STD).astype(
        np.float32)
    vh = np.asarray([valid_hw[0], 300], np.int32)
    charset = load_default_charset()
    want = jax_save(str(tmp_path / "jax"), 0, x, pred[:20], labels[:20], charset, vh, gt[:4])
    got = V.save_snapshot(str(tmp_path / "port"), 0, x, pred[:20], labels[:20], charset, vh,
                          gt[:4])
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


def test_evaluate_ctc_writes_the_snapshot(tmp_path):
    """``evaluate_ctc`` at TINY on two fixture lines writes
    snapshots/snapshot_epoch0000.png (the first line, its valid size);
    a charset of symbol names (labels the font cannot lay out) logs the
    failure and the evaluation goes on."""
    import dataclasses

    import torch

    from dtlr_tpu_torch.data import batching as TB
    from dtlr_tpu_torch.data import loaders as TL
    from dtlr_tpu_torch.train.config import RECIPE
    from dtlr_tpu_torch.train.engine import Trainer
    from dtlr_tpu_torch.train.init import init_params
    from test_torch_model import TINY

    ds = TL.NpzLines(LINES)
    charset = ds.charset
    cfg = dataclasses.replace(TINY, dn_labelbook_size=len(charset) + 1)
    trainer = Trainer(dataclasses.replace(RECIPE, batch_size=2), cfg,
                      output_dir=str(tmp_path / "run"), device="cpu")
    tree = init_params(cfg, len(charset), torch.Generator().manual_seed(0))
    tree["params/class_embed/fc/bias"] = np.zeros_like(tree["params/class_embed/fc/bias"])
    trainer.build(tree)

    def batches():
        b = TB.BucketBatcher(iter([ds[0], ds[1]]), batch_size=2, scales=[64], max_size=512,
                             w_max=512, train=False, transfer_uint8=True)
        yield from b
        b.stop()

    stats = trainer.evaluate_ctc(batches(), charset, snapshot=True)
    assert stats["n"] == 2
    path = tmp_path / "run" / "snapshots" / "snapshot_epoch0000.png"
    with open(path, "rb") as fh:
        snap = I.decode_image(fh.read())
    first = next(iter(batches()))
    assert snap.shape == first.images[0].shape
    assert (snap != first.images[0]).any()  # boxes were drawn

    names = [f"sym_{c}" for c in charset]
    trainer.epoch = 1
    stats = trainer.evaluate_ctc(batches(), names, snapshot=True)
    assert stats["n"] == 2
    assert not (tmp_path / "run" / "snapshots" / "snapshot_epoch0001.png").exists()
    with open(tmp_path / "run" / "info.txt") as fh:
        assert "snapshot failed" in fh.read()


@pytest.mark.slow
def test_committed_bank_and_snapshot_rebuild(tmp_path):
    bank = build_glyph_bank()
    with np.load(V.GLYPHS) as z:
        for k, v in bank.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    snap = build_snapshot(str(tmp_path))
    with np.load(SNAPSHOT) as z:
        for k, v in snap.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


if __name__ == "__main__":
    import tempfile

    what = sys.argv[1:] or ["glyphs", "snapshot"]
    if "glyphs" in what:
        np.savez_compressed(V.GLYPHS, **build_glyph_bank())
        print("wrote", V.GLYPHS, os.path.getsize(V.GLYPHS))
    if "snapshot" in what:
        with tempfile.TemporaryDirectory() as tmp:
            np.savez_compressed(SNAPSHOT, **build_snapshot(tmp))
        print("wrote", SNAPSHOT, os.path.getsize(SNAPSHOT))
