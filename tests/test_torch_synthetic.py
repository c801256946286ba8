"""The port's Latin line renderer (dtlr_tpu_torch/data/synthetic.py)
against the JAX package's ``SyntheticLineGenerator`` bit for bit: texts,
labels, float32 boxes and float32 images of 32 lines in each of the four
modes of the card's fixture (tests/test_torch_synth_fixture.py's
``MODES``: scripts/round4_chain.sh's stream, the plain background, the
reference's text mode with a font dictionary and a wikitext directory,
and a directory of background files), both given the same seed and the
banked faces (JAX their TTF paths under matplotlib's font directory);
the first 16 lines of each mode equal the committed fixture
(dtlr_tpu_torch/assets/smoke_synth_ref.npz). Also ``render_text_line``'s
layer and boxes, the retry on small lines (the canvas's
``CanvasTooSmall``, numpy's ``ValueError`` in JAX), and the registry's
``synthetic_line_OCR_general``.
"""

import numpy as np
import pytest

from dtlr_tpu.data import canvas as JC
from dtlr_tpu.data import synthetic as JS
from dtlr_tpu_torch.data import canvas as TC
from dtlr_tpu_torch.data import fonts as TF
from dtlr_tpu_torch.data import synthetic as TS
from dtlr_tpu_torch.data.loaders import build_dataset
from test_torch_synth_fixture import MODES, load_fixture, mpl_faces, render_mode, sample_record

N = 32


@pytest.fixture(autouse=True, scope="module")
def empty_pools_after():
    yield
    TC.set_background_dir(None)
    JC.set_background_dir(None)


@pytest.mark.parametrize("mode", MODES, ids=[m["name"] for m in MODES])
def test_generator_matches_jax_and_the_fixture(mode):
    want = render_mode("jax", mode, N)
    got = render_mode("port", mode, N)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.text == w.text, i
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.boxes.dtype == w.boxes.dtype == np.float32
        np.testing.assert_array_equal(g.boxes, w.boxes, err_msg=f"{mode['name']} {i}")
        assert g.image.dtype == w.image.dtype == np.float32
        np.testing.assert_array_equal(g.image, w.image, err_msg=f"{mode['name']} {i} {g.text!r}")
    modes, _ = load_fixture()
    committed = next(m for m in modes if m["name"] == mode["name"])["lines"]
    assert [sample_record(s) for s in got[:len(committed)]] == committed


def test_render_text_line_layer_and_boxes():
    rng = np.random.default_rng(4)
    faces, jax_faces = TF.discover_fonts(), mpl_faces()
    texts = ["AVATAR office", "fi fl ffi", "12,5 % « ok »", "a", "To  be", "Ÿ—’°"]
    for k in range(24):
        text = texts[k % len(texts)]
        seed, f = int(rng.integers(0, 1000)), int(rng.integers(0, len(faces)))
        size = None if k % 2 else int(rng.integers(30, 51))
        layer, boxes = TS.render_text_line(np.random.default_rng(seed), text, faces[f], size)
        jlayer, jboxes = JS.render_text_line(np.random.default_rng(seed), text, jax_faces[f], size)
        np.testing.assert_array_equal(layer, np.asarray(jlayer), err_msg=f"{text!r} {faces[f]}")
        assert boxes == jboxes


def test_small_lines_retry_as_jax_does(monkeypatch):
    """One- and two-word lines on the canvas: the stain and hole radii's
    empty ranges make JAX's ``sample`` retry on numpy's ValueError and the
    port's on ``CanvasTooSmall``, with the same lines after."""
    raised = []
    compose = TS.compose_canvas

    def counting(rng, layer):
        try:
            return compose(rng, layer)
        except TC.CanvasTooSmall:
            raised.append(layer.shape)
            raise

    monkeypatch.setattr(TS, "compose_canvas", counting)
    TC.set_background_dir(None)
    JC.set_background_dir(None)
    kw = dict(seed=5, max_words=1, corpus_lines=["a", "I", "ab", "if"], corpus_prob=1.0)
    got = TS.SyntheticLineGenerator(fonts=TF.discover_fonts(), **kw)
    want = JS.SyntheticLineGenerator(fonts=mpl_faces(), **kw)
    assert ([sample_record(got.sample()) for _ in range(12)]
            == [sample_record(want.sample()) for _ in range(12)])
    assert raised


def test_registry_builds_the_renderer():
    TC.set_background_dir(None)
    JC.set_background_dir(None)
    got = build_dataset("synthetic_line_OCR_general", "train", seed=3, max_words=4,
                        plain_background=True)
    want = JS.SyntheticLineGenerator(seed=3, max_words=4, plain_background=True,
                                     fonts=mpl_faces())
    assert isinstance(got, TS.SyntheticLineGenerator) and got.charset == want.charset
    it = iter(got)
    for _ in range(3):
        g, w = next(it), want.sample_dict()
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
    with pytest.raises(FileNotFoundError, match="Arial.ttf"):
        TS.SyntheticLineGenerator(fonts=["/fonts/Arial.ttf"]).sample()
