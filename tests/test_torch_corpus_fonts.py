"""The renderer's text and face samplers (dtlr_tpu_torch/data/corpus.py,
fonts.py) against the JAX package's (dtlr_tpu/data/corpus.py, fonts.py)
under the same rngs: the wikitext clean-up, the 100-character cut, the
corpus directory's train and val splits, the font dictionary's parse
(a path that names no banked face counts as missing, as JAX counts a
path that does not exist), the categorization, the 50% handwriting mix,
and ``discover_fonts`` over the bank. JAX is given the banked faces'
TTF paths under matplotlib's font directory, the port the bank's.
"""

import json
import os

import numpy as np
import pytest

from dtlr_tpu.data import corpus as JC
from dtlr_tpu.data import fonts as JF
from dtlr_tpu_torch.data import corpus as TC
from dtlr_tpu_torch.data import fonts as TF
from test_torch_synth_fixture import SYNTH, mpl_faces

TEXT = os.path.join(SYNTH, "text")
BOOK = os.path.join(SYNTH, "fonts.json")


@pytest.mark.parametrize("line", [
    " The cat @-@ like , animal ( a b ) sat . on 3 @.@ 5 mats ; ok : \" q \" 'x ",
    " = Header = ", "plain", " a , b . c ; d : e ' f \" g ( h ) i @-@ j @.@ k "])
def test_clean_wikitext_line(line):
    assert TC.clean_wikitext_line(line) == JC.clean_wikitext_line(line)


def test_truncate_line_draws_as_jax():
    rng = np.random.default_rng(0)
    lines = [" ".join(["w" * int(n) for n in rng.integers(1, 14, int(k))])
             for k in rng.integers(1, 60, 200)]
    lines += ["x" * 150, "a" * 101 + " b", "short", "ab cd" * 30]
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert [TC.truncate_line(l, a) for l in lines] == [JC.truncate_line(l, b) for l in lines]
    assert a.random() == b.random()


@pytest.mark.parametrize("mode,language", [("train", "en"), ("val", "en"), ("train", "de")])
def test_corpus_sampler_from_dir(mode, language):
    """A language directory, and a root without one (``de``: its files
    read from the root itself)."""
    root = TEXT if language == "en" else os.path.join(TEXT, "en")
    got = TC.CorpusSampler.from_dir(root, language, mode, np.random.default_rng(3))
    want = JC.CorpusSampler.from_dir(root, language, mode, np.random.default_rng(3))
    assert got.lines == want.lines
    assert [got.sample() for _ in range(300)] == [want.sample() for _ in range(300)]


def test_corpus_sampler_from_lines_and_empty():
    lines = ["", " = H = ", "a b c d", "x", "  ", "one two . three , four"] * 3
    got, want = TC.CorpusSampler(lines), JC.CorpusSampler(lines)
    assert [got.sample() for _ in range(50)] == [want.sample() for _ in range(50)]
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="empty corpus"):
            mod.CorpusSampler(["", "a"])
    assert TC.read_corpus(os.path.join(TEXT, "en", "val.txt")) == [
        l.strip() for l in open(os.path.join(TEXT, "en", "val.txt")) if l.strip()]


def port_names(book):
    return {c: {a: [os.path.basename(p) for p in ps] for a, ps in d.items()}
            for c, d in book.items()}


def test_font_dictionary_parse_and_draws():
    """The committed reference-format dictionary (one path names no face):
    the same buckets by file name, and the same draws."""
    jax = JF.FontSampler.from_reference_json(BOOK, font_root=os.path.dirname(mpl_faces()[0]),
                                             fallback_fonts=mpl_faces(),
                                             rng=np.random.default_rng(9))
    port = TF.FontSampler.from_reference_json(BOOK, rng=np.random.default_rng(9))
    assert port_names(port.bank) == port_names(jax.bank)
    assert all("NoSuchFace.ttf" not in ps for d in port.bank.values() for ps in d.values())
    for ability in (TF.ABILITY_SYMBOLS, TF.ABILITY_NUMBERS, "absent_bucket") * 40:
        assert os.path.basename(port.sample(ability)) == os.path.basename(jax.sample(ability))


def test_empty_buckets_fall_back_to_the_categorized_faces(tmp_path):
    book = {"SERIF": {TF.ABILITY_SYMBOLS: ["DejaVuSerif.ttf", "missing/Nope.ttf"]},
            "MONOSPACE": {TF.ABILITY_NUMBERS: ["cmtt10.ttf"]}}
    path = tmp_path / "book.json"
    path.write_text(json.dumps(book))
    jax = JF.FontSampler.from_reference_json(str(path), font_root=os.path.dirname(mpl_faces()[0]),
                                             fallback_fonts=mpl_faces(),
                                             rng=np.random.default_rng(1))
    port = TF.FontSampler.from_reference_json(str(path), fallback_fonts=TF.discover_fonts(),
                                              rng=np.random.default_rng(1))
    # cmtt10.ttf exists beside matplotlib's faces (JAX keeps it) but is not
    # banked (the port drops it and falls back)
    jb, pb = port_names(jax.bank), port_names(port.bank)
    assert jb["MONOSPACE"][TF.ABILITY_NUMBERS] == ["cmtt10.ttf"]
    assert pb["MONOSPACE"][TF.ABILITY_NUMBERS] == [
        n for n in TF.bank_names() if "mono" in n.lower()]
    jb["MONOSPACE"][TF.ABILITY_NUMBERS] = pb["MONOSPACE"][TF.ABILITY_NUMBERS]
    assert pb == jb
    # without fallback_fonts the port falls back to the bank
    assert port_names(TF.FontSampler.from_reference_json(str(path)).bank) == pb


def test_categories_and_system_sampler():
    assert TF.CATEGORIES == JF.CATEGORIES and TF.NON_HANDWRITING == JF.NON_HANDWRITING
    assert (TF.ABILITY_SYMBOLS, TF.ABILITY_NUMBERS) == (JF.ABILITY_SYMBOLS, JF.ABILITY_NUMBERS)
    names = TF.bank_names() + ["Brush Script.ttf", "Impact.ttf", "Courier.ttf"]
    assert TF.categorize_system_fonts(names) == JF.categorize_system_fonts(names)
    assert TF.categorize_system_fonts(["a.ttf"]) == JF.categorize_system_fonts(["a.ttf"])
    got = TF.FontSampler.from_system_fonts(rng=np.random.default_rng(4))
    want = JF.FontSampler.from_system_fonts(mpl_faces(), rng=np.random.default_rng(4))
    assert port_names(got.bank) == port_names(want.bank)
    for _ in range(100):
        assert os.path.basename(got.sample()) == os.path.basename(want.sample())


def test_discover_fonts_is_the_bank_sorted():
    found = TF.discover_fonts()
    assert [os.path.basename(p) for p in found] == sorted(os.path.basename(p) for p in found)
    assert len(found) == 16 and all(TF.is_banked(p) for p in found)
    assert TF.load_face(found[0]).name == os.path.basename(found[0])
    assert not TF.is_banked("/x/cmr10.ttf") and not TF.is_banked("/x/DejaVuSans.otf")
    with pytest.raises(FileNotFoundError, match="'cmr10.ttf' is not in the bank"):
        TF.load_face("/x/cmr10.ttf")
