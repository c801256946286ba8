"""The n-gram decoder (dtlr_tpu_torch/ngram/lm_decode.py, preprocessing.py,
rescore.py's YAML loader) against the JAX package's (dtlr_tpu/ngram/), on
the CPU. Both are numpy and float64 Python, operation for operation, so
every result is held EQUAL, not close:

- ``CharNgramLM.logp`` (stupid backoff and interpolated Kneser-Ney, order
  6) fit on a slice of artifacts/corpus_words_train.txt, on queries drawn
  from the held-out corpus (out-of-vocabulary characters among them);
- ARPA files written by one package and read by the other, both ways:
  the files byte for byte, and ``logp`` of the loaded models;
- ``LexiconTrie`` (prefixes, words, the flashlight-format file);
- ``ctc_beam_search`` strings and scores, with and without the LM and the
  lexicon, and ``rescore_line`` with and without the lexicon and with each
  gating flag, on seeded posteriors of lines with words, digits, dashes,
  capitals, repeats and spaces;
- ``preprocessing``'s files byte for byte and its kenlm command;
- ``load_yaml`` on every JAX ngram/*.yaml, and the port's copies of them
  (the same keys and values, paths made relative to the repository).
"""

import glob
import itertools
import os

import numpy as np
import pytest

from dtlr_tpu.ngram import lm_decode as J
from dtlr_tpu.ngram import preprocessing as JP
from dtlr_tpu.ngram.rescore import load_yaml as jax_load_yaml
from dtlr_tpu_torch.data.charset import resolve_synthetic_charset
from dtlr_tpu_torch.ngram import lm_decode as P
from dtlr_tpu_torch.ngram import preprocessing as PP
from dtlr_tpu_torch.ngram.rescore import load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARSET = resolve_synthetic_charset("no_accent_space")
#: the lattices' alphabet: the flagship's and a dash, for the dash gate
LATTICE_CHARSET = CHARSET + ["-"]
ORDER = 6
#: lines of each corpus used: the fit's slice and the queries'; the ARPA
#: round trip's LM (order 4 on fewer lines: writing and reading a file
#: costs per n-gram)
FIT_LINES, QUERY_LINES = 600, 40
ARPA_ORDER, ARPA_LINES = 4, 150
LINES = ["the cat sat", "Paris-Nord 42", "see ll", "aa  bb", "run to the door"]


def corpus(name: str, n: int):
    cs = set(CHARSET)
    with open(os.path.join(REPO, "artifacts", name)) as fh:
        text = [l for _, l in zip(range(n), fh)]
    return [t for t in ("".join(c for c in l if c in cs) for l in text) if t]


@pytest.fixture(scope="module")
def lms():
    lines = corpus("corpus_words_train.txt", FIT_LINES)
    return {s: (J.CharNgramLM(ORDER, smoothing=s).fit(lines),
                P.CharNgramLM(ORDER, smoothing=s).fit(lines)) for s in ("stupid", "kn")}


def queries():
    """(context, char) pairs from held-out lines, plus characters the fit
    never saw."""
    out = []
    for line in corpus("corpus_words_val.txt", QUERY_LINES):
        for i in range(len(line)):
            out.append((line[max(0, i - 8):i], line[i]))
    out += [("the ", "Q"), ("", "~"), ("zzzz", "é")]
    return out


@pytest.mark.parametrize("smoothing", ["stupid", "kn"])
def test_logp_equal(lms, smoothing):
    jlm, plm = lms[smoothing]
    qs = queries()
    assert len(qs) > 500
    assert [plm.logp(c, x) for c, x in qs] == [jlm.logp(c, x) for c, x in qs]


@pytest.mark.parametrize("smoothing", ["stupid", "kn"])
def test_arpa_both_ways(smoothing, tmp_path):
    lines = corpus("corpus_words_train.txt", ARPA_LINES)
    jlm = J.CharNgramLM(ARPA_ORDER, smoothing=smoothing).fit(lines)
    plm = P.CharNgramLM(ARPA_ORDER, smoothing=smoothing).fit(lines)
    jlm.to_arpa(str(tmp_path / "jax.arpa"))
    plm.to_arpa(str(tmp_path / "port.arpa"))
    assert (tmp_path / "jax.arpa").read_bytes() == (tmp_path / "port.arpa").read_bytes()
    qs = queries()[:300]
    from_jax = P.CharNgramLM.from_arpa(str(tmp_path / "jax.arpa"))
    from_port = J.CharNgramLM.from_arpa(str(tmp_path / "port.arpa"))
    jax_own = J.CharNgramLM.from_arpa(str(tmp_path / "jax.arpa"))
    assert from_jax.order == from_port.order == ARPA_ORDER
    assert ([from_jax.logp(c, x) for c, x in qs] == [from_port.logp(c, x) for c, x in qs]
            == [jax_own.logp(c, x) for c, x in qs])


def test_lexicon_trie_and_files(tmp_path):
    words = sorted({w for l in corpus("corpus_words_train.txt", 300) for w in l.split()})
    assert PP.write_lexicon(words, str(tmp_path / "port.lex")) == JP.write_lexicon(
        words, str(tmp_path / "jax.lex"))
    assert (tmp_path / "port.lex").read_bytes() == (tmp_path / "jax.lex").read_bytes()
    lines = corpus("corpus_words_val.txt", 50)
    assert PP.write_char_corpus(lines, str(tmp_path / "p.txt")) == JP.write_char_corpus(
        lines, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert PP.kenlm_train_command("c", "a.arpa", 5) == JP.kenlm_train_command("c", "a.arpa", 5)
    assert PP.text_to_char_tokens("ab c\n") == JP.text_to_char_tokens("ab c\n")
    jt, pt = J.LexiconTrie.from_file(str(tmp_path / "jax.lex")), P.LexiconTrie.from_file(
        str(tmp_path / "port.lex"))
    assert pt.words == jt.words and dict(pt.children) == dict(jt.children)
    for prefix in ["", "t", "th", "the", "qzx", words[0], words[-1][:-1]]:
        assert sorted(pt.next_chars(prefix)) == sorted(jt.next_chars(prefix))
        assert pt.is_word(prefix) == jt.is_word(prefix)


def posteriors(text: str, rng, frames_per_char=3, noise=0.6):
    """Seeded (T, K+1) frame posteriors for ``text``: each character a few
    frames peaked on its class (second guesses and noise from ``rng``),
    blank frames between and around; rows need not sum to one."""
    index = {c: i + 1 for i, c in enumerate(LATTICE_CHARSET)}
    K1 = len(LATTICE_CHARSET) + 1
    rows = []
    for ch in " " + text + " ":
        for f in range(frames_per_char):
            p = rng.dirichlet(np.full(K1, 0.3)) * noise
            if f == frames_per_char - 1 or ch == " " and f == 0:
                p[0] += 1.0
            else:
                p[index[ch]] += 1.0
                p[rng.integers(1, K1)] += rng.uniform(0, 0.9)
            rows.append(p)
    return np.asarray(rows, np.float32)


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.default_rng(7)
    probs = [posteriors(t, rng) for t in LINES]
    greedy = [J._segment_greedy(p.argmax(-1), LATTICE_CHARSET) for p in probs]
    assert greedy == [P._segment_greedy(p.argmax(-1), LATTICE_CHARSET) for p in probs]
    return probs, greedy


@pytest.mark.parametrize("with_lm,with_lexicon", [(False, False), (True, False), (True, True)],
                         ids=["no_lm", "lm", "lm_lexicon"])
def test_ctc_beam_search_equal(lms, lattice, with_lm, with_lexicon):
    probs, _ = lattice
    jlm, plm = lms["stupid"] if with_lm else (None, None)
    words = {w for l in corpus("corpus_words_train.txt", FIT_LINES) for w in l.split()}
    jlex, plex = ((J.LexiconTrie(words), P.LexiconTrie(words)) if with_lexicon
                  else (None, None))
    for p in probs:
        seg = p[: len(p) // 2]
        for beam, temp in ((4, 1.0), (16, 2.0)):
            want = J.ctc_beam_search(seg, LATTICE_CHARSET, jlm, 0.6, beam, temp, jlex,
                                     return_score=True)
            got = P.ctc_beam_search(seg, LATTICE_CHARSET, plm, 0.6, beam, temp, plex,
                                    return_score=True)
            assert got == want


GATES = [dict(no_uppercase_words=u, no_digits=d, no_dash=h)
         for u, d, h in itertools.product((False, True), repeat=3)]


@pytest.mark.parametrize("smoothing", ["stupid", "kn"])
def test_rescore_line_equal(lms, lattice, smoothing):
    probs, greedy = lattice
    jlm, plm = lms[smoothing]
    words = {w for l in corpus("corpus_words_train.txt", FIT_LINES) for w in l.split()}
    jlex, plex = J.LexiconTrie(words), P.LexiconTrie(words)
    moved = 0
    for p, g in zip(probs, greedy):
        for gate in GATES:
            want = J.rescore_line(p, g, LATTICE_CHARSET, jlm, 0.75, 8, **gate)
            assert P.rescore_line(p, g, LATTICE_CHARSET, plm, 0.75, 8, **gate) == want
            moved += want != g
        for margin in (0.0, 5.0):
            want = J.rescore_line(p, g, LATTICE_CHARSET, jlm, 0.75, 8, lexicon=jlex,
                                  lexicon_margin=margin)
            assert P.rescore_line(p, g, LATTICE_CHARSET, plm, 0.75, 8, lexicon=plex,
                                  lexicon_margin=margin) == want
    assert moved > 0  # the LM changed some reading: the decode is exercised
    assert P.rescore_line(probs[0], greedy[0], LATTICE_CHARSET, None) == greedy[0]
    # no space class: one beam search over the whole line
    no_space = CHARSET[:-1]
    p = probs[0][:, : len(no_space) + 1]
    assert (P.rescore_line(p, "", no_space, plm, 0.5, 4)
            == J.rescore_line(p, "", no_space, jlm, 0.5, 4))


def test_load_yaml_and_the_port_copies():
    jax_files = sorted(glob.glob(os.path.join(REPO, "dtlr_tpu", "ngram", "*.yaml")))
    assert len(jax_files) == 7
    for path in jax_files:
        want = jax_load_yaml(path)
        assert load_yaml(path) == want
        copy = load_yaml(os.path.join(REPO, "dtlr_tpu_torch", "ngram", os.path.basename(path)))
        assert set(copy) == set(want), path
        for k, v in want.items():
            if isinstance(v, str) and os.path.isabs(v):
                # the JAX copy names this file from the root of a checkout;
                # the port's names it relative to the repo
                assert not os.path.isabs(copy[k]) and v.endswith("/" + copy[k]), (path, k)
                continue
            if isinstance(v, str) and "/" in v:
                v = v.replace("dtlr_tpu/configs/", "dtlr_tpu_torch/configs/")
            assert copy[k] == v, (path, k)
