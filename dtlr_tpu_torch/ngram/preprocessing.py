"""Corpus preprocessing for char-level n-gram LM training (counterpart of
dtlr_tpu/ngram/preprocessing.py; its files are byte for byte the same).

Covers reference ngram/preprocessing/get_char_training_text.py:19-40 and
process_training_text.sh: convert a text corpus into the char-token
format kenlm's lmplz expects (space-separated characters, literal
spaces as the <space> token), and a helper to emit a lexicon file.
"""

from __future__ import annotations

from typing import Iterable, List

SPACE_TOKEN = "<space>"


def text_to_char_tokens(line: str) -> str:
    """'ab c' -> 'a b <space> c' (reference get_char_training_text.py)."""
    out: List[str] = []
    for ch in line.rstrip("\n"):
        out.append(SPACE_TOKEN if ch == " " else ch)
    return " ".join(out)


def write_char_corpus(lines: Iterable[str], out_path: str) -> int:
    n = 0
    with open(out_path, "w") as fh:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            fh.write(text_to_char_tokens(line) + "\n")
            n += 1
    return n


def write_lexicon(words: Iterable[str], out_path: str) -> int:
    """flashlight-style lexicon: word TAB char-spelling (reference
    prediction_helpers.py:76-91 lexicon input)."""
    n = 0
    with open(out_path, "w") as fh:
        for w in sorted(set(words)):
            if not w:
                continue
            fh.write(w + "\t" + " ".join(w) + " |\n")
            n += 1
    return n


def kenlm_train_command(corpus_path: str, arpa_path: str, order: int = 6) -> str:
    """The exact kenlm invocation (reference ngram/train_n_gram.sh:1-6);
    run externally where kenlm binaries exist."""
    return (
        f"lmplz -o {order} --discount_fallback < {corpus_path} > {arpa_path} && "
        f"build_binary {arpa_path} {arpa_path}.bin"
    )
