"""Wikitext-style corpus text sampling for the synthetic generator
(counterpart of dtlr_tpu/data/corpus.py, the same rng calls in the same
order).

Mirrors the reference's random_text_from_wikitext
(reference datasets/synthetic_lines_general.py:185-249): pick a random
line from a train split (or val.txt for eval), skip headers (" = "),
undo the wikitext tokenization artifacts (space-before-punct, " @-@ ",
" @.@ ", parenthesis spacing), and cap the result at 100 characters by
word-truncating first and character-truncating as a last resort.

The text assets (resources/text/{en,de,fr}) are not shipped with the
reference repo; ``CorpusSampler`` reads any directory with the same
layout (train_split_*.txt + val.txt) or a flat list of lines.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Sequence

import numpy as np

MAX_LEN = 100


def clean_wikitext_line(text: str) -> str:
    """Undo wikitext token spacing (reference
    synthetic_lines_general.py:220-231)."""
    text = re.sub(
        r""" \.| ,|" | :| ;| '|""",
        lambda m: m.group().strip(),
        text,
    )
    text = re.sub(r"\( ", "(", text)
    text = re.sub(r" \)", ")", text)
    text = re.sub(r" @-@ ", "-", text)
    text = re.sub(r" @\.@ ", ".", text)
    return text


def truncate_line(text: str, rng: np.random.Generator) -> str:
    """Cap at 100 chars: random word-prefix first, then a random 50-100
    char cut (reference synthetic_lines_general.py:233-248)."""
    if len(text) <= MAX_LEN:
        return text
    words = text.split()
    for _ in range(10):
        end = int(rng.integers(min(1, len(words) - 1), min(len(words), 21)))
        cand = " ".join(words[:end])
        if len(cand) > MAX_LEN:
            cand = cand[: int(rng.integers(50, 101))]
        if len(cand) > 1:
            return cand
    return text[:MAX_LEN]


class CorpusSampler:
    """Random cleaned line sampler over a wikitext-layout directory or a
    list of raw lines."""

    def __init__(
        self,
        lines: Sequence[str],
        rng: Optional[np.random.Generator] = None,
    ):
        self.lines = [l.rstrip("\n") for l in lines if len(l.strip()) >= 2]
        if not self.lines:
            raise ValueError("empty corpus")
        self.rng = rng or np.random.default_rng(0)

    @classmethod
    def from_dir(
        cls,
        root: str,
        language: str = "en",
        mode: str = "train",
        rng: Optional[np.random.Generator] = None,
    ) -> "CorpusSampler":
        """resources/text/<lang>/{train_split_*.txt,val.txt} layout
        (reference synthetic_lines_general.py:186-209)."""
        d = os.path.join(root, language)
        if not os.path.isdir(d):
            d = root
        if "val" in mode:
            paths = [os.path.join(d, "val.txt")]
        else:
            paths = sorted(glob.glob(os.path.join(d, "train_split_*.txt")))
            if not paths:
                paths = sorted(glob.glob(os.path.join(d, "*.txt")))
        lines: List[str] = []
        for p in paths:
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    lines += f.readlines()
        return cls(lines, rng)

    def sample(self) -> str:
        rng = self.rng
        for _ in range(100):
            text = self.lines[rng.integers(0, len(self.lines))]
            if len(text) < 2 or text.startswith(" = "):
                continue
            text = clean_wikitext_line(text)
            return truncate_line(text, rng)
        return self.lines[0][:MAX_LEN]


def read_corpus(path: str) -> List[str]:
    """A corpus file's non-blank lines, stripped, as the JAX entry points
    read ``synthetic_corpus_file`` (dtlr_tpu/train/pretrain.py:166-167)."""
    with open(path) as fh:
        return [l.strip() for l in fh if l.strip()]
