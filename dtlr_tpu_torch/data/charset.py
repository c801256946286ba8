"""Charsets (counterpart of dtlr_tpu/data/charset.py). The port keeps
its own copies of the 166-character default charset (the synthetic
pretraining's classes) and the 64-character no-accent charset."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "charsets")
DEFAULT_CHARSET = "default_charset.json"
DEFAULT_CHARSET_NO_ACCENT = "default_charset_without_accent.json"


def load_charset(name: str = DEFAULT_CHARSET_NO_ACCENT) -> List[str]:
    with open(os.path.join(_ASSET_DIR, name)) as fh:
        return json.load(fh)


def load_default_charset() -> List[str]:
    """The 166-character charset of the pretrained checkpoints."""
    return load_charset(DEFAULT_CHARSET)


def load_charset_file(path: str) -> List[str]:
    """A charset from a .json list of characters (or code points)."""
    with open(path) as fh:
        charset = json.load(fh)
    return [chr(c) if isinstance(c, int) else c for c in charset]


def resolve_synthetic_charset(sub: str) -> Optional[List[str]]:
    """``no_accent`` is the 64-character set; ``no_accent_space`` adds
    ' ' as class 64 (the flagship checkpoint's 65 classes); ``default``
    (or None, or empty) is None: the renderer's 166-character default."""
    if sub in (None, "", "default"):
        return None
    if sub == "no_accent":
        return load_charset()
    if sub == "no_accent_space":
        return load_charset() + [" "]
    raise ValueError(f"unknown synthetic_charset {sub!r}")


def text_to_labels(text: Sequence[str], charset: Sequence[str]) -> List[int]:
    """Charset indices of the text's characters; others are dropped."""
    index = {c: i for i, c in enumerate(charset)}
    return [index[c] for c in text if c in index]


def labels_to_text(labels: Sequence[int], charset: Sequence[str],
                   token_based: bool = False) -> str:
    """The labels' characters, or space-separated tokens with
    ``token_based`` (the ciphers' multi-character symbols)."""
    return (" " if token_based else "").join(charset[i] for i in labels
                                             if 0 <= i < len(charset))
