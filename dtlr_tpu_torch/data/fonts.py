"""Font category/ability sampling for the synthetic Latin generator, over
the committed font bank (counterpart of dtlr_tpu/data/fonts.py).

The JAX package renders with system ``.ttf`` files through PIL; the port
reads the faces' glyphs, metrics and layout rules from
``assets/latin_fonts/`` (one npz per face, written by
tests/test_torch_font_bank.py from matplotlib's DejaVu and STIXGeneral
faces). A face is named by its TTF file name: ``discover_fonts`` returns
``<bank>/<name>.ttf`` for each banked face, sorted by name, and any path
whose file name is a banked face's resolves to that face. A path that
names no banked face counts as missing, as the JAX package counts a path
that does not exist (dtlr_tpu/data/fonts.py:98-104).

The reference samples fonts from a 5-category (SANS_SERIF, MONOSPACE,
SERIF, HANDWRITING, DISPLAY) x ability-bucket dictionary (reference
datasets/dictionnary_category_ability_paths.json, consumed by
sample_d_fonts at datasets/synthetic_lines_general.py:305-310): 50% of
draws come from HANDWRITING, the rest uniformly from the other four
categories; the ability bucket (letters only / +numbers / +accents /
+symbols) is chosen by the text mode.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

BANK_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "latin_fonts")

CATEGORIES = ("SANS_SERIF", "MONOSPACE", "SERIF", "HANDWRITING", "DISPLAY")
NON_HANDWRITING = ("SANS_SERIF", "MONOSPACE", "SERIF", "DISPLAY")

# ability buckets of the reference dictionary (synthetic_lines_general.py
# random_text: accented+symbols for the <=5-word mode, accent+numbers for
# the <=30-word mode)
ABILITY_SYMBOLS = "fonts_letters_with_accent_and_symbols"
ABILITY_NUMBERS = "fonts_letters_with_accent_and_numbers"

_CATEGORY_HINTS = {
    "MONOSPACE": ("mono", "courier", "consol", "typewriter"),
    "SERIF": ("serif", "roman", "georgia", "garamond", "times"),
    "HANDWRITING": ("hand", "script", "cursive", "comic", "brush"),
    "DISPLAY": ("display", "black", "impact", "poster"),
}


class FontBank:
    """One banked face: its charset's glyphs, the layout tables raqm
    applies to them, and per pixel size 30-50 each glyph's advance (26.6),
    hinted box (pixels) and 8-bit FreeType bitmap with its left/top
    bearing. ``meta`` records the libraries it was built with."""

    def __init__(self, path: str):
        with np.load(path) as z:
            self.meta = json.loads(str(z["meta"]))
            self.char_glyph = {chr(int(c)): int(g) for c, g in zip(z["chars"], z["char_glyph"])}
            self.ligatures = z["ligatures"]
            self.kern_lookups = [int(v) for v in z["kern_lookups"]]
            self.kern = z["kern"].astype(np.int64)
            self.x_mult = z["x_mult"]
            self.ascender = z["ascender"]
            self.advance = z["advance"]
            self.cbox = z["cbox"]
            self.bitmap_lt = z["bitmap_lt"]
            self.bitmap_hw = z["bitmap_hw"]
            self.bitmap_start = z["bitmap_start"]
            self.bitmap_data = z["bitmap_data"]
        self.name = self.meta["face"]
        self.sizes = list(self.meta["sizes"])

    def size_index(self, size: int) -> int:
        if size not in self.sizes:
            raise KeyError(f"{self.name}: size {size} is not banked (sizes {self.sizes[0]}-{self.sizes[-1]})")
        return self.sizes.index(size)

    def bitmap(self, si: int, glyph: int) -> np.ndarray:
        h, w = (int(v) for v in self.bitmap_hw[si, glyph])
        s = int(self.bitmap_start[si, glyph])
        return self.bitmap_data[s:s + h * w].reshape(h, w)


def bank_names(bank_dir: str = BANK_DIR) -> List[str]:
    """The banked faces' TTF file names, sorted."""
    if not os.path.isdir(bank_dir):
        return []
    return sorted(os.path.splitext(n)[0] + ".ttf" for n in os.listdir(bank_dir) if n.endswith(".npz"))


@lru_cache(maxsize=None)
def _load_face(path: str) -> FontBank:
    return FontBank(path)


def load_face(font_path: str, bank_dir: str = BANK_DIR) -> FontBank:
    """The banked face a font path names (by its TTF file name); raises
    with the name when the bank has no such face."""
    name = os.path.basename(font_path)
    stem, ext = os.path.splitext(name)
    npz = os.path.join(bank_dir, stem + ".npz")
    if ext.lower() != ".ttf" or not os.path.exists(npz):
        raise FileNotFoundError(f"font {name!r} is not in the bank {bank_dir}")
    return _load_face(npz)


def is_banked(font_path: str, bank_dir: str = BANK_DIR) -> bool:
    name = os.path.basename(font_path)
    return name.endswith(".ttf") and os.path.exists(os.path.join(bank_dir, name[:-4] + ".npz"))


def discover_fonts(bank_dir: str = BANK_DIR) -> List[str]:
    """The banked faces as ``<bank>/<name>.ttf``, sorted by name (the JAX
    package globs the machine's fonts instead, dtlr_tpu/data/synthetic.py:35-43)."""
    return [os.path.join(bank_dir, n) for n in bank_names(bank_dir)]


def categorize_system_fonts(paths: Sequence[str]) -> Dict[str, List[str]]:
    """Filename-heuristic categorization; every category is guaranteed
    non-empty (falls back to the full list) so sampling never fails."""
    cats: Dict[str, List[str]] = {c: [] for c in CATEGORIES}
    for p in paths:
        base = os.path.basename(p).lower()
        hit = None
        for cat, hints in _CATEGORY_HINTS.items():
            if any(h in base for h in hints):
                hit = cat
                break
        cats[hit or "SANS_SERIF"].append(p)
    full = list(paths)
    for c in CATEGORIES:
        if not cats[c]:
            cats[c] = full
    return cats


class FontSampler:
    """sample(ability) -> font path, with the reference's 50%%-handwriting
    category mix (reference synthetic_lines_general.py:305-310)."""

    def __init__(
        self,
        bank: Dict[str, Dict[str, List[str]]],
        rng: Optional[np.random.Generator] = None,
    ):
        self.bank = bank
        self.rng = rng or np.random.default_rng(0)

    @classmethod
    def from_reference_json(
        cls,
        json_path: str,
        font_root: str = "",
        fallback_fonts: Optional[Sequence[str]] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> "FontSampler":
        """Parse the reference dictionary format. Paths are joined onto
        ``font_root`` and dropped unless their file name is a banked face;
        empty buckets fall back to the categorized bank."""
        with open(json_path) as f:
            raw = json.load(f)
        fallback = categorize_system_fonts(
            list(fallback_fonts) if fallback_fonts else _system_fonts()
        )
        bank: Dict[str, Dict[str, List[str]]] = {}
        abilities = set()
        for cat in raw:
            abilities.update(raw[cat])
        for cat in CATEGORIES:
            bank[cat] = {}
            for ab in abilities:
                paths = [
                    os.path.join(font_root, p.lstrip("/"))
                    for p in raw.get(cat, {}).get(ab, [])
                ]
                paths = [p for p in paths if is_banked(p)]
                bank[cat][ab] = paths or list(fallback[cat])
        return cls(bank, rng)

    @classmethod
    def from_system_fonts(
        cls,
        fonts: Optional[Sequence[str]] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> "FontSampler":
        cats = categorize_system_fonts(list(fonts) if fonts else _system_fonts())
        bank = {
            c: {ABILITY_SYMBOLS: cats[c], ABILITY_NUMBERS: cats[c]}
            for c in CATEGORIES
        }
        return cls(bank, rng)

    def bucket(self, ability: str) -> List[str]:
        """The reference's sample_d_fonts: category first, then bucket."""
        if self.rng.integers(1, 3) == 1:
            cat = "HANDWRITING"
        else:
            cat = NON_HANDWRITING[self.rng.integers(0, len(NON_HANDWRITING))]
        d = self.bank[cat]
        if ability in d and d[ability]:
            return d[ability]
        # nearest non-empty bucket
        for v in d.values():
            if v:
                return v
        raise KeyError(f"no fonts for category {cat}")

    def sample(self, ability: str = ABILITY_SYMBOLS) -> str:
        b = self.bucket(ability)
        return b[self.rng.integers(0, len(b))]


def _system_fonts() -> List[str]:
    return discover_fonts()
