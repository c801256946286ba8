"""The Latin font bank (dtlr_tpu_torch/assets/latin_fonts/) and the
port's text layout and glyph drawing (dtlr_tpu_torch/data/glyphs.py)
against PIL, bit for bit:

- every face's bitmaps at random (size, glyph, start phase) against
  ``getmask2`` of the character at that start;
- ``getbbox``, ``getlength`` and ``getmask2`` of random charset strings
  and of all their prefixes (raqm's shaping: kerning, ligatures, the
  pen's 26.6 position through the string, overlapping glyphs), kerned
  pairs (``AV``, ``To``), ligatures (``fi``, ``fl``, ``ffi``) and strings
  of Common-script characters only (the DFLT script's lookups); no banked
  face lacks a charset character, so the banked .notdef draws no
  charset text;
- ``ImageDraw.text`` with an RGBA fill on a transparent RGBA layer;
- the committed bank equal to a rebuild of two faces at every size, and
  the library versions it records equal to the running ones.

``python tests/test_torch_font_bank.py`` (repository root,
``PYTHONPATH=.``, needs PIL and fontTools) rewrites the bank: one npz per
face of matplotlib's ``mpl-data/fonts/ttf`` that the JAX package's
``discover_fonts`` would return, that its ``_font_supports`` probe
passes, and whose family has a license file there (the ``cm*10`` faces
have none), with the license files beside them. The bitmaps, boxes and
advances come from Pillow's own FreeType library (its bundled shared
object, through ctypes, loaded as Pillow loads a face), the ligature
rules and the pair kerning from the font's GSUB and GPOS tables as
HarfBuzz applies them.
"""

import ctypes as C
import glob
import json
import os
import shutil

import numpy as np
import PIL
import pytest
from PIL import Image, ImageDraw, ImageFont, features

from dtlr_tpu_torch.data import fonts as F
from dtlr_tpu_torch.data import glyphs as G
from dtlr_tpu_torch.data.charset import load_default_charset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = list(range(30, 51))
LICENSES = {"DejaVu": "LICENSE_DEJAVU", "STIX": "LICENSE_STIX"}
#: HarfBuzz's default horizontal features whose lookups can substitute
#: (ligatures) or kern; mark positioning has no marks to act on here
GSUB_FEATURES = ("ccmp", "rlig", "liga", "clig", "calt", "rclt")
GPOS_FEATURES = ("kern",)


def mpl_font_dir() -> str:
    import matplotlib

    return os.path.join(matplotlib.get_data_path(), "fonts", "ttf")


# ------------------------------------------------- Pillow's FreeType, ctypes

_FT = []


class _Generic(C.Structure):
    _fields_ = [("data", C.c_void_p), ("finalizer", C.c_void_p)]


class _BBox(C.Structure):
    _fields_ = [("xMin", C.c_long), ("yMin", C.c_long), ("xMax", C.c_long), ("yMax", C.c_long)]


class _Vector(C.Structure):
    _fields_ = [("x", C.c_long), ("y", C.c_long)]


class _Bitmap(C.Structure):
    _fields_ = [("rows", C.c_uint), ("width", C.c_uint), ("pitch", C.c_int),
                ("buffer", C.POINTER(C.c_ubyte)), ("num_grays", C.c_ushort),
                ("pixel_mode", C.c_ubyte), ("palette_mode", C.c_ubyte), ("palette", C.c_void_p)]


class _GlyphSlot(C.Structure):
    _fields_ = [("library", C.c_void_p), ("face", C.c_void_p), ("next", C.c_void_p),
                ("glyph_index", C.c_uint), ("generic", _Generic),
                ("metrics", C.c_long * 8), ("linearHoriAdvance", C.c_long),
                ("linearVertAdvance", C.c_long), ("advance", _Vector), ("format", C.c_int),
                ("bitmap", _Bitmap), ("bitmap_left", C.c_int), ("bitmap_top", C.c_int)]


class _SizeMetrics(C.Structure):
    _fields_ = [("x_ppem", C.c_ushort), ("y_ppem", C.c_ushort), ("x_scale", C.c_long),
                ("y_scale", C.c_long), ("ascender", C.c_long), ("descender", C.c_long),
                ("height", C.c_long), ("max_advance", C.c_long)]


class _Size(C.Structure):
    _fields_ = [("face", C.c_void_p), ("generic", _Generic), ("metrics", _SizeMetrics)]


class _Face(C.Structure):
    _fields_ = [("num_faces", C.c_long), ("face_index", C.c_long), ("face_flags", C.c_long),
                ("style_flags", C.c_long), ("num_glyphs", C.c_long), ("family_name", C.c_char_p),
                ("style_name", C.c_char_p), ("num_fixed_sizes", C.c_int),
                ("available_sizes", C.c_void_p), ("num_charmaps", C.c_int),
                ("charmaps", C.c_void_p), ("generic", _Generic), ("bbox", _BBox),
                ("units_per_EM", C.c_ushort), ("ascender", C.c_short), ("descender", C.c_short),
                ("height", C.c_short), ("max_advance_width", C.c_short),
                ("max_advance_height", C.c_short), ("underline_position", C.c_short),
                ("underline_thickness", C.c_short), ("glyph", C.POINTER(_GlyphSlot)),
                ("size", C.POINTER(_Size))]


def freetype():
    """Pillow's bundled FreeType (the library ``_imagingft`` links) and an
    initialized FT_Library."""
    if not _FT:
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libfreetype*.so*")))
        if not found:
            raise RuntimeError(f"no FreeType shared object under {libs}")
        ft = C.CDLL(found[0])
        lib = C.c_void_p()
        if ft.FT_Init_FreeType(C.byref(lib)):
            raise RuntimeError("FT_Init_FreeType failed")
        major, minor, patch = C.c_int(), C.c_int(), C.c_int()
        ft.FT_Library_Version(lib, C.byref(major), C.byref(minor), C.byref(patch))
        version = f"{major.value}.{minor.value}.{patch.value}"
        if version != features.version("freetype2"):
            raise RuntimeError(f"bundled FreeType {version} is not Pillow's {features.version('freetype2')}")
        _FT.append((ft, lib))
    return _FT[0]


class FtFace:
    """One face at one pixel size, loaded as Pillow's ``font_new`` and
    read as its ``bounding_box_and_anchors`` and ``font_render`` read it
    (FT_LOAD_DEFAULT, hinted; FT_GLYPH_BBOX_PIXELS; FT_LOAD_RENDER)."""

    def __init__(self, path: str, size: int):
        self.ft, lib = freetype()
        self.p = C.POINTER(_Face)()
        if self.ft.FT_New_Face(lib, path.encode(), 0, C.byref(self.p)):
            raise RuntimeError(f"FT_New_Face failed for {path}")
        if self.ft.FT_Set_Pixel_Sizes(self.p, 0, size):
            raise RuntimeError(f"FT_Set_Pixel_Sizes({size}) failed for {path}")

    def close(self):
        self.ft.FT_Done_Face(self.p)

    @property
    def metrics(self) -> _SizeMetrics:
        return self.p.contents.size.contents.metrics

    def char_index(self, ch: str) -> int:
        return int(self.ft.FT_Get_Char_Index(self.p, ord(ch)))

    def glyph(self, gid: int):
        """(advance 26.6, cbox in pixels, bitmap (rows, width) uint8,
        bitmap_left, bitmap_top)."""
        ft = self.ft
        if ft.FT_Load_Glyph(self.p, gid, 0):
            raise RuntimeError(f"FT_Load_Glyph({gid}) failed")
        slot = self.p.contents.glyph.contents
        advance = (slot.linearHoriAdvance + 512) >> 10   # hb-ft: 16.16 -> 26.6
        g = C.c_void_p()
        if ft.FT_Get_Glyph(self.p.contents.glyph, C.byref(g)):
            raise RuntimeError("FT_Get_Glyph failed")
        box = _BBox()
        ft.FT_Glyph_Get_CBox(g, 3, C.byref(box))        # FT_GLYPH_BBOX_PIXELS
        ft.FT_Done_Glyph(g)
        if ft.FT_Load_Glyph(self.p, gid, 4):            # FT_LOAD_RENDER
            raise RuntimeError(f"FT_Load_Glyph({gid}, RENDER) failed")
        slot = self.p.contents.glyph.contents
        bm = slot.bitmap
        if bm.rows and bm.pixel_mode != 2:               # FT_PIXEL_MODE_GRAY
            raise RuntimeError(f"glyph {gid}: pixel mode {bm.pixel_mode}")
        arr = np.zeros((bm.rows, bm.width), np.uint8)
        if bm.rows and bm.width:
            base = C.addressof(bm.buffer.contents)
            for r in range(bm.rows):
                row = C.cast(base + r * bm.pitch, C.POINTER(C.c_ubyte))
                arr[r] = np.ctypeslib.as_array(row, (bm.width,))
        return (advance, (box.xMin, box.yMin, box.xMax, box.yMax), arr,
                slot.bitmap_left, slot.bitmap_top)


# ------------------------------------------------------- GSUB and GPOS

def _default_lookups(table, features_, script: str):
    """The lookup indices of ``features_`` in the script's default
    language system, in HarfBuzz's order (by index)."""
    rec = next((s for s in table.ScriptList.ScriptRecord if s.ScriptTag == script), None)
    if rec is None or rec.Script.DefaultLangSys is None:
        return []
    out = set()
    for fi in rec.Script.DefaultLangSys.FeatureIndex:
        fr = table.FeatureList.FeatureRecord[fi]
        if fr.FeatureTag in features_:
            out.update(fr.Feature.LookupListIndex)
    return sorted(out)


def _subtables(lookup):
    for st in lookup.SubTable:
        yield (st.ExtSubTable if lookup.LookupType in (7, 9) else st)


def _lookup_type(lookup):
    if lookup.LookupType in (7, 9):
        return lookup.SubTable[0].ExtensionLookupType
    return lookup.LookupType


def _pair_value(lookup, g1: str, g2: str) -> int:
    """HarfBuzz's PairPos for one lookup: the first subtable that covers
    the pair applies (format 1: the pair listed; format 2: the first
    glyph covered and both classes in range)."""
    for st in _subtables(lookup):
        if g1 not in st.Coverage.glyphs:
            continue
        if st.Format == 1:
            ps = st.PairSet[st.Coverage.glyphs.index(g1)]
            for rec in ps.PairValueRecord:
                if rec.SecondGlyph == g2:
                    return int(getattr(rec.Value1, "XAdvance", 0) or 0) if rec.Value1 else 0
            continue
        c1 = st.ClassDef1.classDefs.get(g1, 0) if st.ClassDef1 else 0
        c2 = st.ClassDef2.classDefs.get(g2, 0) if st.ClassDef2 else 0
        if c1 >= st.Class1Count or c2 >= st.Class2Count:
            continue
        v = st.Class1Record[c1].Class2Record[c2].Value1
        return int(getattr(v, "XAdvance", 0) or 0) if v else 0
    return 0


def _check_gpos(lookup, index: int):
    for st in _subtables(lookup):
        if st.ValueFormat2 or st.ValueFormat1 & ~0x4 or lookup.LookupFlag:
            raise NotImplementedError(
                f"GPOS lookup {index}: value formats {st.ValueFormat1}/{st.ValueFormat2}, "
                f"flag {lookup.LookupFlag} (only first-glyph x advances are banked)")


def font_supports(path: str) -> bool:
    """The JAX package's probe (dtlr_tpu/data/synthetic.py ``_font_supports``
    at size 36 on ``abcXYZ09``), restated with PIL."""
    font = ImageFont.truetype(path, 36)
    for c in "abcXYZ09":
        m = font.getmask(c)
        if m.size[0] == 0 or m.size[1] == 0 or m.getbbox() is None:
            return False
    return True


def banked_faces(font_dir: str):
    """The TTF file names of ``font_dir`` that the JAX package's
    ``discover_fonts`` keeps, that its probe passes and whose family has
    a license file there."""
    bad = ("STIXSiz", "cmex", "cmsy", "Symbol")
    out = []
    for name in sorted(os.listdir(font_dir)):
        if not name.endswith(".ttf") or any(b in name for b in bad):
            continue
        family = next((k for k in LICENSES if name.startswith(k)), None)
        if family is None or not os.path.exists(os.path.join(font_dir, LICENSES[family])):
            continue
        if font_supports(os.path.join(font_dir, name)):
            out.append(name)
    return out


def library_versions() -> dict:
    return {"pillow": PIL.__version__, "freetype": features.version("freetype2"),
            "harfbuzz": features.version("harfbuzz"), "raqm": features.version("raqm"),
            "fribidi": features.version("fribidi")}


def layout_engine() -> str:
    font = ImageFont.truetype(os.path.join(mpl_font_dir(), "DejaVuSans.ttf"), 10)
    return "raqm" if font.layout_engine == ImageFont.Layout.RAQM else "basic"


def build_face(path: str) -> dict:
    """The arrays of one face's bank file (see ``dtlr_tpu_torch.data.fonts.FontBank``)."""
    from fontTools.ttLib import TTFont

    charset = load_default_charset()
    tt = TTFont(path)
    order = tt.getGlyphOrder()
    gdef = tt["GDEF"].table.GlyphClassDef.classDefs if "GDEF" in tt else {}
    probe = FtFace(path, SIZES[0])
    char_gid = [probe.char_index(c) for c in charset]
    probe.close()
    for c, g in zip(charset, char_gid):
        if gdef.get(order[g]) == 3:
            raise NotImplementedError(f"{path}: {c!r} is a mark glyph (zero-width marks are not banked)")

    scripts = ("DFLT", "latn")
    gsub = tt["GSUB"].table if "GSUB" in tt else None
    gpos = tt["GPOS"].table if "GPOS" in tt else None
    glyph_set = set(char_gid) | {0}
    rules = []                                   # (lookup, first, comps, out) in GSUB order
    sub_lookups = sorted({i for s in scripts for i in (_default_lookups(gsub, GSUB_FEATURES, s) if gsub else [])})
    changed = True
    while changed:                               # ligatures of ligatures close the set
        changed = False
        rules = []
        for li in sub_lookups:
            lk = gsub.LookupList.Lookup[li]
            if _lookup_type(lk) != 4:
                continue
            for st in _subtables(lk):
                for first, ligs in st.ligatures.items():
                    fg = tt.getGlyphID(first)
                    if fg not in glyph_set:
                        continue
                    for lig in ligs:
                        comps = [tt.getGlyphID(n) for n in lig.Component]
                        if all(c in glyph_set for c in comps):
                            out = tt.getGlyphID(lig.LigGlyph)
                            rules.append((li, fg, comps, out))
                            if out not in glyph_set:
                                glyph_set.add(out)
                                changed = True
    gids = sorted(glyph_set)
    local = {g: i for i, g in enumerate(gids)}
    n = len(gids)
    max_comps = max([len(r[2]) for r in rules] + [1])
    lig = np.full((len(rules), 3 + max_comps), -1, np.int32)
    for k, (li, fg, comps, out) in enumerate(rules):
        lig[k, :3] = (li, local[fg], local[out])
        lig[k, 3:3 + len(comps)] = [local[c] for c in comps]

    pos_lookups = sorted({i for s in scripts for i in (_default_lookups(gpos, GPOS_FEATURES, s) if gpos else [])})
    kern = np.zeros((len(pos_lookups), n, n), np.int16)
    names = [order[g] for g in gids]
    for k, li in enumerate(pos_lookups):
        lk = gpos.LookupList.Lookup[li]
        if _lookup_type(lk) != 2:
            raise NotImplementedError(f"{path}: kern lookup {li} of type {_lookup_type(lk)}")
        _check_gpos(lk, li)
        for a in range(n):
            for b in range(n):
                kern[k, a, b] = _pair_value(lk, names[a], names[b])
    script_lookups = {s: {"gsub": _default_lookups(gsub, GSUB_FEATURES, s) if gsub else [],
                          "gpos": _default_lookups(gpos, GPOS_FEATURES, s) if gpos else []}
                      for s in scripts}

    upem = tt["head"].unitsPerEm
    S = len(SIZES)
    advance = np.zeros((S, n), np.int32)
    cbox = np.zeros((S, n, 4), np.int32)
    bitmap_lt = np.zeros((S, n, 2), np.int32)
    bitmap_hw = np.zeros((S, n, 2), np.int32)
    bitmap_start = np.zeros((S, n), np.int64)
    ascender = np.zeros(S, np.int32)
    x_mult = np.zeros(S, np.int64)
    data = []
    offset = 0
    for si, size in enumerate(SIZES):
        face = FtFace(path, size)
        m = face.metrics
        ascender[si] = m.ascender
        # hb-ft's font scale, then HarfBuzz's em multiplier (hb-font.hh)
        x_scale = (m.x_scale * upem + (1 << 15)) >> 16
        x_mult[si] = (x_scale << 16) // upem
        for i, g in enumerate(gids):
            adv, box, bm, left, top = face.glyph(g)
            advance[si, i] = adv
            cbox[si, i] = box
            bitmap_lt[si, i] = (left, top)
            bitmap_hw[si, i] = bm.shape
            bitmap_start[si, i] = offset
            data.append(bm.reshape(-1))
            offset += bm.size
        face.close()
    meta = {
        "face": os.path.basename(path), "family": tt["name"].getDebugName(1),
        "style": tt["name"].getDebugName(2), "units_per_em": upem, "sizes": SIZES,
        "font_supports": font_supports(path), "versions": library_versions(),
        "layout_engine": layout_engine(), "scripts": script_lookups,
        "gsub_features": list(GSUB_FEATURES), "gpos_features": list(GPOS_FEATURES),
    }
    return {
        "meta": np.asarray(json.dumps(meta, sort_keys=True)),
        "chars": np.asarray([ord(c) for c in charset], np.int32),
        "char_glyph": np.asarray([local[g] for g in char_gid], np.int32),
        "gids": np.asarray(gids, np.int32),
        "ligatures": lig,
        "kern_lookups": np.asarray(pos_lookups, np.int32),
        "kern": kern,
        "x_mult": x_mult,
        "ascender": ascender,
        "advance": advance,
        "cbox": cbox,
        "bitmap_lt": bitmap_lt,
        "bitmap_hw": bitmap_hw,
        "bitmap_start": bitmap_start,
        "bitmap_data": np.concatenate(data) if data else np.zeros(0, np.uint8),
    }


def write_bank(out_dir: str = F.BANK_DIR, font_dir: str = None):
    font_dir = font_dir or mpl_font_dir()
    os.makedirs(out_dir, exist_ok=True)
    for name in banked_faces(font_dir):
        arrays = build_face(os.path.join(font_dir, name))
        np.savez_compressed(os.path.join(out_dir, os.path.splitext(name)[0] + ".npz"), **arrays)
        print(name, os.path.getsize(os.path.join(out_dir, os.path.splitext(name)[0] + ".npz")))
    for lic in LICENSES.values():
        shutil.copyfile(os.path.join(font_dir, lic), os.path.join(out_dir, lic))


# ------------------------------------------------------------------ tests

CHARSET = load_default_charset()
#: kerned pairs, ligatures, Common-script strings (the DFLT lookups), spaces
CASES = ["AV", "To", "fi", "fl", "ffi", "ffl", "office waffle", "AVATAR Toto", "st",
         "12,5 %", "«»—–’°", "!?", "0123456789", "(1) [2] {3}", "a  b", " _", "_",
         "Wave fjord", "LT-Tw", "Yo, Vá!"]


def pil_mask(font, text: str, start=(0.0, 0.0)):
    core, offset = font.getmask2(text, "L", start=start)
    if core.size[0] * core.size[1] == 0:
        return np.zeros((core.size[1], core.size[0]), np.uint8), tuple(offset)
    return np.asarray(Image.new("L", (1, 1))._new(core)), tuple(offset)


def faces():
    return [os.path.join(mpl_font_dir(), n) for n in F.bank_names()]


def test_bank_holds_the_licensed_faces_that_pass_the_probe():
    names = F.bank_names()
    assert names == banked_faces(mpl_font_dir())
    assert len(names) == 16 and not any(n.startswith("cm") for n in names)
    total = sum(os.path.getsize(os.path.join(F.BANK_DIR, f)) for f in os.listdir(F.BANK_DIR))
    assert total <= 16 * 2 ** 20
    for lic in LICENSES.values():
        with open(os.path.join(F.BANK_DIR, lic), "rb") as a, \
                open(os.path.join(mpl_font_dir(), lic), "rb") as b:
            assert a.read() == b.read()
    assert F.discover_fonts() == [os.path.join(F.BANK_DIR, n) for n in names]


def test_recorded_versions_and_verdicts_are_the_running_ones():
    from dtlr_tpu.data.synthetic import _font_supports as jax_supports

    from dtlr_tpu_torch.data.synthetic import _font_supports

    for path in faces():
        face = F.load_face(path)
        assert face.meta["versions"] == library_versions()
        assert face.meta["layout_engine"] == layout_engine() == "raqm"
        want = jax_supports(ImageFont.truetype(path, 36), "abcXYZ09")
        assert face.meta["font_supports"] == want
        assert _font_supports(G.BankedFont(path, 36), "abcXYZ09") == want
        # every charset character has its own glyph: the banked .notdef
        # (glyph 0) is drawn by no charset text
        gids = np.load(os.path.join(F.BANK_DIR, face.name[:-4] + ".npz"))["gids"]
        assert gids[0] == 0 and all(gids[face.char_glyph[c]] != 0 for c in CHARSET)


@pytest.mark.parametrize("name", ["DejaVuSans.ttf", "STIXGeneralBolIta.ttf"])
def test_committed_face_equals_a_rebuild(name):
    got = build_face(os.path.join(mpl_font_dir(), name))
    with np.load(os.path.join(F.BANK_DIR, name[:-4] + ".npz")) as z:
        assert set(z.files) == set(got)
        for k in got:
            if k == "meta":
                assert json.loads(str(z[k])) == json.loads(str(got[k]))
            else:
                np.testing.assert_array_equal(z[k], got[k], err_msg=k)


def test_glyph_masks_at_random_start_phases():
    """(face, size, glyph, phase) drawn from a seed: the port's mask and
    offset against PIL's ``getmask2`` of the character at that start,
    over the 64 horizontal 1/64 phases and vertical ones."""
    rng = np.random.default_rng(18)
    paths = faces()
    for _ in range(600):
        path = paths[rng.integers(0, len(paths))]
        size = int(rng.integers(30, 51))
        ch = CHARSET[rng.integers(0, len(CHARSET))]
        start = (float(rng.integers(0, 64)) / 64 + float(rng.integers(-2, 3)),
                 float(rng.integers(0, 64)) / 64 if rng.random() < 0.3 else 0.0)
        want = pil_mask(ImageFont.truetype(path, size), ch, start)
        got = G.BankedFont(path, size).getmask2(ch, start)
        assert got[1] == want[1], (path, size, ch, start)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{path} {size} {ch!r} {start}")


@pytest.mark.parametrize("face", range(16))
def test_layout_of_strings_and_their_prefixes(face):
    """``getbbox``, ``getlength`` of random charset strings and of every
    prefix (each shaped on its own), and ``getmask2`` of the whole string
    at a random start, against PIL with raqm."""
    path = faces()[face]
    rng = np.random.default_rng(100 + face)
    texts = list(CASES)
    for _ in range(24):
        pool = CHARSET if rng.random() < 0.7 else list("fil AVTo.,'-0123456789!?«»")
        texts.append("".join(rng.choice(pool, int(rng.integers(1, 16)))))
    for text in texts:
        size = int(rng.integers(30, 51))
        pil, port = ImageFont.truetype(path, size), G.BankedFont(path, size)
        for i in range(len(text)):
            p = text[:i + 1]
            assert port.getbbox(p) == pil.getbbox(p), (path, size, p)
            assert port.getlength(p) == pil.getlength(p), (path, size, p)
        assert port.prefix_rights(text) == [pil.getbbox(text[:i + 1])[2] for i in range(len(text))]
        assert port.mask_size(text) == pil.getmask(text).size
        start = (float(rng.uniform(-1, 1)), 0.0) if rng.random() < 0.5 else (0.0, 0.0)
        got, want = port.getmask2(text, start), pil_mask(pil, text, start)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{path} {size} {text!r}")


def test_draw_text_rgba_on_rgba_layers():
    """``ImageDraw.text`` with an RGBA fill on a transparent layer (the
    renderer's) and on opaque and part-transparent ones, clipped."""
    rng = np.random.default_rng(7)
    paths = faces()
    for it in range(40):
        path = paths[it % len(paths)]
        size = int(rng.integers(30, 51))
        text = "".join(rng.choice(CHARSET, int(rng.integers(1, 14))))
        w, h = int(rng.integers(20, 320)), int(rng.integers(20, 90))
        bg = (255, 255, 255, 0) if it % 2 == 0 else tuple(int(v) for v in rng.integers(0, 256, 4))
        fill = tuple(int(v) for v in rng.integers(0, 256, 4))
        xy = (int(rng.integers(-6, 30)), int(rng.integers(-6, 20)))
        layer = Image.new("RGBA", (w, h), bg)
        ImageDraw.Draw(layer).text(xy, text, font=ImageFont.truetype(path, size), fill=fill,
                                   spacing=0)
        got = np.empty((h, w, 4), np.uint8)
        got[:] = bg
        G.draw_text(got, xy, text, G.BankedFont(path, size), fill)
        np.testing.assert_array_equal(got, np.asarray(layer), err_msg=f"{path} {text!r}")


def test_unbanked_faces_sizes_and_characters_raise():
    with pytest.raises(FileNotFoundError, match="cmr10.ttf"):
        G.BankedFont("/usr/share/fonts/cmr10.ttf", 40)
    with pytest.raises(KeyError, match="size 29"):
        G.BankedFont(faces()[0], 29)
    with pytest.raises(KeyError, match="not in the banked charset"):
        G.BankedFont(faces()[0], 40).getbbox("a一")


if __name__ == "__main__":
    write_bank()
