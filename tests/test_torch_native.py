"""The port's native host runtime (dtlr_tpu_torch/csrc/native.cpp, bound by
dtlr_tpu_torch/runtime/native.py) against the JAX package's
(dtlr_tpu/runtime/native.cpp through dtlr_tpu/eval/metrics.py and
dtlr_tpu/data/transforms.py) and against the port's plain versions:

- the Levenshtein distance and the edit operations over
  hypothesis-drawn strings and token lists from small alphabets (many
  ties between the backtrace's moves): the same integers as JAX's and as
  the numpy versions;
- the upscale on odd sizes bit for bit equal to the torch ``_upscale``
  and to JAX's ``_interp_resize`` (its C++ helper, whose build contracts
  the multiply-adds that the port writes as std::fma);
- the float normalize bit for bit equal to the numpy one;
- a source that does not compile raises with the compiler's message.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dtlr_tpu.data import transforms as JT
from dtlr_tpu.eval import metrics as JM
from dtlr_tpu_torch.data import batching as TB
from dtlr_tpu_torch.data import transforms as TT
from dtlr_tpu_torch.eval import metrics as TM
from dtlr_tpu_torch.ops import _build
from dtlr_tpu_torch.runtime import native
from test_torch_transforms import native_helper  # noqa: F401 (JAX's resize helper, autouse)

TEXT = st.text(alphabet="abc ", max_size=40)
TOKENS = st.lists(st.sampled_from(["ab", "c", "d", "ab c"]), max_size=25)
INTS = st.lists(st.integers(0, 4), max_size=30)


@settings(max_examples=300, deadline=None)
@given(st.one_of(st.tuples(TEXT, TEXT), st.tuples(TOKENS, TOKENS), st.tuples(INTS, INTS)))
def test_levenshtein_and_edit_operations(pair):
    a, b = pair
    for x, y in ((a, b), (list(a), list(b))):
        d = native.levenshtein(x, y)
        assert d == JM.levenshtein(x, y) == TM.levenshtein_plain(x, y) == TM.levenshtein(x, y)
        ops = native.edit_ops(x, y)
        assert ops == JM.edit_operations(x, y) == TM.edit_operations_plain(x, y)
        assert ops == TM.edit_operations(x, y)


def test_codes_keep_equality_across_representations():
    """Characters beyond the basic plane and tokens of several characters
    compare as the items they are."""
    assert native.levenshtein("a😀b", "a😀c") == 1
    assert native.levenshtein(["ab", "c"], ["a", "bc"]) == 2
    assert native.levenshtein([1, 2, 3], [1, 3]) == 1
    assert native.edit_ops("", "abc") == (0, 3, 0)
    assert native.edit_ops("abc", "") == (0, 0, 3)


@pytest.mark.parametrize("seed", range(4))
def test_upscale_bitwise(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        h, w = int(rng.integers(1, 60)) | 1, int(rng.integers(1, 300)) | 1
        oh, ow = h + int(rng.integers(0, 70)) | 1, w + int(rng.integers(0, 210)) | 1
        img = rng.random((h, w, 3), dtype=np.float32)
        got = native.resize_bilinear(img, oh, ow)
        np.testing.assert_array_equal(got, TT._upscale(img, oh, ow))
        np.testing.assert_array_equal(got, JT._interp_resize(img, oh, ow))
        np.testing.assert_array_equal(got, TT._interp_resize(img, oh, ow))


def test_normalize_bitwise():
    rng = np.random.default_rng(0)
    img = rng.random((37, 101, 3), dtype=np.float32)
    dst = np.full((64, 128, 3), 7.0, np.float32)
    native.normalize_into(img, dst)
    np.testing.assert_array_equal(dst[:37, :101], TB.normalize_plain(img))
    assert (dst[37:] == 7.0).all() and (dst[:, 101:] == 7.0).all()
    with pytest.raises(ValueError, match="does not fit"):
        native.normalize_into(img, np.zeros((8, 8, 3), np.float32))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad.cpp failed") as err:
        _build.build_host(str(bad))
    assert "error" in str(err.value)
    assert not os.listdir(tmp_path / "build")
