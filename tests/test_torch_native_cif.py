"""The port's native CIF parser (``native/cif_tokenizer.cpp``, ctypes)
against its Python oracle and the JAX package's: dict-identical on every
fixture CIF, on the JAX test's grammar corpus copied in, and on cases of
the line breaks ``str.splitlines()`` knows beyond \\n, \\r and \\r\\n;
``parse_mmcif`` equal through either parser; a source that does not build
warns once and leaves the Python parser in charge. Timing is left to
``chip_smoke.py``'s phase 12."""
import logging
import pathlib

import numpy as np
import pytest

from framedipt_tpu.data.mmcif import parse_cif_categories_py as j_parse_py

from framedipt_tpu_torch import native
from framedipt_tpu_torch.data import mmcif as t_mmcif
from framedipt_tpu_torch.tools.log import get_logger

FIXTURES = sorted((pathlib.Path(__file__).parent / "data" / "cifs").glob("*.cif"))

# The grammar corpus of tests/unit/test_native_cif.py.
GRAMMAR_CORPUS = [
    "_a.b 'hello world'\n_a.c \"it's fine\"\n_a.d 'don't stop'\n",
    "_a.b 1 # trailing\n# full line\n_a.c '#not a comment'\n",
    "_e.f\n;first line\nsecond line\n;\n_e.g 2\n",
    "_e.f\n;loop_\n_fake.tag\n;\n_e.g 2\n",
    "loop_\n_l.a\n_l.b\n1\n;multi\nline\n;\n2 x\n",
    "loop_\n_l.a\n_l.b\nloop_\n_m.a\n1\n",
    "loop_\n_l.a\n_l.b\n1 2 3\n",
    "LOOP_\n_l.a\n1\nSTOP_\n_m.b 2\n",
    "data_block1\n_a.b 1\nDATA_two\nglobal_\n_c.d 2\n",
    "_a.b 'unterminated\n_a.c 2\n",
    "_plain value\n",
    "_a.b 1\r\n_a.c 2\r_a.d 3\n",
    "",
    "   \n\t\n",
    "_a.b loop_\n_a.c data_x\n",
    "loop_\n_l.a\n_l.b\n? .\n. ?\n",
    "loop_\n_l.a\n1 2 3",
]

# Line breaks of str.splitlines() past \n, \r and \r\n: each ends a line (so
# a tag after it starts a pair, a ';' after it a text field), in a value, a
# loop and a text field; and more of the grammar's corners.
EXTRA_CORPUS = [
    "_a.b 1\f_a.c 2\n",
    "_a.b 1\v_a.c 2\x1c_a.d 3\x1d_a.e 4\x1e_a.f 5\n",
    "_a.b x\x85_a.c 2 _a.d 3 _a.e 4\n",
    "loop_\f_l.a\f_l.b\f1 2\f3 4\n",
    "_e.f\f;text\fmore\f;\f_e.g 2\n",
    "_a.b 'quoted\fvalue' _a.c 1\n",
    "_a.b café 'ümläut'  ;x\n;\n",
    "_a 1\n_a. 2\n_b.c.d 3\n",
    "loop_\n_l.a\n_l.a\n_l.b\n1 2 3\n4 5 6\n",
    "loop_\n_l.a\n_l.b\n1 2\n_l.a 3\nloop_\n_l.b\n4\n",
    "_a.b\n",
    "_a.b ''\n_a.c \"\"\n_a.d ;x\n",
    ";\n;\n_a.b 1\n",
    "_a.b\n;unterminated\ntext",
    "data_\n_A.B 1\nGlobal_\n_a.B 2\nLoop_\n_x.y\n1\nStop_\n",
]


@pytest.fixture(scope="module")
def built():
    """The native library; the test fails where it does not build (g++ is
    on the test machines)."""
    lib = native.load_cif_tokenizer()
    assert lib is not None, "native CIF tokenizer did not build"
    return lib


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_fixture_files_identical(built, path):
    text = path.read_text()
    got = native.parse_cif_categories(text)
    assert got == t_mmcif.parse_cif_categories_py(text)
    assert got == j_parse_py(text)
    # The same order of categories and items as the Python parser's dicts.
    want = t_mmcif.parse_cif_categories_py(text)
    assert list(got) == list(want)
    assert all(list(got[c]) == list(want[c]) for c in want)


@pytest.mark.parametrize("i", range(len(GRAMMAR_CORPUS)))
def test_grammar_corpus_identical(built, i):
    text = GRAMMAR_CORPUS[i]
    got = native.parse_cif_categories(text)
    assert got == t_mmcif.parse_cif_categories_py(text) == j_parse_py(text)


@pytest.mark.parametrize("i", range(len(EXTRA_CORPUS)))
def test_line_breaks_and_corners_identical(built, i):
    text = EXTRA_CORPUS[i]
    got = native.parse_cif_categories(text)
    assert got == t_mmcif.parse_cif_categories_py(text) == j_parse_py(text)
    assert t_mmcif.parse_cif_categories(text) == got


def test_form_feed_splits_a_line():
    """A form feed ends a line for the Python oracle, and so for the port's
    parser. (The JAX package's C++ tokenizer splits lines at \\n, \\r and
    \\r\\n only, so there its two parsers disagree on this text.)"""
    text = "_a.b 1\f_a.c 2\n"
    assert t_mmcif.parse_cif_categories(text) == {"_a": {"b": ["1"], "c": ["2"]}}


def test_nul_and_unencodable_text_take_the_python_parser(built):
    for text in ("_a.b x\0y _a.c 2\n", "_a.b \ud800 _a.c 2\n"):
        assert native.parse_cif_categories(text) is None
        assert t_mmcif.parse_cif_categories(text) == t_mmcif.parse_cif_categories_py(text)


def test_parse_mmcif_equal_through_either_parser(built, monkeypatch):
    for path in FIXTURES:
        got = t_mmcif.parse_mmcif(path)
        with monkeypatch.context() as m:
            m.setattr(native, "parse_cif_categories", lambda text: None)
            want = t_mmcif.parse_mmcif(path)
        assert got.header == want.header and list(got.chains) == list(want.chains)
        for cid, chain in want.chains.items():
            other = got.chains[cid]
            for field in ("aatype", "atom_positions", "atom_mask", "residue_index", "b_factors"):
                np.testing.assert_array_equal(getattr(other, field), getattr(chain, field))
            assert other.insertion_codes == chain.insertion_codes


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_build_failure_warns_once_and_parses_in_python(tmp_path, monkeypatch):
    broken = tmp_path / "cif_tokenizer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CIF_TOKENIZER_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    handler = _Messages()
    get_logger().addHandler(handler)
    native._load_cif_tokenizer.cache_clear()
    try:
        text = FIXTURES[0].read_text()
        assert t_mmcif.parse_cif_categories(text) == t_mmcif.parse_cif_categories_py(text)
        assert t_mmcif.parse_cif_categories(GRAMMAR_CORPUS[2]) == j_parse_py(GRAMMAR_CORPUS[2])
        assert native.load_cif_tokenizer() is None
    finally:
        get_logger().removeHandler(handler)
        native._load_cif_tokenizer.cache_clear()  # later tests load the real source again
    assert len(handler.messages) == 1
    assert handler.messages[0].startswith("native CIF tokenizer unavailable, parsing CIF text "
                                          "in Python:")
    assert "cif_tokenizer.cpp" in handler.messages[0]
