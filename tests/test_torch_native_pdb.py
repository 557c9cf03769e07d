"""The port's native PDB writer (``framedipt_tpu_torch/native/pdb_writer.cpp``,
built with the host's g++) against the port's pure-Python writer
(``to_pdb`` / ``prots_to_pdb`` over ``analysis.utils._as_protein``) and the
JAX package's ``format_models_native``: the three texts byte-equal, over
trajectory length, residue count, chains, residue numbers wider than their
column, coordinates that round on a half or widen their field, atoms at the
origin and NaN coordinates; more than 62 chains raise; a comma-decimal
LC_NUMERIC and four threads at once change nothing; ``write_prot_to_pdb``
takes the native path, and a build failure logs a warning and gives the
Python text. A NaN b-factor with its sign bit set is held against the Python
text only: the JAX package's writer prints it as "-nan", Python as "nan"."""
import concurrent.futures
import ctypes
import locale
import logging
import shutil
import subprocess

import numpy as np
import pytest

from framedipt_tpu.data.protein import format_models_native as jax_format_models

from framedipt_tpu_torch import native
from framedipt_tpu_torch.analysis import utils as t_utils
from framedipt_tpu_torch.analysis.utils import _as_protein, prot_pos_to_pdb, write_prot_to_pdb
from framedipt_tpu_torch.data.protein import format_models_native, prots_to_pdb, to_pdb
from framedipt_tpu_torch.tools.log import get_logger


@pytest.fixture(scope="module", autouse=True)
def writer_built():
    assert native.load_pdb_writer() is not None, "g++ could not build native/pdb_writer.cpp"


def _case(seed, t, n, chains=1, scale=12.0, resi_max=9999):
    """Frames [t, n, 37, 3] with backbone and CB present, CB dropped on every
    7th residue, one residue absent in frame 1; aatype 0-20 (20 is UNK)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(t, n, 37, 3)) * scale
    mask = np.zeros((n, 37))
    mask[:, :5] = 1.0
    pos = pos * mask[None, ..., None]
    pos[:, ::7, 4] = 0.0
    if t > 1:
        pos[1, 0] = 0.0
    aatype = rng.integers(0, 21, size=n)
    residue_index = rng.integers(-999, resi_max, size=n)
    chain_index = np.sort(rng.integers(0, chains, size=n)) * 3 + 5  # sparse chain ids
    b_factors = np.where(rng.random((n, 1)) < 0.5, 100.0, 0.0) * np.ones((n, 37))
    return pos, aatype, residue_index, chain_index, b_factors


def _python_text(pos, aatype, residue_index, chain_index, b_factors):
    prots = [_as_protein(f, aatype, b_factors, residue_index, chain_index) for f in pos]
    return prots_to_pdb(prots)


def _check_three(case, jax_too=True):
    native_text = format_models_native(*case)
    assert native_text is not None
    assert native_text + "END\n" == _python_text(*case)
    if jax_too:
        assert native_text == jax_format_models(*case)
    return native_text


@pytest.mark.parametrize(
    "t,n,chains,scale,resi_max",
    [
        (1, 20, 1, 12.0, 9999),
        (1, 33, 3, 12.0, 9999),
        (5, 24, 2, 12.0, 9999),
        (2, 16, 1, 1e4, 9999),  # coordinates wider than the 8.3f column
        (3, 40, 4, 12.0, 10**12),  # residue numbers wider than their column
        (2, 70, 62, 12.0, 9999),  # the most chains a PDB file can name
        (1, 0, 1, 12.0, 9999),  # no residue
    ],
)
def test_native_matches_python_and_jax(t, n, chains, scale, resi_max):
    _check_three(_case(t * 100 + n, t, n, chains, scale, resi_max))


def test_start_model_numbering():
    case = _case(7, 3, 12, 2)
    text = format_models_native(*case, start_model=41)
    assert text == jax_format_models(*case, start_model=41)
    assert text == "".join(
        to_pdb(_as_protein(f, *[case[i] for i in (1, 4, 2, 3)]), model=41 + k, add_end=False)
        for k, f in enumerate(case[0]))


def test_negative_and_rounding_coords():
    """Halves in the binary value (0.0625 -> 0.062), values that only look
    like halves (-0.0005), negative zero, values that widen the column, inf
    and values past 1e12 (formatted by snprintf)."""
    vals = np.concatenate([
        [-0.0005, 0.0005, 123456.789, -1.2345, 1.23449999, -99999.9999, 2.6665, -2.6675,
         0.001, -0.0001, -0.0, 7.77749999999, 0.0625, -0.0625, 1e12, -3e15, 1e300,
         np.inf, -np.inf, 2.0**52 / 1000, 9.9995],
        np.arange(-400, 400) / 2000.0,  # every k/2000: the dyadic ones are exact halves
        np.arange(-400, 400) / 16.0 / 125.0,
        np.random.default_rng(0).normal(size=600) * 10.0 ** np.arange(-4, 8).repeat(50),
    ])
    vals = np.concatenate([vals, np.zeros(-len(vals) % 3)])
    n = len(vals) // 3
    pos = np.zeros((1, n, 37, 3))
    pos[0, :, 1] = vals.reshape(n, 3)
    pos[0, :, 0] = 1.0  # N present on every residue
    b_factors = np.random.default_rng(1).normal(size=(n, 37)) * 30.0
    b_factors[::5] = np.arange(37) / 800.0  # b-factors on a half of 0.01
    case = (pos, np.zeros(n, np.int64), np.arange(1, n + 1), np.zeros(n, np.int64), b_factors)
    _check_three(case)


def test_nan_coordinates_and_atoms_at_origin_absent():
    n = 4
    pos = np.zeros((2, n, 37, 3))
    pos[:, :, :3] = 1.0
    pos[0, 1, 1, 0] = np.nan  # CA of residue 2 diverged in frame 0
    pos[1, 2, :, :] = np.nan  # residue 3 gone in frame 1
    pos[1, 3, 2] = [1e-8, -1e-8, 1e-8]  # |x|+|y|+|z| = 3e-8: absent
    pos[1, 0, 2] = [0.0, 0.0, -2e-7]  # present, prints as -0.000
    case = (pos, np.zeros(n, np.int64), np.arange(1, n + 1), np.zeros(n, np.int64),
            np.zeros((n, 37)))
    text = _check_three(case)
    assert "nan" not in text
    assert text.count("ATOM") == 3 * 4 - 1 + 3 * 4 - 3 - 1


def test_nan_b_factor_prints_as_python_does():
    case = list(_case(3, 2, 9))
    case[4] = case[4].copy()
    case[4][2] = -np.nan
    case[4][3] = np.nan
    text = _check_three(tuple(case), jax_too=False)
    assert "-nan" not in text and "   nan" in text


def test_more_than_62_chains_raise():
    n = 70
    args = (np.ones((1, n, 37, 3)), np.zeros(n, np.int64), np.arange(1, n + 1),
            np.arange(n, dtype=np.int64), np.zeros((n, 37)))
    with pytest.raises(ValueError, match="62 chains"):
        format_models_native(*args)
    with pytest.raises(ValueError, match="62 chains"):
        _python_text(*args)
    with pytest.raises(ValueError, match="62 chains"):
        jax_format_models(*args)


def _comma_locale(root):
    """Compile a locale whose LC_NUMERIC writes "1,500" for 1.5 under
    ``root`` (for LOCPATH); None when localedef is missing."""
    if shutil.which("localedef") is None:
        return None
    (root / "comma.def").write_text(
        'LC_NUMERIC\ndecimal_point "<U002C>"\nthousands_sep "<U002E>"\n'
        "grouping 3;3\nEND LC_NUMERIC\n")
    charmap = ["<code_set_name> ASCII_TEST", "<comment_char> %", "<escape_char> /",
               "<mb_cur_min> 1", "<mb_cur_max> 1", "CHARMAP"]
    charmap += [f"<U{i:04X}> /x{i:02x} C{i}" for i in range(128)] + ["END CHARMAP"]
    (root / "ascii.cm").write_text("\n".join(charmap) + "\n")
    (root / "out").mkdir()
    subprocess.run(["localedef", "-c", "-i", str(root / "comma.def"), "-f",
                    str(root / "ascii.cm"), str(root / "out" / "xx_XX")],
                   capture_output=True, timeout=120)
    return root / "out"


def test_comma_decimal_locale_changes_nothing(tmp_path, monkeypatch):
    """Under an LC_NUMERIC whose decimal point is a comma (printf's %f
    writes "1,500"), the text is the same as under C."""
    locpath = _comma_locale(tmp_path)
    if locpath is None:
        pytest.skip("localedef is not installed: no comma-decimal locale can be made")
    case = _case(3, 3, 30, 2, scale=1e13)  # every coordinate through snprintf too
    case[0][:, ::2] /= 1e12
    expected = _python_text(*case)
    monkeypatch.setenv("LOCPATH", str(locpath))
    try:
        locale.setlocale(locale.LC_NUMERIC, "xx_XX")
        buf = ctypes.create_string_buffer(32)
        ctypes.CDLL(None).snprintf(buf, 32, b"%.3f", ctypes.c_double(1.5))
        assert buf.value == b"1,500"  # the locale is in force for printf
        text = format_models_native(*case)
    finally:
        locale.setlocale(locale.LC_NUMERIC, "C")
    assert "," not in text
    assert text + "END\n" == expected


def test_four_threads_at_once():
    cases = [_case(i, 3, 60, 2) for i in range(8)]
    expected = [_python_text(*c) for c in cases]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        got = list(pool.map(lambda c: format_models_native(*c) + "END\n", cases * 2))
    assert got == expected * 2


def test_write_prot_to_pdb_takes_the_native_path(tmp_path, monkeypatch):
    pos, aatype, residue_index, chain_index, b_factors = _case(0, 3, 18, 2)
    expected_traj = _python_text(pos, aatype, residue_index, chain_index, b_factors)
    expected_one = to_pdb(_as_protein(pos[0], aatype, b_factors, residue_index, chain_index))

    def refuse(*args, **kwargs):
        raise AssertionError("the Python writer was called")

    monkeypatch.setattr(t_utils, "to_pdb", refuse)
    monkeypatch.setattr(t_utils, "prots_to_pdb", refuse)
    kw = dict(aatype=aatype, b_factors=b_factors, residue_index=residue_index,
              chain_index=chain_index)
    traj = write_prot_to_pdb(pos, tmp_path / "traj", **kw)
    one = write_prot_to_pdb(pos[0], tmp_path / "sample", **kw)
    assert traj.name == "traj_1.pdb" and traj.read_text() == expected_traj
    assert one.read_text() == expected_one
    assert prot_pos_to_pdb(pos, **kw) == expected_traj


def test_build_failure_warns_and_writes_python_text(tmp_path, monkeypatch, caplog):
    broken = tmp_path / "pdb_writer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PDB_WRITER_SOURCE", broken)
    monkeypatch.setattr(get_logger(), "propagate", True)
    pos, aatype, residue_index, chain_index, b_factors = _case(5, 2, 12, 2)
    native._load_pdb_writer.cache_clear()
    try:
        with caplog.at_level(logging.WARNING, logger="framedipt_tpu_torch"):
            assert format_models_native(pos, aatype, residue_index, chain_index, b_factors) is None
            path = write_prot_to_pdb(pos, tmp_path / "traj", aatype=aatype, b_factors=b_factors,
                                     residue_index=residue_index, chain_index=chain_index)
    finally:
        native._load_pdb_writer.cache_clear()  # later tests load the real source again
    assert path.read_text() == _python_text(pos, aatype, residue_index, chain_index, b_factors)
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1, warnings  # once, not per call
    assert "pdb_writer.cpp" in warnings[0] and "error" in warnings[0]
