"""The port's TCR evaluation (``framedipt_tpu_torch/eval/``) against the JAX
package's on the same trees, built without a model: the 1fyt complex of
``tests/data/cifs`` (810 residues, the TCR database's chains), CDR3 of both
TCR chains diffused (the port's TCR masks), the ground truth and
``diffusion_info.csv`` written by the port's writers, and three samples whose
loop backbones are moved by seeded noise. Every CSV of ``tcr_eval.run``,
with and without the SASA metrics, has the same header and every cell equal
as text, or both cells floats within 1e-12 relative (counted). Also:
``average_metrics_for_middle_residues``, ``median_sample_rows`` and the RSA
Pearson r against JAX's on the same rows; a tree with a second complex whose
loops have another length, a missing sample directory, a tenth sample and
directories to skip; the ``--legacy`` layout; a multi-loop
``diffusion_info.csv`` read with ``cdr_loop_index=1``; ``residue_reindex``
over a tree; the CLI; the plots, and their warning without matplotlib."""
import csv
import logging
import math
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from framedipt_tpu.eval import metrics as j_metrics
from framedipt_tpu.eval import plots as j_plots
from framedipt_tpu.eval import residue_reindex as j_reindex
from framedipt_tpu.eval import selection as j_selection
from framedipt_tpu.eval import tcr_eval as j_tcr_eval

from framedipt_tpu_torch.analysis.utils import write_prot_to_pdb
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data import tcr as tcr_lib
from framedipt_tpu_torch.data.features import structure_to_features
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.eval import metrics as t_metrics
from framedipt_tpu_torch.eval import plots as t_plots
from framedipt_tpu_torch.eval import residue_reindex as t_reindex
from framedipt_tpu_torch.eval import selection as t_selection
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.eval import tcr_eval as t_tcr_eval
from framedipt_tpu_torch.experiments.utils import save_diffusion_info
from framedipt_tpu_torch.tools.log import get_logger

REPO = pathlib.Path(__file__).resolve().parent.parent
CIF_DIR = REPO / "tests" / "data" / "cifs"
TCR_CSV = REPO / "database" / "TCR_pMHC_II.csv"
STRATEGIES = t_selection.SAMPLE_SELECTION_STRATEGIES
REL_TOL = 1e-12


def _complex(pdb: str, tcr_only: bool = False):
    """(atom37 backbone positions, mask, aatype, residue_index, chain_index)
    of ``pdb``'s complex with the TCR database's chains, TCR alpha and beta
    first; the TCR chains alone with ``tcr_only``."""
    with open(TCR_CSV, newline="") as f:
        row = next(r for r in csv.DictReader(f) if r["pdb_id"] == pdb)
    chains = [row[c] for c in ("tcr_alpha_chain", "tcr_beta_chain", "peptide_chain",
                               "mhc_alpha_chain", "mhc_beta_chain")]
    raw = structure_to_features(parse_mmcif(CIF_DIR / f"{pdb}-assembly1.cif"),
                                chain_ids=chains[:2] if tcr_only else chains)
    mask = raw["atom_mask"] * (np.arange(37) < 5)  # N, CA, C, CB, O as the CLI writes
    return (raw["atom_positions"] * mask[..., None], mask, raw["aatype"].astype(np.int64),
            raw["residue_index"], raw["chain_index"])


def _write_case(root: pathlib.Path, pdb: str, cdr_loops, samples, seed: int,
                tcr_only: bool = False, legacy: bool = False) -> pathlib.Path:
    """One ``{pdb}_length_{L}`` case: the ground truth with its diffused
    residues marked, diffusion_info.csv, and ``samples`` (sample indices)
    with the diffused backbone moved by N(0, 1.5 A) noise."""
    pos, mask, aatype, resi, chain = _complex(pdb, tcr_only)
    diffused = tcr_lib.create_diffusion_mask(chain, aatype, ["A", "B"], cdr_loops)
    d = root / f"{pdb}_length_{int(diffused.sum())}"
    base = d / "sample_0" if legacy else d
    base.mkdir(parents=True)
    b_factors = np.tile((diffused * 100.0)[:, None], (1, 37))
    kw = dict(aatype=aatype, b_factors=b_factors, residue_index=resi, chain_index=chain)
    write_prot_to_pdb(pos, base / pdb, **kw)
    save_diffusion_info(base, pdb, rc.aatype_to_sequence(aatype), diffused, chain)
    rng = np.random.default_rng(seed)
    moved = diffused.astype(bool)[:, None] & (mask > 0)
    for s in samples:
        noisy = pos + rng.normal(size=pos.shape) * 1.5 * moved[..., None]
        (d / f"sample_{s}").mkdir(exist_ok=True)
        write_prot_to_pdb(noisy, d / f"sample_{s}" / f"sample_{s}", **kw)
    return d


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """main: 1fyt, CDR3, samples 0-2. mixed: main's case, 7t2d's TCR chains
    with CDR1 (another loop length) and samples 0, 2 and 10, a case without
    diffusion_info.csv, one without its ground truth, an empty sample
    directory. legacy: the mixed tree's two cases in the older layout.
    multi: 1fyt with CDR1, CDR2 and CDR3 diffused."""
    root = tmp_path_factory.mktemp("tcr_eval")
    out = {name: root / name for name in ("main", "mixed", "legacy", "multi")}
    main_case = _write_case(out["main"], "1fyt", ["CDR3"], (0, 1, 2), seed=0)
    shutil.copytree(main_case, out["mixed"] / main_case.name)
    second = _write_case(out["mixed"], "7t2d", ["CDR1"], (0, 2, 10), seed=1, tcr_only=True)
    (second / "sample_7").mkdir()  # a sample directory without its structure
    (out["mixed"] / "junk_length_3").mkdir()  # no diffusion_info.csv
    no_gt = out["mixed"] / "1abc_length_25"
    no_gt.mkdir()
    shutil.copy(main_case / "diffusion_info.csv", no_gt)  # names 1fyt: no 1fyt_1.pdb here
    (no_gt / "sample_0").mkdir()
    for case in (main_case, second):
        dst = out["legacy"] / case.name
        shutil.copytree(case, dst)
        pdb = case.name.split("_length_")[0]
        for f in (f"{pdb}_1.pdb", "diffusion_info.csv"):
            (dst / f).rename(dst / "sample_0" / f)
    _write_case(out["multi"], "1fyt", ["CDR1", "CDR2", "CDR3"], (0, 1), seed=2)
    return out


def _read(path: pathlib.Path) -> list[list[str]]:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _float_cells_close(a: str, b: str) -> bool:
    try:
        x, y = float(a), float(b)
    except ValueError:
        return False
    return math.isclose(x, y, rel_tol=REL_TOL, abs_tol=0.0)


def _compare_outputs(j_dir: pathlib.Path, t_dir: pathlib.Path) -> dict[str, int]:
    """Every CSV of the JAX evaluation against the port's: the same files,
    header and shape, every cell equal as text or both floats within
    REL_TOL. Returns per file the count of cells that needed the tolerance."""
    j_files = sorted(p.name for p in j_dir.glob("*.csv"))
    assert j_files == sorted(p.name for p in t_dir.glob("*.csv"))
    assert {f"eval_metrics_{s}.csv" for s in STRATEGIES} | {"eval_metrics_all.csv"} <= set(j_files)
    loose = {}
    for name in j_files:
        j_rows, t_rows = _read(j_dir / name), _read(t_dir / name)
        assert j_rows[:1] == t_rows[:1], f"{name}: header"
        assert len(j_rows) == len(t_rows), f"{name}: rows"
        count = 0
        for r, (jr, tr) in enumerate(zip(j_rows, t_rows)):
            assert len(jr) == len(tr), f"{name} row {r}"
            for c, (a, b) in enumerate(zip(jr, tr)):
                if a != b:
                    assert _float_cells_close(a, b), f"{name} row {r} {j_rows[0][c]}: {a!r} {b!r}"
                    count += 1
        loose[name] = count
    return loose


def _run_both(tree, tmp_path, **kw):
    j_out, t_out = tmp_path / "jax", tmp_path / "port"
    j_df = j_tcr_eval.run(tree, j_out, make_plots=False, **kw)
    t_rows = t_tcr_eval.run(tree, t_out, make_plots=False, **kw)
    return j_df, t_rows, _compare_outputs(j_out, t_out)


@pytest.fixture(scope="module")
def sasa_runs(trees, tmp_path_factory):
    """Both evaluations of the main tree with the SASA metrics, each RSA
    Pearson r taken where the run computes it."""
    tmp = tmp_path_factory.mktemp("sasa")
    r = {}
    real_j, real_t = j_plots.pearson_scatter, t_plots.pearson_scatter

    def keep_j(*args, **kwargs):
        out = real_j(*args, **kwargs)
        r["jax"] = out[1]
        return out

    def keep_t(*args, **kwargs):
        out = real_t(*args, **kwargs)
        r["port"] = out[1]
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(j_plots, "pearson_scatter", keep_j)
    mp.setattr(t_plots, "pearson_scatter", keep_t)
    try:
        j_df, t_rows, loose = _run_both(trees["main"], tmp, with_sasa=True)
    finally:
        mp.undo()
    return j_df, t_rows, loose, r


@pytest.mark.parametrize("with_sasa", [False, True], ids=["no_sasa", "sasa"])
def test_csvs_equal_jax(trees, tmp_path, sasa_runs, with_sasa):
    if with_sasa:
        j_df, t_rows, loose, _ = sasa_runs
        assert any(c.startswith("gt_rsa_alpha_") for c in table.columns(t_rows))
    else:
        j_df, t_rows, loose = _run_both(trees["main"], tmp_path)
    print(f"cells within {REL_TOL} but not equal as text: {loose}")
    assert len(t_rows) == len(j_df) == 3
    assert [r["sample_idx"] for r in t_rows] == [0, 1, 2]
    assert all(np.isfinite(r["backbone_rmsd"]) for r in t_rows)


def test_mixed_tree_equal_jax(trees, tmp_path):
    """Two complexes with loops of other lengths (per-residue cells missing
    for one, ints next to missing cells), sample directories 0, 2, 10 and one
    without its structure, and the case directories to skip."""
    j_df, t_rows, loose = _run_both(trees["mixed"], tmp_path)
    print(f"cells within {REL_TOL} but not equal as text: {loose}")
    assert [(r["pdb_name"], r["sample_idx"]) for r in t_rows] == [
        ("1fyt", 0), ("1fyt", 1), ("1fyt", 2), ("7t2d", 0), ("7t2d", 2), ("7t2d", 10)]
    mode = _read(tmp_path / "port" / "eval_metrics_mode.csv")
    assert "selected_sample" in mode[0] and len(mode) == 3
    mean = _read(tmp_path / "port" / "eval_metrics_mean.csv")
    assert {row[mean[0].index("selected_sample")] for row in mean[1:]} == {""}
    j_median, t_median = j_plots.median_sample_rows(j_df), t_plots.median_sample_rows(t_rows)
    assert list(j_median["path"]) == [r["path"] for r in t_median]
    for metric in ("bb_rmsd", "signed_angle_error_psi", "angle_error_omega"):
        for rows_j, rows_t in ((j_median, t_median), (j_df, t_rows)):
            got = t_metrics.average_metrics_for_middle_residues(rows_t, metric)
            want = j_metrics.average_metrics_for_middle_residues(rows_j, metric)
            for chain in ("alpha", "beta"):
                assert len(got[chain]) == len(want[chain]) == 9
                for g, w in zip(got[chain], want[chain]):
                    np.testing.assert_array_equal(g, np.asarray(w, np.float64))


def test_sasa_rows_and_rsa_pearson_equal_jax(sasa_runs):
    j_df, t_rows, _, r = sasa_runs
    assert set(r) == {"jax", "port"} and np.isfinite(r["port"])
    assert r["port"] == r["jax"]
    gt, sample = t_tcr_eval.rsa_pairs(t_rows)
    assert len(gt) == len(sample) > 0
    t_median = t_plots.median_sample_rows(t_rows)
    assert [row["path"] for row in t_median] == list(j_plots.median_sample_rows(j_df)["path"])
    for name in ("gt_asa_alpha_1", "sample_rsa_beta_-1", "rsa_abs_error_alpha_2", "rsa_mean"):
        np.testing.assert_array_equal(table.column(t_rows, name), j_df[name].to_numpy(float))


def test_legacy_layout_equal_jax(trees, tmp_path):
    j_df, t_rows, _ = _run_both(trees["legacy"], tmp_path, legacy_file_structure=True)
    assert len(t_rows) == len(j_df) == 6


def test_multi_loop_diffusion_info(trees, tmp_path):
    """Three loops a chain in diffusion_info.csv; cdr_loop_index 1 reads the
    second of each chain (CDR2), as the JAX package does."""
    info_path = next(trees["multi"].glob("*_length_*")) / "diffusion_info.csv"
    for k in (0, 1, 2):
        got = t_tcr_eval.parse_diffusion_info(info_path, cdr_loop_index=k)
        want = j_tcr_eval.parse_diffusion_info(info_path, cdr_loop_index=k)
        assert got["chains"] == want["chains"] == ["A", "B"]
        assert got["regions"] == want["regions"] and got["pdb_name"] == want["pdb_name"]
        assert got["seq"] == want["seq"]
    with open(info_path, newline="") as f:
        row = list(csv.reader(f, delimiter="\t"))[1]
    assert len(row[2].split(",")) == 6
    j_df, t_rows, _ = _run_both(trees["multi"], tmp_path, cdr_loop_index=1)
    assert len(t_rows) == 2


def test_residue_reindex_equal_jax(trees, tmp_path):
    n_j = j_reindex.reindex_prediction_dir(trees["mixed"], tmp_path / "jax")
    n_t = t_reindex.reindex_prediction_dir(trees["mixed"], tmp_path / "port")
    assert n_j == n_t == 2
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    t_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*"))
    assert j_files == t_files and len(t_files) == 2 * 5  # per case gt, info, 3 samples
    for f in t_files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    one = next(trees["mixed"].glob("7t2d_length_*")) / "7t2d_1.pdb"
    assert t_reindex.reindex(one.read_text()) == j_reindex.reindex(one.read_text())


def test_selection_equals_jax():
    x = np.random.default_rng(3).normal(size=(5, 12, 4, 3))
    got = t_selection.select_samples(x)
    want = j_selection.select_samples(x)
    for s in STRATEGIES:
        assert got[s]["index"] == want[s]["index"]
        np.testing.assert_array_equal(got[s]["coords"], want[s]["coords"])


def test_cli_writes_the_csvs(trees, tmp_path):
    out = tmp_path / "eval"
    proc = subprocess.run(
        [sys.executable, "-m", "framedipt_tpu_torch.eval.tcr_eval",
         f"--prediction_dir={trees['mixed']}", f"--output_dir={out}", "--no_plots"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "evaluated 2 structures" in proc.stderr
    assert len(_read(out / "eval_metrics_all.csv")) == 7
    assert all(len(_read(out / f"eval_metrics_{s}.csv")) == 3 for s in STRATEGIES)


def test_plots_as_jax(trees, tmp_path):
    """With matplotlib and seaborn the port draws the files the JAX package
    draws."""
    pytest.importorskip("seaborn")
    j_tcr_eval.run(trees["main"], tmp_path / "jax", make_plots=True)
    t_tcr_eval.run(trees["main"], tmp_path / "port", make_plots=True)
    j_png = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert j_png and j_png == sorted(p.name for p in (tmp_path / "port").glob("*.png"))


def test_plots_skipped_with_a_warning_without_matplotlib(trees, tmp_path, monkeypatch, caplog):
    def no_mpl():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(t_plots, "_mpl", no_mpl)
    monkeypatch.setattr(get_logger(), "propagate", True)
    with caplog.at_level(logging.WARNING, logger="framedipt_tpu_torch"):
        rows = t_tcr_eval.run(trees["main"], tmp_path, make_plots=True)
    assert len(rows) == 3 and not list(tmp_path.glob("*.png"))
    assert "matplotlib/seaborn unavailable; skipping plots" in caplog.text


def test_table_csv_as_pandas_writes(tmp_path):
    """The CSV text of ``eval.table.write_csv`` against pandas' ``to_csv``
    on the cell kinds the evaluation writes and their edge cases."""
    f32 = np.float32
    cases = [
        [],
        [{}, {}],
        [{"a": 1, "b": "x,y"}, {"b": 'q"z', "c": None}, {"a": None, "c": 2.5}],
        [{"s": 0}, {"s": None}, {"s": 3}],  # ints with a missing cell -> floats
        [{"v": f32(0.1)}, {"v": 0.2}],  # float32 widened in a float64 column
        [{"v": f32(0.1)}, {"v": f32(np.nan)}],  # float32 column
        [{"v": v} for v in (0.1, 1e16, 1e-5, 1e-4, -0.0, np.inf, -np.inf, np.nan, 1 / 3,
                            5e-324, 2.0, np.float64(7.25), np.int64(3))],
        [{"a": True}, {"a": False}],
        [{"a": ""}],
        [{"b": 1, "a": 2}, {"c": 3, "a": 4}],
    ]
    for k, rows in enumerate(cases):
        pd.DataFrame(rows).to_csv(tmp_path / f"p{k}.csv", index=False)
        table.write_csv(rows, tmp_path / f"t{k}.csv")
        assert (tmp_path / f"t{k}.csv").read_text() == (tmp_path / f"p{k}.csv").read_text(), rows
