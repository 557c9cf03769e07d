"""The port's de novo and cg2all evaluation CLIs against the JAX package's,
on the same trees:

- ``denovo_eval.run`` on a tree of helices and one shorter strand, written
  by the port's writer with hand-written ``sc_results.csv`` files (one with
  missing cells): every CSV equal as text, the results dict equal;
- the same on a tree whose ``sc_results.csv`` the port's self-consistency
  check writes (ProteinMPNN on synthesised weights, ESMFold mocked to
  return a perturbed copy of the sample);
- MaxCluster's flow through a mock binary, foldseek's TSV through a mocked
  runner, foldseek absent, and the MaxCluster parsers on the JAX test's
  texts;
- ``cg2all_eval.csv`` equal as text with a converter that copies its input,
  and ``--skip_convert``;
- the four plots written as PNG; an empty tree raising in both packages.
"""
import os
import pathlib
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from framedipt_tpu.eval import cg2all_eval as j_cg2all
from framedipt_tpu.eval import denovo_eval as j_denovo

from framedipt_tpu_torch.analysis.utils import write_prot_to_pdb
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.eval import cg2all_eval as t_cg2all
from framedipt_tpu_torch.eval import denovo_eval as t_denovo
from framedipt_tpu_torch.eval import plots as t_plots
from framedipt_tpu_torch.experiments.utils import save_diffusion_info
from framedipt_tpu_torch.tools import external as t_external

from tests.unit.geom_helpers import nerf_backbone
from tests.unit.test_denovo_maxcluster import ALIGN_TEXT, CLUSTER_TEXT

DENOVO_CSVS = ("ss_composition.csv", "cluster_assignments.csv", "designability.csv",
               "novelty.csv", "denovo_summary.csv")


def _write_backbone(path: pathlib.Path, n: int, phi: float = -57.0,
                    psi: float = -47.0) -> np.ndarray:
    """A NeRF backbone of ``n`` residues written as ``{path}_1.pdb`` by the
    port's writer; returns its atom37 positions."""
    atom37, mask = nerf_backbone(n, phi=phi, psi=psi)
    atom37 = atom37 * mask[..., None]
    write_prot_to_pdb(atom37, path, aatype=np.zeros(n, np.int64),
                      residue_index=np.arange(1, n + 1), chain_index=np.zeros(n, np.int64))
    return atom37


def _helix_tree(root: pathlib.Path) -> pathlib.Path:
    """Two near-identical 30-residue helices (one cluster, TM near 1) and a
    24-residue strand (unequal length: TM 0), each in ``sample_<s>/``; the
    helices with ``self_consistency/sc_results.csv``, the second with
    missing cells."""
    run = root / "run"
    for s, (n, phi, psi) in enumerate(((30, -57.0, -47.0), (30, -57.5, -47.0),
                                       (24, -120.0, 130.0))):
        sdir = run / f"length_{n}" / f"sample_{s}"
        sdir.mkdir(parents=True)
        _write_backbone(sdir / f"sample_{s}", n, phi, psi)
    sc_texts = ("rmsd,tm_score\n0.5,0.9\n3.0,0.4\n",
                "rmsd,tm_score\n1.5,0.8\n,0.4\n3.25,\n2.0,0.6\n")
    for s, text in enumerate(sc_texts):
        sc = run / "length_30" / f"sample_{s}" / "self_consistency"
        sc.mkdir()
        (sc / "sc_results.csv").write_text(text)
    return run


def _run_both(tree: pathlib.Path, out: pathlib.Path, **kwargs) -> tuple[dict, dict]:
    """(JAX results, port results), each package writing into its own
    directory under ``out``."""
    want = j_denovo.run(tree, out / "jax", **kwargs)
    got = t_denovo.run(tree, out / "port", **kwargs)
    return want, got


def _assert_same_csvs(out: pathlib.Path, names) -> list[str]:
    found = []
    for name in names:
        want, got = out / "jax" / name, out / "port" / name
        assert want.exists() == got.exists(), name
        if want.exists():
            assert got.read_text() == want.read_text(), name
            found.append(name)
    return found


def _assert_same_results(want: dict, got: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]) or isinstance(want[k], float), k
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_helix_tree_matches_jax(tmp_path):
    tree = _helix_tree(tmp_path)
    want, got = _run_both(tree, tmp_path / "eval", diversity_backend="scipy")
    _assert_same_results(want, got)
    assert got["num_samples"] == 3 and got["num_clusters"] == 2
    assert got["designable_fraction"] == 1.0
    found = _assert_same_csvs(tmp_path / "eval", DENOVO_CSVS)
    assert found == ["ss_composition.csv", "designability.csv", "denovo_summary.csv"]
    # The median of sample_1 skips its missing cells: rmsd (1.5, 2.0, 3.25).
    desig = (tmp_path / "eval" / "port" / "designability.csv").read_text().splitlines()
    assert desig[2].split(",")[1:] == ["1.5", "2.0", "0.8", "0.6", "True"]
    assert (tmp_path / "eval" / "port" / "helix_sheet.png").exists()


def test_cli_main_writes_the_same_summary(tmp_path):
    tree = _helix_tree(tmp_path)
    j_denovo.run(tree, tmp_path / "jax", diversity_backend="scipy")
    t_denovo.main([f"--prediction_dir={tree}", f"--output_dir={tmp_path / 'port'}",
                   "--diversity=scipy"])
    assert _assert_same_csvs(tmp_path, DENOVO_CSVS) == [
        "ss_composition.csv", "designability.csv", "denovo_summary.csv"]


def test_self_consistency_tree_matches_jax(tmp_path, monkeypatch):
    """The port's self-consistency check writes ``sc_results.csv`` for a
    12-residue helix: ProteinMPNN (synthesised weights, in process) designs
    two sequences, ESMFold (mocked) returns the sample with its CA moved."""
    from framedipt_tpu_torch.data.protein import Protein, to_pdb
    from framedipt_tpu_torch.experiments.inference import Inference
    from tests.test_torch_denovo import _configs, _mpnn_weights

    n = 12
    run = tmp_path / "run"
    sdir = run / f"length_{n}" / "sample_0"
    sdir.mkdir(parents=True)
    atom37 = _write_backbone(sdir / "sample_0", n)
    moved = atom37.copy()
    moved[:, rc.CA_IDX] += np.random.default_rng(0).normal(scale=0.3, size=(n, 3))
    refolded = to_pdb(Protein(atom_positions=moved, atom_mask=(moved != 0).any(-1).astype(float),
                              aatype=np.zeros(n, np.int64), residue_index=np.arange(1, n + 1),
                              chain_index=np.zeros(n, np.int64), b_factors=np.zeros((n, 37))))
    monkeypatch.setattr(t_external, "esmfold_predict", lambda seq: refolded)
    _mpnn_weights(tmp_path / "mpnn.npz")
    _, tc = _configs(tmp_path / "out", "sc")
    tc.inference.mpnn_weights_path = str(tmp_path / "mpnn.npz")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        Inference(tc, device="cpu").run_self_consistency(sdir, sdir / "sample_0_1.pdb")
    finally:
        torch.set_num_threads(threads)
    sc_rows = (sdir / "self_consistency" / "sc_results.csv").read_text().splitlines()
    # The header, the native sequence's row and one row a designed sequence.
    assert len(sc_rows) == 1 + 1 + 2 and sc_rows[0] == "sequence,sample,rmsd,tm_score"

    want, got = _run_both(run, tmp_path / "eval", diversity_backend="scipy")
    _assert_same_results(want, got)
    assert got["num_samples"] == 1 and 0.0 < got["best_sc_rmsd_mean"] < 2.0
    assert _assert_same_csvs(tmp_path / "eval", DENOVO_CSVS) == [
        "ss_composition.csv", "designability.csv", "denovo_summary.csv"]


def _mock_maxcluster(bin_dir: pathlib.Path) -> None:
    bin_dir.mkdir()
    exe = bin_dir / "maxcluster"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv\n"
        "if '-l' in a:\n"
        f"    open(a[a.index('-Rl') + 1], 'w').write({ALIGN_TEXT!r})\n"
        "else:\n"
        "    open(a[a.index('-M') + 1])\n"
        f"    sys.stdout.write({CLUSTER_TEXT!r})\n"
    )
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)


def test_maxcluster_flow_matches_jax(tmp_path, monkeypatch):
    _mock_maxcluster(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    tree = _helix_tree(tmp_path)
    for backend in ("auto", "maxcluster"):
        out = tmp_path / backend
        want, got = _run_both(tree, out, diversity_backend=backend)
        _assert_same_results(want, got)
        assert got["num_clusters"] == 2 and got["diversity"] == pytest.approx(0.4)
        assert "cluster_assignments.csv" in _assert_same_csvs(out, DENOVO_CSVS)
        assert (out / "port" / "maxcluster" / "maxcluster_clusters.txt").read_text() == CLUSTER_TEXT
    paths = [pathlib.Path(f"s/sample_{i}/sample_{i}_1.pdb") for i in range(5)]
    got = t_denovo.maxcluster_diversity(paths, tmp_path / "mc")
    assert got == j_denovo.maxcluster_diversity(paths, tmp_path / "mc_jax")
    assert got["cluster_sizes"] == {1: 3, 2: 2} and got["size"] == 5


def test_maxcluster_absent_falls_back_or_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    tree = _helix_tree(tmp_path)
    want, got = _run_both(tree, tmp_path / "auto", diversity_backend="auto")
    _assert_same_results(want, got)
    with pytest.raises(t_external.ToolUnavailable):
        t_denovo.run(tree, tmp_path / "mc", diversity_backend="maxcluster")


def test_maxcluster_parsers_match_jax():
    for text in (ALIGN_TEXT, CLUSTER_TEXT):
        for fn in ("parse_maxcluster_size", "parse_maxcluster_clusters"):
            try:
                want = getattr(j_denovo, fn)(text)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(t_denovo, fn)(text)
                continue
            assert getattr(t_denovo, fn)(text) == want
    assert t_denovo.parse_maxcluster_size(ALIGN_TEXT) == 5
    assert t_denovo.parse_maxcluster_clusters(CLUSTER_TEXT)["assignments"][
        "s/sample_2/sample_2_1.pdb"] == 2
    for bad, fn in (("no size line here", "parse_maxcluster_size"),
                    ("INFO : nothing useful", "parse_maxcluster_clusters")):
        with pytest.raises(ValueError):
            getattr(t_denovo, fn)(bad)


FOLDSEEK_TSV = ("sample_2_1.pdb\t1abc_A\t0.4213\n"
                "sample_0_1.pdb\t2xyz_B\t0.8012\n"
                "sample_0_1.pdb\t3def_C\t0.9120\n"
                "sample_1_1.pdb\t4ghi_D\tnan\n"
                "sample_1_1.pdb\t5jkl_E\t0.615\n")


def test_novelty_matches_jax(tmp_path, monkeypatch):
    """foldseek's TSV (queries out of order, a NaN score) through a mocked
    runner: the best score a query, queries sorted, in both packages."""
    def runner(sample_dir, db, tsv, tmp_dir):
        tsv.write_text(FOLDSEEK_TSV)
        return tsv

    monkeypatch.setattr(j_denovo, "run_foldseek_easy_search", runner)
    monkeypatch.setattr(t_denovo, "run_foldseek_easy_search", runner)
    tree = _helix_tree(tmp_path)
    want, got = _run_both(tree, tmp_path / "eval", foldseek_db=tmp_path / "db",
                          diversity_backend="scipy")
    _assert_same_results(want, got)
    assert "novelty.csv" in _assert_same_csvs(tmp_path / "eval", DENOVO_CSVS)
    assert (tmp_path / "eval" / "port" / "novelty.csv").read_text() == (
        "query,pdbTM\nsample_0_1.pdb,0.912\nsample_1_1.pdb,0.615\nsample_2_1.pdb,0.4213\n")


def test_foldseek_absent_skips_novelty(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    tree = _helix_tree(tmp_path)
    want, got = _run_both(tree, tmp_path / "eval", foldseek_db=tmp_path / "db",
                          diversity_backend="scipy")
    _assert_same_results(want, got)
    assert "pdbTM_mean" not in got
    assert not (tmp_path / "eval" / "port" / "novelty.csv").exists()


def test_empty_tree_raises_in_both(tmp_path):
    (tmp_path / "run").mkdir()
    with pytest.raises(KeyError):
        j_denovo.run(tmp_path / "run", tmp_path / "jax", diversity_backend="scipy")
    with pytest.raises(ValueError, match=str(tmp_path / "run")):
        t_denovo.run(tmp_path / "run", tmp_path / "port", diversity_backend="scipy")


def _inference_tree(root: pathlib.Path, n: int = 30) -> pathlib.Path:
    """One case ``test_length_20`` (two chains of 15, a diffused region of 10
    in each) with two samples, the diffused CA moved by 1 A (sample 0) and
    0.5 A (sample 1) in x."""
    chains = np.repeat([0, 1], n // 2)
    diffused = np.zeros(n)
    diffused[3:13] = diffused[17:27] = 1
    case = root / f"test_length_{int(diffused.sum())}"
    case.mkdir(parents=True)
    b = np.tile((diffused * 100.0)[:, None], (1, 37))
    atom37, mask = nerf_backbone(n)
    atom37 = atom37 * mask[..., None]
    kw = dict(aatype=np.zeros(n, np.int64), b_factors=b, residue_index=np.arange(1, n + 1),
              chain_index=chains)
    write_prot_to_pdb(atom37, case / "test", **kw)
    save_diffusion_info(case, "test", "A" * n, diffused, chains)
    for s, dx in enumerate((1.0, 0.5)):
        sdir = case / f"sample_{s}"
        sdir.mkdir()
        pos = atom37.copy()
        pos[diffused > 0, :, 0] += dx
        write_prot_to_pdb(pos * mask[..., None], sdir / f"sample_{s}", **kw)
    return root


def test_cg2all_csv_matches_jax(tmp_path, monkeypatch):
    """A mock ``convert_cg2all`` copies its input: each package converts its
    own copy of the tree, then the CSVs are equal as text."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    mock = bin_dir / "convert_cg2all"
    mock.write_text(
        f"#!{sys.executable}\n"
        "import sys, shutil\n"
        "kv = dict(zip(sys.argv[1::2], sys.argv[2::2]))\n"
        "assert kv['--cg'] == 'ca', sys.argv\n"
        "shutil.copy(kv['-p'], kv['-o'])\n"
    )
    mock.chmod(mock.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    tree = _inference_tree(tmp_path / "jax")
    shutil.copytree(tree, tmp_path / "port")
    want = j_cg2all.run(tmp_path / "jax")
    got = t_cg2all.run(tmp_path / "port")
    assert len(got) == len(want) == 2
    text = (tmp_path / "port" / "evaluation" / "cg2all_eval.csv").read_text()
    assert text == (tmp_path / "jax" / "evaluation" / "cg2all_eval.csv").read_text()
    assert [r["full_atom_rmsd"] for r in got] == pytest.approx([1.0, 0.5], abs=1e-3)
    assert len(list((tmp_path / "port").glob("*_length_*/sample_*/sample_*_1_all_atom.pdb"))) == 2
    # Converted already: --skip_convert scores the same rows, cg2all not run.
    mock.write_text(f"#!{sys.executable}\nraise SystemExit(3)\n")
    t_cg2all.main([f"--prediction_dir={tmp_path / 'port'}",
                   f"--output_dir={tmp_path / 'again'}", "--skip_convert"])
    assert (tmp_path / "again" / "cg2all_eval.csv").read_text() == text


def test_cg2all_skip_convert_and_absent_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    tree = _inference_tree(tmp_path / "tree")
    for skip in (True, False):
        assert t_cg2all.run(tree, tmp_path / f"port{skip}", skip_convert=skip) == []
        assert len(j_cg2all.run(tree, tmp_path / f"jax{skip}", skip_convert=skip)) == 0
        assert not (tmp_path / f"port{skip}" / "cg2all_eval.csv").exists()
        assert not (tmp_path / f"jax{skip}" / "cg2all_eval.csv").exists()


def test_four_plots_written(tmp_path):
    rng = np.random.default_rng(3)
    rows = [{"pdb_name": f"p{i % 3}", "bb_rmsd": float(rng.uniform(0, 3)),
             "bb_rmsd_alpha": float(rng.uniform(0, 3)), "bb_rmsd_beta": float(rng.uniform(0, 3))}
            for i in range(9)]
    esm = [{"pdb_name": f"p{i}", "bb_rmsd_alpha": 1.0 + i, "bb_rmsd_beta": 2.0} for i in range(2)]
    out = [
        t_plots.box_swarm_plot(rows, "pdb_name", "bb_rmsd", tmp_path / "box.png", title="t"),
        t_plots.per_position_line_plot({"alpha": rng.uniform(0, 2, 9), "beta": rng.uniform(0, 2, 9)},
                                       tmp_path / "line.png"),
        t_plots.two_models_scatter_plot(rows, esm, tmp_path, choice="median"),
        t_plots.length_colored_scatter(rng.uniform(0, 50, 6), rng.uniform(0, 80, 6),
                                       np.array([60, 80, 100, 100, 120, 128]), "x", "y",
                                       tmp_path / "len.png"),
    ]
    for path in out:
        assert path is not None and path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", path
    assert t_plots.two_models_scatter_plot(rows, esm, tmp_path, choice="best").exists()
    with pytest.raises(ValueError):
        t_plots.two_models_scatter_plot(rows, esm, tmp_path, choice="worst")
    # The best sample a pdb: the lowest bb_rmsd, pdb names sorted.
    best = t_plots.best_sample_rows(rows)
    assert [r["pdb_name"] for r in best] == ["p0", "p1", "p2"]
    assert all(r["bb_rmsd"] == min(o["bb_rmsd"] for o in rows if o["pdb_name"] == r["pdb_name"])
               for r in best)
