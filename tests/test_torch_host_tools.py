"""The port's host tools against the JAX package's, on the same inputs:

- the sweep's job expansion on a table of argvs, and ``run_sweep`` with
  ``python -c`` jobs (the job number and CUDA device pinning each job
  sees, a failing job counted, a dry run that starts nothing);
- ``StepTimer``'s rate and ``trace``'s Chrome trace JSON;
- ``process_pdb_file`` and its CLI on PDBs written from the fixture
  structures: the pickles' arrays key for key and dtype for dtype,
  ``metadata.csv`` as text, the length filters;
- ``download_cifs`` against a ``file://`` directory (no network: every
  RCSB URL of both packages points at a local directory in this module);
- the inpainting CLI's database flow: ``init_database_metadata`` on the
  fixture CIFs with the pMHC-II database CSV (the same structures and
  chains, ``metadata.csv`` as text, the cache reused, ``overwrite``, an
  empty cache), and the CLI's choice of sampler.
"""
import json
import logging
import pathlib
import pickle
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from framedipt_tpu.data import download as j_download
from framedipt_tpu.data import process_pdb_files as j_ppf
from framedipt_tpu.experiments import inference as j_inference
from framedipt_tpu.experiments import samplers as j_samplers
from framedipt_tpu.tools import errors as j_errors
from framedipt_tpu.tools import sweep as j_sweep
from framedipt_tpu.tools.config import Config as JConfig

from framedipt_tpu_torch.data import download as t_download
from framedipt_tpu_torch.data import process_pdb_files as t_ppf
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.data.protein import Protein, to_pdb
from framedipt_tpu_torch.experiments import inference as t_inference
from framedipt_tpu_torch.experiments import samplers as t_samplers
from framedipt_tpu_torch.tools import errors as t_errors
from framedipt_tpu_torch.tools import profiling
from framedipt_tpu_torch.tools import sweep as t_sweep
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.log import get_logger

REPO = pathlib.Path(__file__).resolve().parent.parent
CIFS = REPO / "tests" / "data" / "cifs"
DATABASE_CSV = REPO / "database" / "TCR_pMHC_II.csv"


@pytest.fixture(autouse=True)
def offline_rcsb(tmp_path, monkeypatch):
    """Every download of both packages reads a local directory that holds
    nothing, so each listed structure not present fails as offline."""
    url = (tmp_path / "rcsb_offline").as_uri()
    monkeypatch.setattr(j_download, "RCSB_URL", url)
    monkeypatch.setattr(t_download, "RCSB_URL", url)


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# -- the sweep -----------------------------------------------------------------

SWEEP_ARGVS = [
    ["python", "-m", "x", "a=1,2", "b=3"],
    ["python", "-m", "x", "a=1,2", "b=x,y,z", "--flag", "c=[1,2]"],
    ["python", "-m", "x", "a=1", "b=2"],
    ["run", "k=v1,v2", "m.n=0.1,0.2", "p=[a,b]", "q=1,2"],
    ["run"],
    ["run", "--opt=1,2", "plain,comma"],
]


@pytest.mark.parametrize("argv", SWEEP_ARGVS, ids=lambda a: " ".join(a))
def test_expand_jobs_matches_jax(argv):
    assert t_sweep.split_sweep_args(argv) == j_sweep.split_sweep_args(argv)
    assert t_sweep.expand_jobs(argv) == j_sweep.expand_jobs(argv)


def test_run_sweep_env_failures_and_logs(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    code = ("import os, sys, pathlib; "
            "n = os.environ['FRAMEDIPT_JOB_NUM']; "
            f"pathlib.Path({str(out)!r}, 'job' + n).write_text("
            "os.environ.get('CUDA_VISIBLE_DEVICES', '-') + ' ' + sys.argv[1]); "
            "print('ran', n); sys.exit(int(sys.argv[1].split('=')[1]) == 3)")
    failures = t_sweep.run_sweep([sys.executable, "-c", code, "v=1,2,3,4"], jobs=2,
                                 devices=["0", "1", "2"], log_dir=tmp_path / "logs")
    assert failures == 1
    seen = {p.name: p.read_text() for p in out.iterdir()}
    assert seen == {"job0": "0 v=1", "job1": "1 v=2", "job2": "2 v=3", "job3": "0 v=4"}
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == [
        f"job_{i}.log" for i in range(4)]
    assert (tmp_path / "logs" / "job_3.log").read_text() == "ran 3\n"


def test_dry_run_starts_nothing(tmp_path, monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("a dry run started a job")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    assert t_sweep.run_sweep(["run", "a=1,2", "b=x,y"], dry_run=True,
                             log_dir=tmp_path / "logs") == 0
    assert capsys.readouterr().out.splitlines() == [
        "[0] run a=1 b=x", "[1] run a=1 b=y", "[2] run a=2 b=x", "[3] run a=2 b=y"]
    assert not (tmp_path / "logs").exists()


def test_sweep_cli_exit_status(tmp_path):
    ok = subprocess.run(
        [sys.executable, "-m", "framedipt_tpu_torch.tools.sweep", "--devices", "0",
         f"--log_dir={tmp_path / 'ok'}", "--", sys.executable, "-c",
         "import os, sys; sys.exit(os.environ['CUDA_VISIBLE_DEVICES'] != '0')", "x=1,2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "framedipt_tpu_torch.tools.sweep", f"--log_dir={tmp_path / 'bad'}",
         "--", sys.executable, "-c", "raise SystemExit(2)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "job 0 failed (rc=2)" in bad.stderr


# -- profiling -----------------------------------------------------------------

def test_step_timer_rate():
    timer = profiling.StepTimer(window=3)
    assert timer.step() is None
    rates = []
    for _ in range(4):
        time.sleep(0.02)
        rates.append(timer.step({"loss": torch.ones(2), "aux": [torch.zeros(1)]}))
    assert all(0 < r < 50 for r in rates)
    # The window holds the last 3 times: two intervals.
    assert len(timer._times) == 3
    assert rates[-1] == pytest.approx(2 / (timer._times[-1] - timer._times[0]))
    assert not profiling._on_cuda({"a": [torch.ones(1), (torch.zeros(1), 3)], "b": None})


def test_trace_writes_chrome_json_with_a_cpu_matmul(tmp_path):
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    with profiling.trace(tmp_path / "trace") as prof:
        (a @ b).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and prof is not None
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(n for n in names if n)[:40]


# -- monomer .pdb preprocessing --------------------------------------------------

def _fixture_pdbs(pdb_dir: pathlib.Path) -> dict[str, int]:
    """One PDB a chain of the 1fyt fixture (the port's parser and writer),
    named ``1fyt<chain>.pdb``; returns each file's residue count."""
    pdb_dir.mkdir()
    counts = {}
    for cid, ch in parse_mmcif(CIFS / "1fyt-assembly1.cif").chains.items():
        n = len(ch.aatype)
        prot = Protein(atom_positions=ch.atom_positions, aatype=ch.aatype, atom_mask=ch.atom_mask,
                       residue_index=ch.residue_index, chain_index=np.zeros(n, np.int64),
                       b_factors=ch.b_factors)
        (pdb_dir / f"1fyt{cid}.pdb").write_text(to_pdb(prot))
        counts[f"1fyt{cid}"] = n
    return counts


def _pickles(out: pathlib.Path) -> dict[str, dict]:
    found = {}
    for p in sorted(out.rglob("*.pkl")):
        with open(p, "rb") as f:
            found[str(p.relative_to(out))] = pickle.load(f)
    return found


def test_process_pdb_files_matches_jax(tmp_path, monkeypatch):
    """Both CLIs over the same directory into the same output directory (the
    paths in metadata.csv are then equal): JAX's first, then the port's."""
    counts = _fixture_pdbs(tmp_path / "pdbs")
    assert counts == {"1fytA": 180, "1fytB": 179, "1fytC": 13, "1fytD": 198, "1fytE": 240}
    out = tmp_path / "out"
    args = [f"--pdb_dir={tmp_path / 'pdbs'}", f"--output_dir={out}", "--min_len=10",
            "--max_len=190"]
    monkeypatch.setattr(sys, "argv", ["process_pdb_files", *args])
    j_ppf.main()
    want_csv = (out / "metadata.csv").read_text()
    want = _pickles(out)
    shutil.rmtree(out)
    t_ppf.main(["--device=cpu", *args])
    got = _pickles(out)
    assert (out / "metadata.csv").read_text() == want_csv
    # Chains D and E are over max_len.
    assert len(want_csv.splitlines()) == 1 + 3
    assert list(got) == list(want) and len(got) == 3
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for key, value in want[name].items():
            assert type(got[name][key]) is np.ndarray, (name, key)
            assert got[name][key].dtype == value.dtype, (name, key)
            np.testing.assert_array_equal(got[name][key], value, err_msg=f"{name} {key}")


def test_process_pdb_file_filters_match_jax(tmp_path):
    _fixture_pdbs(tmp_path / "pdbs")
    path = tmp_path / "pdbs" / "1fytC.pdb"
    for bounds in ({"max_len": 12}, {"min_len": 14}):
        with pytest.raises(j_errors.LengthError):
            j_ppf.process_pdb_file(path, tmp_path / "jax", **bounds)
        with pytest.raises(t_errors.LengthError):
            t_ppf.process_pdb_file(path, tmp_path / "port", **bounds)
    assert not (tmp_path / "port").exists()
    row = t_ppf.process_pdb_file(path, tmp_path / "port", min_len=5)
    assert row == j_ppf.process_pdb_file(path, tmp_path / "port", min_len=5)
    assert row["seq_len"] == 13 and row["processed_path"].endswith("fy/1fytC.pkl")


def test_process_pdb_files_cli_wants_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ppf.main([f"--pdb_dir={tmp_path}", f"--output_dir={tmp_path / 'out'}"])


# -- downloads -------------------------------------------------------------------

def test_download_cifs_from_a_file_url(tmp_path, monkeypatch):
    """RCSB at a ``file://`` directory holding 1fyt: a file present locally
    is kept unread, 1fyt is fetched, 9zzz is logged and skipped."""
    rcsb = tmp_path / "rcsb"
    rcsb.mkdir()
    shutil.copy(CIFS / "1fyt-assembly1.cif", rcsb)
    for mod in (j_download, t_download):
        monkeypatch.setattr(mod, "RCSB_URL", rcsb.as_uri())
    results = {}
    for label, mod in (("jax", j_download), ("port", t_download)):
        out = tmp_path / label
        out.mkdir()
        (out / "7t2d-assembly1.cif").write_text("kept")
        handler = _Messages()
        get_logger().addHandler(handler)
        try:
            got = mod.download_cifs(["1FYT", "7t2d", "9zzz"], out, max_workers=2)
        finally:
            get_logger().removeHandler(handler)
        results[label] = sorted(p.name for p in got)
        assert (out / "1fyt-assembly1.cif").read_bytes() == (CIFS / "1fyt-assembly1.cif").read_bytes()
        assert (out / "7t2d-assembly1.cif").read_text() == "kept"
        assert not (out / "9zzz-assembly1.cif").exists()
        if label == "port":
            assert len(handler.messages) == 1 and handler.messages[0].startswith("9zzz: failed")
    assert results["port"] == results["jax"] == ["1fyt-assembly1.cif", "7t2d-assembly1.cif"]
    with pytest.raises(ConnectionError, match="offline environment"):
        t_download.download_cif("1fyt", tmp_path / "plain", first_assembly=False)


# -- the inpainting CLI's database flow ---------------------------------------------

def _database_configs(download_dir: pathlib.Path, **fields):
    """(JAX, port) configs of the database flow over ``download_dir``."""
    jc, tc = JConfig(), TConfig()
    for cfg in (jc, tc):
        isc = cfg.inference.inpainting_samples
        isc.data_path = str(DATABASE_CSV)
        isc.download_dir = str(download_dir)
        isc.num_workers_download = 2
        for key, value in fields.items():
            setattr(isc, key, value)
    return jc, tc


def _database_dir(root: pathlib.Path) -> pathlib.Path:
    (root / "cifs").mkdir(parents=True)
    for p in CIFS.glob("*.cif"):
        shutil.copy(p, root / "cifs")
    return root


def _pairs(cif_paths, chains_list) -> list[tuple[str, list]]:
    return [(pathlib.Path(p).name, list(c) if c else c) for p, c in zip(cif_paths, chains_list)]


def test_init_database_metadata_matches_jax(tmp_path):
    """Both packages in one download directory, in turn (metadata.csv holds
    its paths): the same survivors and chains, the same metadata.csv. Every
    listed structure but the three fixtures fails to download (offline)."""
    root = _database_dir(tmp_path / "db")
    pdb_ids, chains = t_samplers._read_tcr_csv(DATABASE_CSV)
    assert len(pdb_ids) == 18
    jc, tc = _database_configs(root)
    want = _pairs(*j_samplers.init_database_metadata(jc, pdb_ids, chains))
    want_csv = (root / "processed" / "metadata.csv").read_text()
    shutil.rmtree(root / "processed")
    handler = _Messages()
    get_logger().addHandler(handler)
    try:
        got = _pairs(*t_samplers.init_database_metadata(tc, pdb_ids, chains))
    finally:
        get_logger().removeHandler(handler)
    assert got == want and [name for name, _ in got] == [
        "7t2d-assembly1.cif", "5ksa-assembly1.cif", "1fyt-assembly1.cif"]
    assert got[2][1] == ["D", "E", "C", "A", "B"]  # TCR, peptide, MHC
    assert (root / "processed" / "metadata.csv").read_text() == want_csv
    offline = [m for m in handler.messages if "failed to download" in m]
    assert len(offline) == 15 and "offline environment?" in offline[0]
    assert sum(m.startswith("missing structure file") for m in handler.messages) == 15


def test_database_metadata_cache_overwrite_and_empty(tmp_path):
    root = _database_dir(tmp_path / "db")
    pdb_ids, chains = t_samplers._read_tcr_csv(DATABASE_CSV)
    meta = root / "processed" / "metadata.csv"
    # A filter that keeps one complex (7t2d, its longest chain 235 residues;
    # 1fyt's 240, 5ksa's 242).
    jc, tc = _database_configs(root, chain_max_len=238)
    want = _pairs(*j_samplers.init_database_metadata(jc, pdb_ids, chains))
    text = meta.read_text()
    meta.unlink()
    got = _pairs(*t_samplers.init_database_metadata(tc, pdb_ids, chains))
    assert got == want and len(got) == 1 and meta.read_text() == text
    # The cache is reused: the filter no longer matters...
    _, tc = _database_configs(root)
    assert _pairs(*t_samplers.init_database_metadata(tc, pdb_ids, chains)) == got
    assert meta.read_text() == text
    # ...unless overwrite rebuilds it.
    jc, tc = _database_configs(root, overwrite=True)
    assert len(t_samplers.init_database_metadata(tc, pdb_ids, chains)[0]) == 3
    # An empty cache file (or a header alone) means no survivor, in both.
    jc, tc = _database_configs(root)
    for cache in ("", "pdb_name\n"):
        meta.write_text(cache)
        assert j_samplers.init_database_metadata(jc, pdb_ids, chains) == ([], [])
        assert t_samplers.init_database_metadata(tc, pdb_ids, chains) == ([], [])
    # Nothing survives the filters: a header alone, in both.
    for label, cfg, fn in (("jax", jc, j_samplers.init_database_metadata),
                           ("port", tc, t_samplers.init_database_metadata)):
        cfg.inference.inpainting_samples.overwrite = True
        cfg.inference.inpainting_samples.max_len = 10
        assert fn(cfg, pdb_ids, chains) == ([], []), label
        assert meta.read_text() == "pdb_name\n", label


def _stub(cfg, cif_dir, inpainting=True):
    """What ``Inference._create_sampler`` reads of its instance."""
    return types.SimpleNamespace(cfg=cfg, inpainting=inpainting, diffuser=None,
                                 cif_dir=pathlib.Path(cif_dir) if cif_dir else None)


CHOICES = [
    # (inpainting, cif_dir given, tcr, download_dir given)
    (False, False, True, False),
    (True, False, True, True),
    (True, False, False, True),
    (True, False, True, False),
    (True, True, True, True),
    (True, True, False, False),
]


@pytest.mark.parametrize("inpainting,with_cif_dir,tcr,with_download", CHOICES)
def test_cli_sampler_chosen_as_jax(tmp_path, inpainting, with_cif_dir, tcr, with_download):
    """``Inference._create_sampler`` of both packages on the same settings:
    the same sampler class and structures, or a ValueError in both."""
    root = _database_dir(tmp_path / "db")
    jc, tc = _database_configs(root if with_download else None)
    for cfg in (jc, tc):
        cfg.inference.inpainting_samples.tcr = tcr
        cfg.data.csv_path = str(DATABASE_CSV)
        if not with_download:
            cfg.inference.inpainting_samples.download_dir = None
    cif_dir = CIFS if with_cif_dir else None
    made = {}
    for label, mod, cfg in (("jax", j_inference, jc), ("port", t_inference, tc)):
        stub = _stub(cfg, cif_dir, inpainting)
        try:
            made[label] = mod.Inference._create_sampler(stub)
        except ValueError as e:
            made[label] = e
        if label == "jax" and (root / "processed").exists():
            shutil.rmtree(root / "processed")
    want, got = made["jax"], made["port"]
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, ValueError):
        assert "download_dir" in str(got)
        return
    if inpainting:
        assert [p.name for p in got.cif_paths] == [p.name for p in want.cif_paths]
        assert got.chains_per_structure == want.chains_per_structure
