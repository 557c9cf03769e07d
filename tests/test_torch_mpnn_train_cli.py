"""The port's ProteinMPNN training CLI
(framedipt_tpu_torch/experiments/train_mpnn.py) against the JAX package's
(framedipt_tpu/experiments/train_mpnn.py) on the CPU, over the fixture
mmCIF complexes preprocessed once a module by the port's pipeline (the JAX
CLI test's filtering: max_len 2000, min_len 10, chain_max_len 2000; five
chains, 801-820 residues each):

- ``structure_to_mpnn_features`` equal to JAX's on the multichain pickles
  (and on a copy with missing backbones), vanilla and CA-only;
- ``MPNNDataset``'s split, crops and batch stream equal to JAX's for one
  seed, partial batches included;
- the CLI (10 steps, hidden 32, one layer, 8 neighbours) writes the same
  ``metrics.jsonl`` keys and steps and the same checkpoint names as JAX's
  CLI;
- each package's loader reads the other's ``.npz`` (a CA-only one from JAX
  included) and computes the same log-probabilities;
- the warm start loads a checkpoint whose config equals the flags' and
  refuses one whose config differs.
"""
import json
import pathlib
import pickle

import jax
import numpy as np
import pytest
import torch

from framedipt_tpu.experiments import train_mpnn as JC
from framedipt_tpu.model import mpnn as J
from framedipt_tpu.tools import mpnn_design as JD

from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
from framedipt_tpu_torch.experiments import train_mpnn as TC
from framedipt_tpu_torch.model import mpnn as T
from framedipt_tpu_torch.tools import mpnn_design as TD
from framedipt_tpu_torch.tools.config import FilteringConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

CIF_DIR = pathlib.Path(__file__).parent / "data" / "cifs"
SMALL_FLAGS = ["--hidden_dim", "32", "--num_layers", "1", "--k_neighbors", "8"]
# Compiled whole: eager JAX compiles a program for every op it meets.
j_log_probs = jax.jit(J.mpnn_log_probs, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    out = tmp_path_factory.mktemp("processed_mpnn")
    rows = process_serially(sorted(CIF_DIR.glob("*.cif")), ProcessOptions(
        output_dir=out, filtering=FilteringConfig(max_len=2000, min_len=10, chain_max_len=2000)))
    assert len(rows) == 3 and all(r["num_chains"] == 5 for r in rows)
    write_metadata(rows, out / "metadata.csv")
    return out


@pytest.fixture(scope="module")
def cli_runs(preprocessed, tmp_path_factory):
    """One 10-step run of each CLI on the same flags."""
    root = tmp_path_factory.mktemp("mpnn_cli")
    flags = ["--csv_path", str(preprocessed / "metadata.csv"), "--num_steps", "10",
             "--batch_size", "2", "--max_length", "96", *SMALL_FLAGS, "--log_freq", "2",
             "--eval_freq", "5", "--ckpt_freq", "5"]
    JC.main([*flags, "--output_dir", str(root / "jax")])
    last = TC.main([*flags, "--output_dir", str(root / "port"), "--device", "cpu"])
    return root, last


def _pickles(preprocessed) -> list[dict]:
    out = []
    for path in sorted(preprocessed.glob("*/*.pkl")):
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("ca_only", [False, True])
def test_structure_to_mpnn_features_equal_jax(preprocessed, ca_only):
    raws = _pickles(preprocessed)
    gappy = {k: v.copy() for k, v in raws[0].items()}
    gappy["bb_mask"][[0, 5, 400]] = 0.0  # missing backbones: NaN, then masked
    for raw in [*raws, gappy]:
        got = TC.structure_to_mpnn_features(raw, ca_only)
        want = JC.structure_to_mpnn_features(raw, ca_only)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    enc = got["chain_encoding_all"][0]
    assert enc.min() == 1 and enc.max() == 5 and got["mask"][0, [0, 5, 400]].sum() == 0


def test_dataset_split_crops_and_batches_equal_jax(preprocessed):
    csv_path = preprocessed / "metadata.csv"
    args = (csv_path, 300, 10, False, 0.34, 3)
    got, want = TC.MPNNDataset(*args), JC.MPNNDataset(*args)
    assert (got.train_idx, got.valid_idx) == (want.train_idx, want.valid_idx)
    assert len(got.valid_idx) == 1 and len(got.train_idx) == 2

    def stream(ds):
        out = []
        for batch_size in (3, 1, 2):  # a partial batch padded with empty rows, then full ones
            out += list(ds.batches(ds.train_idx, batch_size))
        out += list(ds.batches(ds.valid_idx, 2, shuffle=False))
        return out

    got_batches, want_batches = stream(got), stream(want)
    assert len(got_batches) == len(want_batches) == 5
    for g, w in zip(got_batches, want_batches):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got_batches[0]["X"].shape == (3, 512, 4, 3)
    assert got_batches[0]["mask"][2].sum() == 0 and got_batches[0]["mask"][:2].sum() == 600


def test_cli_writes_what_the_jax_cli_writes(cli_runs):
    root, last = cli_runs

    def rows(run):
        return [json.loads(x) for x in (root / run / "metrics.jsonl").read_text().splitlines()]

    got, want = rows("port"), rows("jax")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4, 5, 6, 8, 10, 10]
    assert sorted(p.name for p in (root / "port").glob("*.npz")) == \
        sorted(p.name for p in (root / "jax").glob("*.npz")) == \
        ["last.npz", "step_10.npz", "step_5.npz"]
    train_rows = [r for r in got if "loss" in r]
    assert all(np.isfinite(r[k]) for r in train_rows for k in ("loss", "nll", "grad_norm"))
    np.testing.assert_allclose([r["lr"] for r in train_rows],
                               [r["lr"] for r in want if "loss" in r], rtol=1e-6)
    assert all(0.0 <= r["eval_accuracy"] <= 1.0 for r in got if "eval_nll" in r)
    assert last == {k: v for k, v in train_rows[-1].items() if k not in ("step", "sec")}


def _log_probs_both(port_model, params, cfg) -> tuple[np.ndarray, np.ndarray]:
    f = T.featurize_chains([("ACDEFGHIKLMNPQRSTVWY",
                             np.random.default_rng(0).normal(size=(20, 4, 3)) * 4.0)])
    if cfg.ca_only:
        f["X"] = f["X"][:, :, 1]
    randn = np.random.default_rng(1).normal(size=f["S"].shape).astype(np.float32)
    args = [f[k] for k in ("X", "S", "mask", "chain_M", "residue_idx", "chain_encoding_all")]
    want = np.asarray(j_log_probs(params, *args, cfg=cfg, randn=randn))
    with torch.no_grad():
        got = T.mpnn_log_probs(port_model, *map(torch.as_tensor, args),
                               randn=torch.as_tensor(randn)).numpy()
    return got, want


def test_each_loader_reads_the_others_npz(cli_runs, tmp_path):
    root, _ = cli_runs
    for run in ("port", "jax"):
        params, jcfg = JD.load_mpnn_params(root / run / "last.npz")
        model = TD.load_mpnn_params(root / run / "last.npz", device="cpu")
        assert (jcfg.hidden_dim, jcfg.num_encoder_layers, jcfg.k_neighbors, jcfg.ca_only) == \
            (model.cfg.hidden_dim, model.cfg.num_encoder_layers, model.cfg.k_neighbors,
             model.cfg.ca_only) == (32, 1, 8, False)
        got, want = _log_probs_both(model, params, jcfg)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=run)
    # A CA-only checkpoint of the JAX CLI holds no vestigial tensors.
    jcfg = J.MPNNConfig(hidden_dim=32, num_encoder_layers=1, num_decoder_layers=1,
                        k_neighbors=8, ca_only=True)
    params = J.init_mpnn_params(jax.random.PRNGKey(2), jcfg)
    JC.save_npz_checkpoint(tmp_path / "ca.npz", params, jcfg)
    model = TD.load_mpnn_params(tmp_path / "ca.npz", device="cpu")
    assert model.cfg.ca_only and model.cfg.k_neighbors == 8
    got, want = _log_probs_both(model, params, jcfg)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_warm_start_loads_an_equal_config_and_refuses_another(cli_runs, preprocessed, tmp_path):
    root, _ = cli_runs
    ckpt = root / "port" / "step_5.npz"
    base = ["--csv_path", str(preprocessed / "metadata.csv"), "--previous_checkpoint", str(ckpt),
            "--device", "cpu", "--max_length", "96"]
    TC.main([*base, *SMALL_FLAGS, "--num_steps", "0", "--output_dir", str(tmp_path / "ok")])
    got, want = np.load(tmp_path / "ok" / "last.npz"), np.load(ckpt)
    assert set(got.files) == set(want.files)
    assert all(np.array_equal(got[k], want[k]) for k in want.files)
    for flag, value in (("--k_neighbors", "16"), ("--hidden_dim", "64"), ("--num_layers", "2")):
        flags = dict(zip(SMALL_FLAGS[::2], SMALL_FLAGS[1::2]), **{flag: value})
        with pytest.raises(ValueError, match=flag.removeprefix("--").split("_")[0]):
            TC.main([*base, *[x for kv in flags.items() for x in kv], "--num_steps", "1",
                     "--output_dir", str(tmp_path / "bad")])
    with pytest.raises(ValueError, match="ca_only"):
        TC.main([*base, *SMALL_FLAGS, "--ca_only", "--num_steps", "1",
                 "--output_dir", str(tmp_path / "bad")])
